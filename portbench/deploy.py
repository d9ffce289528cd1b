"""The system under test: a ``sentinel_tpu_torch`` engine set up as a
configuration states, fed rounds of lanes through the batch API, and read
back in the reference's node space.

The only module of the benchmark that imports the program.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from portbench import reference as ref
from portbench.generator import Exits, Lanes
from portbench.spec import resource_names, rule_layout


class Clock:
    """The engine's clock: trace time, advanced by the harness."""

    def __init__(self, now_ms: int):
        self.now = int(now_ms)

    def __call__(self) -> int:
        return self.now


class Rows(NamedTuple):
    cluster: np.ndarray  # int32[R]
    default: np.ndarray  # int32[R]
    origin: np.ndarray   # int32[R]
    origin_id: int
    context_id: int


class Deployment:
    """One engine with a configuration's resources, rows and rules."""

    def __init__(self, cfg: Dict, device, clock: Clock, width: int):
        from sentinel_tpu_torch.core import config as pconfig
        from sentinel_tpu_torch.core import constants as C
        from sentinel_tpu_torch.core.batch import (
            make_entry_batch_np,
            make_exit_batch_np,
        )
        from sentinel_tpu_torch.core.engine import SentinelEngine
        from sentinel_tpu_torch.core.registry import ENTRY_ROW

        self.C = C
        self.cfg = cfg
        win = cfg["window"]
        pconfig.config.set(pconfig.STATISTIC_INTERVAL_MS,
                           str(win["interval_ms"]))
        pconfig.config.set(pconfig.STATISTIC_SAMPLE_COUNT,
                           str(win["buckets"]))
        for key, value in cfg.get("settings", {}).items():
            pconfig.config.set(key, str(value))
        self.engine = SentinelEngine(capacity=int(cfg["capacity"]),
                                     device=device, clock=clock)
        reg = self.engine.registry
        ctx = cfg["context"]
        inbound = cfg.get("entry_type", "OUT") == "IN"
        etype = int(C.EntryType.IN if inbound else C.EntryType.OUT)
        entrance = reg.entrance_row(ctx)
        names = resource_names(cfg)
        # A configuration without an origin has no origin nodes: its
        # reference nodes 2R..3R-1 have no row and stay empty.
        origin = cfg.get("origin")
        self.rows = Rows(
            cluster=np.array([reg.cluster_row(n, entry_type=etype)
                              for n in names], np.int32),
            default=np.array([reg.default_row(ctx, n, entrance)
                              for n in names], np.int32),
            origin=(np.array([reg.origin_row(n, origin) for n in names],
                             np.int32) if origin
                    else np.full(len(names), -1, np.int32)),
            origin_id=reg.origin_id(origin) if origin else -3,
            context_id=reg.context_id(ctx),
        )
        if min(self.rows.cluster.min(), self.rows.default.min(),
               self.rows.origin.min() if origin else 0) < 0:
            raise RuntimeError(f"capacity {cfg['capacity']} holds too few "
                               "rows for the configuration")
        self.entry_row = ENTRY_ROW
        self._load_rules(rule_layout(cfg), names)
        self.ebuf = make_entry_batch_np(width)
        self.xbuf = make_exit_batch_np(width)
        self.ebuf["context_id"][:] = self.rows.context_id
        self.ebuf["entry_in"][:] = inbound
        self.ebuf["param_present"][:, 0] = True
        self.xbuf["entry_in"][:] = inbound
        self.xbuf["param_present"][:, 0] = True

    def _load_rules(self, rules, names) -> None:
        from sentinel_tpu_torch.models import degrade as D
        from sentinel_tpu_torch.models import flow as F
        from sentinel_tpu_torch.models import param_flow as P
        from sentinel_tpu_torch.models import system as Y

        C = self.C
        behavior = {"DEFAULT": C.CONTROL_BEHAVIOR_DEFAULT}
        flow_grade = {"QPS": C.FLOW_GRADE_QPS, "THREAD": C.FLOW_GRADE_THREAD}
        param_grade = {"QPS": C.PARAM_FLOW_GRADE_QPS,
                       "THREAD": C.PARAM_FLOW_GRADE_THREAD}
        eng = self.engine
        eng.flow_rules.load_rules([
            F.FlowRule(resource=names[r["resource"]], count=r["count"],
                       grade=flow_grade[r.get("grade", "QPS")],
                       control_behavior=behavior[r.get("control_behavior",
                                                       "DEFAULT")])
            for r in rules["flow"]])
        eng.param_rules.load_rules([
            P.ParamFlowRule(names[r["resource"]], param_idx=r["param_idx"],
                            count=r["count"],
                            grade=param_grade[r.get("grade", "QPS")],
                            duration_in_sec=r.get("duration_in_sec", 1),
                            burst_count=r.get("burst_count", 0),
                            control_behavior=behavior[
                                r.get("control_behavior", "DEFAULT")])
            for r in rules["param"]])
        eng.degrade_rules.load_rules([
            D.DegradeRule(resource=names[r["resource"]], count=r["count"],
                          grade=ref.DEGRADE_GRADES[r["grade"]],
                          time_window=r["time_window"],
                          slow_ratio_threshold=r["slow_ratio_threshold"],
                          min_request_amount=r["min_request_amount"],
                          stat_interval_ms=r["stat_interval_ms"])
            for r in rules["degrade"]])
        eng.system_rules.load_rules([Y.SystemRule(**r)
                                     for r in rules["system"]])
        for fam, mgr in (("flow", eng.flow_rules),
                         ("param", eng.param_rules),
                         ("degrade", eng.degrade_rules),
                         ("system", eng.system_rules)):
            if len(mgr.get_rules()) != len(rules[fam]):
                raise RuntimeError(f"the engine took {len(mgr.get_rules())} "
                                   f"of {len(rules[fam])} {fam} rules")

    # -- one round -----------------------------------------------------------

    def entry_batch(self, lanes: Lanes) -> Dict[str, np.ndarray]:
        b = self.ebuf
        rows = self.rows
        b["cluster_row"][:] = rows.cluster[lanes.resource]
        b["dn_row"][:] = rows.default[lanes.resource]
        b["origin_row"][:] = np.where(lanes.origin,
                                      rows.origin[lanes.resource], -1)
        b["origin_id"][:] = np.where(lanes.origin, rows.origin_id, -3)
        b["count"][:] = lanes.count
        b["param_hash"][:, 0] = lanes.key
        return b

    def exit_batch(self, lanes: Lanes, reason: np.ndarray,
                   exits: Exits) -> Dict[str, np.ndarray]:
        b = self.xbuf
        e = self.ebuf
        ok = reason == 0
        for f in ("dn_row", "origin_row", "count", "param_hash"):
            b[f][:] = e[f]
        b["cluster_row"][:] = np.where(ok, e["cluster_row"], -1)
        b["success"][:] = ok
        b["rt_ms"][:] = exits.rt_ms
        b["error"][:] = exits.error
        return b

    # -- what the comparison reads -------------------------------------------

    def reason_codes(self, reason: np.ndarray) -> np.ndarray:
        """The program's verdict codes in the reference's numbering."""
        B = self.C.BlockReason
        table = np.full(max(int(v) for v in B) + 2, -9, np.int8)
        table[int(B.PASS)] = ref.R_PASS
        table[int(B.FLOW)] = ref.R_FLOW
        table[int(B.DEGRADE)] = ref.R_DEGRADE
        table[int(B.SYSTEM)] = ref.R_SYSTEM
        table[int(B.PARAM_FLOW)] = ref.R_PARAM
        return table[np.clip(reason, -1, table.size - 2)]

    def node_rows(self) -> np.ndarray:
        """The program's row of each reference node, -1 where it has
        none."""
        rows = self.rows
        return np.concatenate([rows.cluster, rows.default, rows.origin,
                               [self.entry_row]]).astype(np.int64)

    def snapshot(self) -> Dict:
        """The committed state, read from the engine's device state, in the
        reference's node space (``Reference.snapshot``), plus the program's
        state outside those nodes (which has to be empty)."""
        import torch

        from sentinel_tpu_torch.ops.step import telemetry_view

        C = self.C
        eng = self.engine
        eng._flush_committer()
        with eng._lock:
            st = eng.state
            totals = telemetry_view(st).totals.cpu().numpy()
            threads = st.cur_threads.cpu().numpy()
            dstate = st.degrade.state.cpu().numpy()
            dretry = st.degrade.next_retry_ms.cpu().numpy()
            fl = st.flight
            stamps = fl.stamps.cpu().numpy() if fl is not None else None
            events = fl.events.cpu().numpy() if fl is not None else None
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize()
        rows = self.node_rows()
        have = rows >= 0

        def pick(a: np.ndarray) -> np.ndarray:
            """``a``'s last axis in node order, 0 for a node with no row."""
            out = np.zeros(a.shape[:-1] + (rows.size,), np.int64)
            out[..., have] = a[..., rows[have]]
            return out

        order = [int(getattr(C.MetricEvent, e.upper())) for e in ref.EVENTS]
        outside = np.ones(totals.shape[1], bool)
        outside[rows[have]] = False
        seconds = {}
        ring_outside = 0
        if stamps is not None:
            for i in np.flatnonzero(stamps >= 0):
                ev = events[i]
                seconds[int(stamps[i])] = pick(ev[order])
                ring_outside += int(np.count_nonzero(ev[:, outside]))
        state_name = {C.BREAKER_CLOSED: ref.CLOSED, C.BREAKER_OPEN: ref.OPEN,
                      C.BREAKER_HALF_OPEN: ref.HALF_OPEN}
        rules = rule_layout(self.cfg)["degrade"]
        breakers = np.array(
            [[r["resource"], state_name.get(int(dstate[j]), -1),
              int(dretry[j])] for j, r in enumerate(rules)],
            np.int64).reshape(-1, 3)
        return {
            "totals": pick(totals[order]),
            "seconds": seconds,
            "threads": pick(threads),
            "breakers": breakers,
            "outside": int(np.count_nonzero(totals[:, outside]))
            + int(np.count_nonzero(threads[outside])) + ring_outside,
        }
