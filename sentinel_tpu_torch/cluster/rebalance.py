"""Self-driving shard placement (port of
``sentinel_tpu/cluster/rebalance.py``): a governed, chaos-certified
rebalancer with leader join/leave autoscaling.

The :class:`ShardRebalancer` closes the loop the fleet plane
opened: it **senses** per-slice load and per-leader health from
``FleetView`` folds, **proposes** minimal-movement :class:`ShardMap`
diffs under a hard safety envelope, optionally **certifies** the diff by
replaying the handoff as an in-process chaos-mesh episode under a seeded
fault schedule, and **applies** through the existing journal-audited HA
path — every stage an ``acting("rebalancer")`` journal record chained
``rebalancePropose -> rebalanceCertify -> rebalanceApply ->
shardMapApply -> haRoleFlip`` via causeSeq.

Safety envelope (all veto paths counted and journalled):

- at most ``csp.sentinel.rebalance.max.slices.per.epoch`` slices move
  per applied plan;
- per-slice cooldown + direction-flip hysteresis via the shared
  :class:`~sentinel_tpu_torch.adaptive.envelope.CooldownLedger` (stamped at
  APPLY, not propose — an unapplied plan pins nothing);
- a slice whose owner is degraded or mid-handoff never moves;
- :class:`~sentinel_tpu_torch.adaptive.envelope.RebalanceFreezeGate`
  precedence ``manual > stale-telemetry > degraded-leader >
  abort-backoff`` gates propose AND apply (fold-out plans evaluate with
  an empty degraded set: the sick leader is the REASON to move);
- the last-known-good map is retained for one-command rollback.

Certification replays a SYNTHETIC mesh — same topology, renumbered
epochs, loopback seats — not the live fleet; SEMANTICS.md "Movement
bound & slice conservation" names the asymmetry.  The episode is a pure
function of ``(campaign_seed, plan)``: its verdict/fault sha256 oracles
replay bit-identically, and a plan that violates ANY invariant
(including the ``slice_conservation`` checker) is vetoed and
backs the rebalancer off.

This module never mutates shard state directly: the ONLY actuation is
``ha.apply_map(...)``, and it reads no wall clock — time comes from the
injected clock or the engine timebase.

Device: certification runs its synthetic mesh's leaders on the
rebalancer's ``device`` if one was given, else on its engine's (``cuda``
with neither, which raises with no card).
"""

from __future__ import annotations

import shutil
import tempfile
import threading
from typing import Callable, Dict, List, Optional

from sentinel_tpu_torch.adaptive.envelope import (
    CooldownLedger,
    RebalanceFreezeGate,
)
from sentinel_tpu_torch.cluster.sharding import ShardMap, slice_of
from sentinel_tpu_torch.core.config import config
from sentinel_tpu_torch.telemetry.journal import acting, causing

VETO_DEADBAND = "deadband"
VETO_FROZEN = "frozen"
VETO_COOLDOWN = "cooldown"
VETO_DEGRADED = "degraded-owner"
VETO_HANDOFF = "mid-handoff"
VETO_CERTIFY = "certification"
VETO_NO_MAP = "no-map"
VETO_NO_SIGNAL = "no-signal"


def _sha(lines) -> str:
    import hashlib

    h = hashlib.sha256()
    for line in lines:
        h.update(line.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


class RebalancePlan:
    """One proposed map diff moving through propose -> certify -> apply.

    ``moves`` is {slice: (from_mid, to_mid)}; ``proposed`` is the full
    successor :class:`ShardMap` (minimal movement: only moved slices
    change owner, only moved slices' epochs bump)."""

    __slots__ = ("plan_id", "reason", "created_ms", "base_version",
                 "moves", "proposed", "skew_before", "skew_after",
                 "vetoed_slices", "propose_seq", "certify_seq",
                 "apply_seq", "certified", "cert", "applied_ms")

    def __init__(self, plan_id: int, reason: str, created_ms: int,
                 base_version: int, moves: Dict[int, tuple],
                 proposed: ShardMap, skew_before: float, skew_after: float,
                 vetoed_slices: Dict[int, str], propose_seq: Optional[int]):
        self.plan_id = int(plan_id)
        self.reason = str(reason)
        self.created_ms = int(created_ms)
        self.base_version = int(base_version)
        self.moves = dict(moves)
        self.proposed = proposed
        self.skew_before = float(skew_before)
        self.skew_after = float(skew_after)
        self.vetoed_slices = dict(vetoed_slices)
        self.propose_seq = propose_seq
        self.certify_seq: Optional[int] = None
        self.apply_seq: Optional[int] = None
        self.certified: Optional[bool] = None  # None = not yet run
        self.cert: Optional[dict] = None
        self.applied_ms: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "planId": self.plan_id, "reason": self.reason,
            "createdMs": self.created_ms, "baseVersion": self.base_version,
            "proposedVersion": int(self.proposed.version),
            "moves": {str(sl): {"from": frm, "to": to}
                      for sl, (frm, to) in sorted(self.moves.items())},
            "skewBefore": self.skew_before, "skewAfter": self.skew_after,
            "vetoedSlices": {str(sl): why for sl, why
                             in sorted(self.vetoed_slices.items())},
            "proposeSeq": self.propose_seq,
            "certifySeq": self.certify_seq, "applySeq": self.apply_seq,
            "certified": self.certified,
            "cert": ({k: self.cert[k] for k in
                      ("ok", "verdictSha256", "faultSha256", "seed",
                       "seconds", "violations", "transfers",
                       "handoffMarginGrants")}
                     if self.cert else None),
            "appliedMs": self.applied_ms,
        }


class ShardRebalancer:
    """The governed control loop over shard placement.

    Every collaborator is injectable for drills; defaults resolve from
    the engine AT CALL TIME (the HA seat and fleet poller both have
    lifecycles of their own)."""

    MAX_PLANS = 8  # bounded plan history (newest kept)

    def __init__(self, engine=None, ha=None, fleet=None, journal=None,
                 flow_of: Optional[Callable] = None,
                 clock: Optional[Callable[[], int]] = None,
                 apply_via: Optional[Callable] = None, device=None):
        self.engine = engine
        self._device_override = device
        self._ha_override = ha
        self._fleet_override = fleet
        self._journal_override = journal
        self._flow_of_override = flow_of
        self._clock = clock
        self._apply_via = apply_via
        self._lock = threading.Lock()
        self.ledger = CooldownLedger(config.rebalance_cooldown_ms())
        self.gate = RebalanceFreezeGate(config.rebalance_stale_ms())
        self.manual_frozen = False
        self.backoff_until_ms = 0
        self.last_known_good: Optional[ShardMap] = None
        self.last_skew: float = 0.0
        self.plans: Dict[int, RebalancePlan] = {}
        self._next_plan = 1
        # Exporter counters (monotonic; gauges derived in metrics_state).
        self.plans_total = 0
        self.applies_total = 0
        self.rollbacks_total = 0
        self.vetoes_total = 0
        self.slices_moved_total = 0

    # -- collaborators (resolved at call time) -----------------------------

    def _now(self) -> int:
        if self._clock is not None:
            return int(self._clock())
        if self.engine is not None:
            return int(self.engine.now_ms())
        return 0

    def _device(self):
        """Where certification runs its mesh: resolved at call time."""
        from sentinel_tpu_torch.utils.device import resolve_device

        if self._device_override is not None:
            return resolve_device(self._device_override)
        return resolve_device(getattr(self.engine, "device", None))

    def _ha(self):
        if self._ha_override is not None:
            return self._ha_override
        cluster = getattr(self.engine, "cluster", None)
        return getattr(cluster, "ha", None)

    def _fleet(self):
        if self._fleet_override is not None:
            return self._fleet_override
        return getattr(self.engine, "fleet", None)

    def _journal(self):
        if self._journal_override is not None:
            return self._journal_override
        return getattr(self.engine, "journal", None)

    def _record(self, kind: str, cause_seq=None, **fields) -> Optional[int]:
        j = self._journal()
        if j is None:
            return None
        with acting("rebalancer"):
            return j.record(kind, cause_seq=cause_seq, **fields)

    def _flow_of(self) -> Callable:
        """resource -> flowId attribution: injected, else folded from the
        engine's cluster-mode flow rules (the same ``cluster_config``
        flowIds the wire carries)."""
        if self._flow_of_override is not None:
            return self._flow_of_override
        table: Dict[str, int] = {}
        if self.engine is not None:
            for r in self.engine.flow_rules.get_rules():
                if getattr(r, "cluster_mode", False) and r.cluster_config:
                    fid = r.cluster_config.get("flowId")
                    if fid is not None:
                        table[r.resource] = int(fid)
        return table.get

    def current_map(self) -> Optional[ShardMap]:
        ha = self._ha()
        return getattr(ha, "shard_map", None)

    # -- sense -------------------------------------------------------------

    def degraded_leaders(self) -> List[str]:
        """Leaders the fleet plane marks unhealthy: stale (no contact
        inside the bound) or fencing-epoch regression (a resurrected
        stale seat)."""
        fleet = self._fleet()
        if fleet is None:
            return []
        out = []
        for mid, row in fleet.status().get("leaders", {}).items():
            if row.get("stale") or row.get("epochRegressed"):
                out.append(mid)
        return sorted(out)

    def sense(self, window_seconds: Optional[int] = None) -> dict:
        """Fold fleet telemetry to slice granularity and project it
        onto CURRENT ownership: per-leader load is slice loads x the
        map in force, NOT the historical serving leader."""
        smap = self.current_map()
        fleet = self._fleet()
        if smap is None or fleet is None:
            return {"ok": False,
                    "reason": VETO_NO_MAP if smap is None else VETO_NO_SIGNAL}
        win = int(window_seconds if window_seconds is not None
                  else config.rebalance_window_seconds())
        fold = fleet.slice_loads(self._flow_of(), smap.n_slices,
                                 window_seconds=win)
        by_leader: Dict[str, int] = {s.machine_id: 0 for s in smap.servers}
        for sl, load in fold["slices"].items():
            by_leader[smap.slice_owner[int(sl)]] = \
                by_leader.get(smap.slice_owner[int(sl)], 0) + int(load)
        loads = list(by_leader.values())
        mean = (sum(loads) / len(loads)) if loads else 0.0
        skew = ((max(loads) - min(loads)) / mean) if mean > 0 else 0.0
        self.last_skew = float(skew)
        return {
            "ok": True, "mapVersion": int(smap.version),
            "settledThroughMs": fold["settledThroughMs"],
            "seconds": fold["seconds"],
            "sliceLoads": {int(s): int(v)
                           for s, v in sorted(fold["slices"].items())},
            "leaderLoads": dict(sorted(by_leader.items())),
            "unattributed": fold["unattributed"],
            "meanLoad": mean, "skew": float(skew),
            "degraded": self.degraded_leaders(),
        }

    def _freeze(self, reason: str) -> dict:
        fleet = self._fleet()
        settled = fleet.settled_through_ms() if fleet is not None else -1
        degraded = () if reason == "leave" else tuple(self.degraded_leaders())
        st = self.gate.evaluate(
            self._now(), manual_frozen=self.manual_frozen,
            settled_through_ms=int(settled), degraded_leaders=degraded,
            backoff_until_ms=self.backoff_until_ms)
        return {"frozen": st.frozen, "reason": st.reason}

    # -- propose -----------------------------------------------------------

    def propose(self, reason: str = "skew",
                window_seconds: Optional[int] = None) -> dict:
        """Build a minimal-movement plan draining the hottest leader
        toward the coldest, greedy heaviest-slice-first, under the full
        safety envelope. Returns the plan dict or a veto dict."""
        with self._lock:
            return self._propose_locked(reason, window_seconds)

    def _propose_locked(self, reason: str, window_seconds) -> dict:
        now = self._now()
        frozen = self._freeze(reason)
        if frozen["frozen"]:
            self.vetoes_total += 1
            self._record("rebalanceVeto", reason=VETO_FROZEN,
                         frozenBy=frozen["reason"])
            return {"ok": False, "veto": VETO_FROZEN,
                    "frozenBy": frozen["reason"]}
        smap = self.current_map()
        if smap is None:
            self.vetoes_total += 1
            return {"ok": False, "veto": VETO_NO_MAP}
        sensed = self.sense(window_seconds)
        if not sensed.get("ok"):
            self.vetoes_total += 1
            return {"ok": False, "veto": sensed.get("reason", VETO_NO_SIGNAL)}
        deadband = config.rebalance_skew_deadband_pct()
        if sensed["skew"] <= deadband and reason == "skew":
            return {"ok": False, "veto": VETO_DEADBAND,
                    "skew": sensed["skew"], "deadband": deadband}
        moves, vetoed, skew_after = self._greedy_moves(
            smap, sensed, now, reason)
        if not moves:
            self.vetoes_total += 1
            self._record("rebalanceVeto", reason=VETO_DEADBAND,
                         detail="no admissible move improves skew",
                         vetoedSlices={str(k): v for k, v in vetoed.items()})
            return {"ok": False, "veto": VETO_DEADBAND,
                    "vetoedSlices": vetoed}
        proposed = smap.with_moves({sl: to for sl, (_f, to) in moves.items()})
        plan = self._commit_plan(reason, now, smap, moves, proposed,
                                 sensed["skew"], skew_after, vetoed)
        return {"ok": True, "plan": plan.to_dict()}

    def _greedy_moves(self, smap: ShardMap, sensed: dict, now: int,
                      reason: str):
        """Heaviest-slice-first from hottest to coldest leader, bounded
        by the movement cap and the per-slice envelope."""
        cap = config.rebalance_max_slices_per_epoch()
        slice_load = sensed["sliceLoads"]
        loads = dict(sensed["leaderLoads"])
        degraded = set(sensed["degraded"])
        ha = self._ha()
        mid_handoff = bool(ha is not None and hasattr(ha, "transition_pending")
                           and ha.transition_pending())
        moves: Dict[int, tuple] = {}
        vetoed: Dict[int, str] = {}
        for _ in range(cap):
            if len(loads) < 2:
                break
            hot = max(loads, key=lambda m: (loads[m], m))
            cold = min(loads, key=lambda m: (loads[m], m))
            if hot == cold or loads[hot] <= loads[cold]:
                break
            candidates = sorted(
                (sl for sl in smap.slices_of(hot) if sl not in moves),
                key=lambda sl: (-slice_load.get(sl, 0), sl))
            moved = False
            for sl in candidates:
                load = slice_load.get(sl, 0)
                if load <= 0:
                    # Candidates are load-sorted: everything from here
                    # on carries no traffic and cannot improve skew.
                    break
                # A move only helps while the donor stays at least as
                # loaded as the recipient becomes (else it overshoots
                # and the flip hysteresis would fight the next plan).
                if loads[hot] - load < loads[cold] + load:
                    continue
                if mid_handoff:
                    vetoed[sl] = VETO_HANDOFF
                    continue
                if hot in degraded and reason != "leave":
                    vetoed[sl] = VETO_DEGRADED
                    break
                paced = self.ledger.check(sl, cold, now)
                if paced is not None:
                    vetoed[sl] = paced  # "cooldown" | "hysteresis"
                    continue
                moves[sl] = (hot, cold)
                loads[hot] -= load
                loads[cold] += load
                moved = True
                break
            if not moved:
                break
        mean = sensed["meanLoad"]
        skew_after = ((max(loads.values()) - min(loads.values())) / mean
                      if mean > 0 and loads else 0.0)
        return moves, vetoed, skew_after

    def _commit_plan(self, reason, now, smap, moves, proposed,
                     skew_before, skew_after, vetoed) -> RebalancePlan:
        plan_id = self._next_plan
        self._next_plan += 1
        seq = self._record(
            "rebalancePropose", planId=plan_id, reason=reason,
            baseVersion=int(smap.version),
            proposedVersion=int(proposed.version),
            moves={str(sl): {"from": frm, "to": to}
                   for sl, (frm, to) in sorted(moves.items())},
            skewBefore=float(skew_before), skewAfter=float(skew_after),
            vetoedSlices={str(k): v for k, v in sorted(vetoed.items())})
        plan = RebalancePlan(plan_id, reason, now, smap.version, moves,
                             proposed, skew_before, skew_after, vetoed, seq)
        self.plans[plan_id] = plan
        while len(self.plans) > self.MAX_PLANS:
            victim = min(self.plans)
            if victim == plan_id:
                break
            del self.plans[victim]
        self.plans_total += 1
        return plan

    # -- autoscaling: leader join/leave ------------------------------------

    def plan_join(self, machine_id: str, host: str, port: int) -> dict:
        """Fold a NEW seat in: add it to the server set and move up to
        the movement cap of the heaviest slices onto it — the same
        certify -> apply pipeline as a skew plan."""
        from sentinel_tpu_torch.cluster.ha import ClusterServerSpec

        with self._lock:
            now = self._now()
            frozen = self._freeze("join")
            if frozen["frozen"]:
                self.vetoes_total += 1
                self._record("rebalanceVeto", reason=VETO_FROZEN,
                             frozenBy=frozen["reason"], join=machine_id)
                return {"ok": False, "veto": VETO_FROZEN,
                        "frozenBy": frozen["reason"]}
            smap = self.current_map()
            if smap is None:
                self.vetoes_total += 1
                return {"ok": False, "veto": VETO_NO_MAP}
            if smap.server_for(machine_id) is not None:
                return {"ok": False, "veto": "already-member"}
            sensed = self.sense(None)
            slice_load = sensed.get("sliceLoads", {}) if sensed.get("ok") \
                else {}
            cap = config.rebalance_max_slices_per_epoch()
            degraded = set(self.degraded_leaders())
            donors = sorted(
                ((sl, smap.slice_owner[sl]) for sl in range(smap.n_slices)
                 if smap.slice_owner[sl] not in degraded),
                key=lambda p: (-slice_load.get(p[0], 0), p[0]))
            moves: Dict[int, tuple] = {}
            vetoed: Dict[int, str] = {}
            for sl, owner in donors:
                if len(moves) >= cap:
                    break
                paced = self.ledger.check(sl, machine_id, now)
                if paced is not None:
                    vetoed[sl] = paced
                    continue
                moves[sl] = (owner, machine_id)
            grown = smap._replace(
                servers=smap.servers
                + (ClusterServerSpec(machine_id, host, int(port)),))
            proposed = grown.with_moves(
                {sl: to for sl, (_f, to) in moves.items()})
            plan = self._commit_plan("join", now, smap, moves, proposed,
                                     sensed.get("skew", 0.0), 0.0, vetoed)
            return {"ok": True, "plan": plan.to_dict()}

    def plan_leave(self, machine_id: str) -> dict:
        """Fold a seat OUT: move up to the cap of its slices to the
        least-loaded survivors; the seat leaves the server set once it
        owns nothing. The freeze gate is evaluated WITHOUT the degraded
        set — the sick leader is the reason to move."""
        with self._lock:
            now = self._now()
            frozen = self._freeze("leave")
            if frozen["frozen"]:
                self.vetoes_total += 1
                self._record("rebalanceVeto", reason=VETO_FROZEN,
                             frozenBy=frozen["reason"], leave=machine_id)
                return {"ok": False, "veto": VETO_FROZEN,
                        "frozenBy": frozen["reason"]}
            smap = self.current_map()
            if smap is None:
                self.vetoes_total += 1
                return {"ok": False, "veto": VETO_NO_MAP}
            if smap.server_for(machine_id) is None:
                return {"ok": False, "veto": "not-a-member"}
            survivors = [s.machine_id for s in smap.servers
                         if s.machine_id != machine_id]
            if not survivors:
                self.vetoes_total += 1
                return {"ok": False, "veto": "last-seat"}
            sensed = self.sense(None)
            slice_load = sensed.get("sliceLoads", {}) if sensed.get("ok") \
                else {}
            loads = {m: 0 for m in survivors}
            if sensed.get("ok"):
                for m in survivors:
                    loads[m] = sensed["leaderLoads"].get(m, 0)
            cap = config.rebalance_max_slices_per_epoch()
            owned = sorted(smap.slices_of(machine_id),
                           key=lambda sl: (-slice_load.get(sl, 0), sl))
            moves: Dict[int, tuple] = {}
            for sl in owned[:cap]:
                cold = min(loads, key=lambda m: (loads[m], m))
                moves[sl] = (machine_id, cold)
                loads[cold] += slice_load.get(sl, 0)
            remaining = len(owned) - len(moves)
            base = smap.with_moves({sl: to for sl, (_f, to)
                                    in moves.items()})
            if remaining == 0:
                base = base._replace(servers=tuple(
                    s for s in base.servers if s.machine_id != machine_id))
            plan = self._commit_plan("leave", now, smap, moves, base,
                                     sensed.get("skew", 0.0), 0.0, {})
            out = {"ok": True, "plan": plan.to_dict()}
            if remaining:
                out["remainingSlices"] = remaining  # next epoch's plan
            return out

    # -- certify: the chaos-mesh dry-run -----------------------------------

    def certify(self, plan_id: int, campaign_seed: int = 0,
                seconds: Optional[int] = None, per_second: int = 2,
                max_faults: int = 4) -> dict:
        """Replay the plan's handoff on a synthetic in-process mesh
        under the seeded fault schedule; veto on ANY invariant
        violation. Pure function of ``(campaign_seed, plan)`` — the
        verdict/fault shas replay bit-identically."""
        with self._lock:
            plan = self.plans.get(int(plan_id))
            if plan is None:
                return {"ok": False, "veto": "unknown-plan"}
            secs = int(seconds if seconds is not None
                       else config.rebalance_certify_seconds())
            cert = self._certify_episode(plan, int(campaign_seed), secs,
                                         int(per_second), int(max_faults))
            plan.cert = cert
            plan.certified = cert["ok"]
            plan.certify_seq = self._record(
                "rebalanceCertify", cause_seq=plan.propose_seq,
                planId=plan.plan_id, ok=cert["ok"], seed=cert["seed"],
                verdictSha256=cert["verdictSha256"],
                faultSha256=cert["faultSha256"],
                violations=cert["violations"])
            if not cert["ok"]:
                self.vetoes_total += 1
                self.backoff_until_ms = (self._now()
                                         + config.rebalance_abort_backoff_ms())
            return {"ok": cert["ok"], "planId": plan.plan_id, "cert": cert}

    def _certify_episode(self, plan: RebalancePlan, campaign_seed: int,
                         seconds: int, per_second: int,
                         max_faults: int) -> dict:
        from sentinel_tpu_torch.chaos.invariants import History, check_all
        from sentinel_tpu_torch.chaos.mesh import ChaosMesh
        from sentinel_tpu_torch.chaos.scheduler import FaultScheduler, episode_seed
        from sentinel_tpu_torch.resilience import FaultInjector
        from sentinel_tpu_torch.simulator.clock import SimClock

        smap = plan.proposed
        base = self.current_map()
        # The mesh needs every seat that appears on EITHER side of the
        # diff: a fold-out plan's donor is gone from the proposed server
        # set but must be live to hand its slices off.
        base_mids = (tuple(s.machine_id for s in base.servers)
                     if base is not None else ())
        leaders = tuple(dict.fromkeys(
            tuple(s.machine_id for s in smap.servers) + base_mids))
        n = int(smap.n_slices)
        flows = self._certify_flows(plan, n)
        # The synthetic mesh renumbers epochs (1 = mesh-initial, 2 =
        # seeded current, 3 = the plan) — topology is what is under
        # test, and the live map's absolute epochs would collide with
        # the mesh's own version-1 bootstrap map.
        cur_assign = {m: [] for m in leaders}
        if base is not None:
            for sl in range(min(n, base.n_slices)):
                cur_assign.setdefault(base.slice_owner[sl], []).append(sl)
        inject_assign = {m: [] for m in leaders}
        inject_epochs = {}
        for sl in range(n):
            inject_assign.setdefault(smap.slice_owner[sl], []).append(sl)
            changed = (base is None or sl >= base.n_slices
                       or smap.slice_epoch[sl] != base.slice_epoch[sl])
            inject_epochs[sl] = 3 if changed else 2
        seed = episode_seed(campaign_seed, plan.plan_id)
        scheduler = FaultScheduler(leaders=leaders, flows=flows,
                                   n_slices=n, seconds=seconds,
                                   max_faults=max_faults)
        # A schedule-random rebalance could override the plan under
        # certification — drop that kind, keep every real fault.
        sched = [a for a in scheduler.schedule(campaign_seed, plan.plan_id)
                 if a.get("kind") != "rebalance"]
        workdir = tempfile.mkdtemp(prefix="sentinel-rebalance-cert-")
        clock = SimClock(config.chaos_epoch_ms())
        history = History()
        mesh = None
        violations: List = []
        inject_at = max(1, seconds // 2)
        try:
            with FaultInjector(seed=seed, scope_thread=True) as injector:
                mesh = ChaosMesh(clock, history, workdir, leaders=leaders,
                                 n_slices=n, flows=flows,
                                 device=self._device())
                mesh.rebalance(cur_assign, {sl: 2 for sl in range(n)},
                               version=2)
                by_sec: Dict[int, List[dict]] = {}
                for act in sched:
                    by_sec.setdefault(int(act["at"]), []).append(act)
                restores: Dict[int, List[str]] = {}
                flow_order = sorted(flows)
                transfers_before = 0
                for sec in range(seconds):
                    for mid in restores.pop(sec, ()):
                        mesh.link_up[mid] = True
                        mesh.log_fault("link.up", mid, sec=sec)
                    for act in by_sec.get(sec, ()):
                        up_at = mesh.apply_action(act, injector, sec)
                        if up_at is not None:
                            restores.setdefault(min(up_at, seconds),
                                                []).append(act["leader"])
                    if sec == inject_at:
                        transfers_before = len(history.of("transfer"))
                        mesh.rebalance(inject_assign, inject_epochs,
                                       version=3)
                    for fid in flow_order:
                        for _ in range(per_second):
                            mesh.request(fid, sec)
                    violations = check_all(history, mesh.thresholds,
                                           mesh.divisor)
                    if violations:
                        break
                    clock.advance(1000)
                mesh.collect_journals()
                if not violations:
                    violations = check_all(history, mesh.thresholds,
                                           mesh.divisor)
                verdict_sha = _sha(
                    f"{ev['op']}:{ev['flow']}:{ev['status']}:{ev['by']}"
                    f":{ev.get('wire')}"
                    for ev in history.of("verdict"))
                fault_sha = _sha(repr(entry) for entry in mesh.fault_log)
                all_transfers = history.of("transfer")
                transfers = len(all_transfers) - transfers_before
                ops = len(history.of("offered"))
                grant_evs = history.of("grant")
                grants = len(grant_evs)
                # The observed handoff margin: grants already standing
                # in each transfer's window when ownership moved — the
                # evidence the over-admission bound credits.
                margin = sum(
                    1 for t in all_transfers[transfers_before:]
                    for g in grant_evs
                    if g.get("flow") == t["flow"]
                    and g.get("win") == t["win"])
        finally:
            if mesh is not None:
                mesh.stop()
            shutil.rmtree(workdir, ignore_errors=True)
        return {
            "ok": not violations, "seed": seed, "seconds": seconds,
            "violations": [v.to_dict() for v in violations],
            "verdictSha256": verdict_sha, "faultSha256": fault_sha,
            "transfers": transfers, "ops": ops, "grants": grants,
            "handoffMarginGrants": margin,
            "schedule": sched,
        }

    @staticmethod
    def _certify_flows(plan: RebalancePlan, n_slices: int,
                       rate: float = 6.0) -> Dict[int, float]:
        """Deterministic flow set exercising the handoff: one flowId
        per MOVED slice (so every move is driven through grant/fence
        traffic), plus two background flows on untouched slices."""
        flows: Dict[int, float] = {}
        want = sorted(plan.moves)
        untouched = [sl for sl in range(n_slices) if sl not in plan.moves]
        want += untouched[:2]
        fid = 9000
        need = set(want)
        while need and fid < 9000 + 50_000:
            sl = slice_of(fid, n_slices)
            if sl in need:
                flows[fid] = rate
                need.discard(sl)
            fid += 1
        return flows

    # -- apply / rollback --------------------------------------------------

    def apply(self, plan_id: int, force: bool = False) -> dict:
        """Actuate a certified plan through the journal-audited HA
        path; the ONLY mutation is ``ha.apply_map``. Saves the prior
        map as last-known-good and stamps the per-slice cooldown
        ledger (cooldowns start at APPLY)."""
        with self._lock:
            plan = self.plans.get(int(plan_id))
            if plan is None:
                return {"ok": False, "veto": "unknown-plan"}
            if plan.certified is not True and not force:
                self.vetoes_total += 1
                self._record("rebalanceVeto", reason=VETO_CERTIFY,
                             planId=plan.plan_id,
                             detail="apply without certification")
                return {"ok": False, "veto": VETO_CERTIFY,
                        "certified": plan.certified}
            frozen = self._freeze(plan.reason)
            if frozen["frozen"] and not force:
                self.vetoes_total += 1
                self._record("rebalanceVeto", reason=VETO_FROZEN,
                             frozenBy=frozen["reason"], planId=plan.plan_id)
                return {"ok": False, "veto": VETO_FROZEN,
                        "frozenBy": frozen["reason"]}
            smap = self.current_map()
            if smap is not None and smap.version != plan.base_version:
                self.vetoes_total += 1
                return {"ok": False, "veto": "stale-plan",
                        "baseVersion": plan.base_version,
                        "currentVersion": int(smap.version)}
            now = self._now()
            plan.apply_seq = self._record(
                "rebalanceApply",
                cause_seq=(plan.certify_seq if plan.certify_seq is not None
                           else plan.propose_seq),
                planId=plan.plan_id, reason=plan.reason, forced=bool(force),
                version=int(plan.proposed.version),
                slicesMoved=sorted(plan.moves))
            self.last_known_good = smap
            self._actuate(plan.proposed, plan.apply_seq)
            for sl, (_frm, to) in plan.moves.items():
                self.ledger.stamp(sl, to, now)
            plan.applied_ms = now
            self.applies_total += 1
            self.slices_moved_total += len(plan.moves)
            return {"ok": True, "planId": plan.plan_id,
                    "applySeq": plan.apply_seq,
                    "version": int(plan.proposed.version),
                    "slicesMoved": len(plan.moves)}

    def _actuate(self, smap: ShardMap, apply_seq: Optional[int]) -> None:
        """The single actuation path: ``ha.apply_map`` under the apply
        record's causeSeq, so the downstream ``shardMapApply`` /
        ``haRoleFlip`` records chain back to the rebalancer."""
        apply_via = self._apply_via
        if apply_via is None:
            ha = self._ha()
            if ha is None:
                raise RuntimeError("no HA seat to apply through")
            apply_via = ha.apply_map
        with acting("rebalancer"):
            if apply_seq is not None:
                with causing(apply_seq):
                    apply_via(smap)
            else:
                apply_via(smap)

    def rollback(self) -> dict:
        """One-command restore of last-known-good OWNERSHIP: a fresh
        forward map (version and moved-slice epochs necessarily bump —
        per-slice fencing forbids reviving old epochs) whose owners are
        the retained map's."""
        with self._lock:
            lkg = self.last_known_good
            if lkg is None:
                return {"ok": False, "veto": "no-lkg"}
            smap = self.current_map()
            if smap is None:
                return {"ok": False, "veto": VETO_NO_MAP}
            moves = {sl: lkg.slice_owner[sl]
                     for sl in range(min(smap.n_slices, lkg.n_slices))
                     if smap.slice_owner[sl] != lkg.slice_owner[sl]}
            restored = smap.with_moves(moves)
            if lkg.servers != smap.servers:
                restored = restored._replace(servers=lkg.servers)
            seq = self._record(
                "rebalanceRollback", version=int(restored.version),
                restoredOwnershipOf=int(lkg.version),
                slicesMoved=sorted(moves))
            self._actuate(restored, seq)
            now = self._now()
            for sl, to in moves.items():
                self.ledger.stamp(sl, to, now)
            self.last_known_good = smap
            self.rollbacks_total += 1
            return {"ok": True, "version": int(restored.version),
                    "slicesMoved": len(moves), "rollbackSeq": seq}

    # -- governance --------------------------------------------------------

    def freeze(self, on: bool) -> dict:
        with self._lock:
            self.manual_frozen = bool(on)
            self._record("rebalanceFreeze", frozen=self.manual_frozen)
            return {"ok": True, "frozen": self.manual_frozen}

    def reset_timebase(self) -> None:
        """Clock-swap hygiene (the engine's set_clock discipline): the
        ledger's stamps and the abort backoff are absolute times of the
        OLD timebase."""
        with self._lock:
            self.ledger.reset()
            self.backoff_until_ms = 0

    # -- surfaces ----------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            smap = self.current_map()
            frozen = self._freeze("status")
            return {
                "frozen": frozen["frozen"], "frozenBy": frozen["reason"],
                "manualFrozen": self.manual_frozen,
                "backoffUntilMs": self.backoff_until_ms,
                "mapVersion": int(smap.version) if smap else None,
                "lastKnownGoodVersion": (int(self.last_known_good.version)
                                         if self.last_known_good else None),
                "lastSkew": self.last_skew,
                "degraded": self.degraded_leaders(),
                "counters": {
                    "plans": self.plans_total,
                    "applies": self.applies_total,
                    "rollbacks": self.rollbacks_total,
                    "vetoes": self.vetoes_total,
                    "slicesMoved": self.slices_moved_total,
                },
                "plans": [self.plans[pid].to_dict()
                          for pid in sorted(self.plans)],
            }

    def metrics_state(self) -> dict:
        """The exporter's read: counter values + gauges, one flat dict
        (``sentinel_tpu_rebalance_*`` families)."""
        with self._lock:
            frozen = self._freeze("status")
            return {
                "plans": self.plans_total,
                "applies": self.applies_total,
                "rollbacks": self.rollbacks_total,
                "vetoes": self.vetoes_total,
                "slices_moved": self.slices_moved_total,
                "frozen": 1 if frozen["frozen"] else 0,
                "skew": float(self.last_skew),
            }
