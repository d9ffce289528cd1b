"""Flow rules: QPS / concurrency limiting with four shaping behaviors (port
of ``sentinel_tpu/models/flow.py``).

DefaultController (fast fail), WarmUpController (Guava SmoothWarmingUp
token bucket, coldFactor 3), RateLimiterController (leaky bucket with a
queueing cap) and WarmUpRateLimiter. Rules compile host-side into
struct-of-arrays tensors; the checker is one vectorized function over the
micro-batch. Arrival-order exactness inside a batch comes from segmented
prefixes over the node rows each request commits PASS to — three row
spaces (cluster, default node, origin) resolved by ONE prefix-kernel
launch per sweep (``ops/segment.py``).

Cluster-mode rules admit against the pod-global window: the pod drivers
(``parallel/cluster.py``, ``parallel/namespaces.py``) hand in the other
shards' pass counts and next-window use (``extra_pass``, ``extra_next``),
and for ``scope="global"`` rules the cross-slice twins
(``extra_pass_global``, ``extra_next_global``). Local rules ignore them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import EntryBatch
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.ops import fixpoint as FX
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.segment import (
    segmented_prefix_dense,
    segmented_prefix_dense_multi,
)
from sentinel_tpu_torch.ops.window import add_at, gather, in_range, max_at
from sentinel_tpu_torch.utils.device import host_bool, resolve_device
from sentinel_tpu_torch.utils.fp import fma32
from sentinel_tpu_torch.utils.shapes import round_up as _round_up


@dataclass
class FlowRule:
    resource: str
    count: float
    grade: int = C.FLOW_GRADE_QPS
    limit_app: str = C.LIMIT_APP_DEFAULT
    strategy: int = C.FLOW_STRATEGY_DIRECT
    ref_resource: Optional[str] = None
    control_behavior: int = C.CONTROL_BEHAVIOR_DEFAULT
    warm_up_period_sec: int = 10
    max_queueing_time_ms: int = 500
    cluster_mode: bool = False
    cluster_config: Optional[dict] = None
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None
    derived_from: Optional[str] = None

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0:
            return False
        if self.grade not in (C.FLOW_GRADE_QPS, C.FLOW_GRADE_THREAD):
            return False
        if self.strategy in (C.FLOW_STRATEGY_RELATE, C.FLOW_STRATEGY_CHAIN) and not self.ref_resource:
            return False
        if self.control_behavior == C.CONTROL_BEHAVIOR_WARM_UP and self.warm_up_period_sec <= 0:
            return False
        return True


class FlowRuleTensors(NamedTuple):
    """Compiled SoA rule tensors + the per-resource-row rule index."""

    resource_row: torch.Tensor   # int32[FR] ClusterNode row of rule.resource
    sync_row: torch.Tensor       # int32[FR] node row warm-up token sync reads
    grade: torch.Tensor          # int32[FR]
    threshold: torch.Tensor      # float32[FR]
    strategy: torch.Tensor       # int32[FR]
    limit_origin: torch.Tensor   # int32[FR] origin id | ORIGIN_ID_{DEFAULT,OTHER}
    ref_row: torch.Tensor        # int32[FR] RELATE target ClusterNode row, -1
    ref_context: torch.Tensor    # int32[FR] CHAIN context id, -1
    behavior: torch.Tensor       # int32[FR]
    max_queue_us: torch.Tensor   # int64[FR] rate-limiter max queueing time (µs)
    cost_us: torch.Tensor        # int64[FR] rate-limiter cost per token (µs)
    warning_token: torch.Tensor  # float32[FR] warm-up params
    max_token: torch.Tensor      # float32[FR]
    slope: torch.Tensor          # float32[FR]
    cluster_mode: torch.Tensor   # bool[FR]
    remote_mode: torch.Tensor    # bool[FR] cluster rule WITH a flowId
    dcn_mode: torch.Tensor       # bool[FR] cluster rule with scope="global"
    rules_by_row: torch.Tensor   # int32[R, K] rule ids per ClusterNode row, -1 pad

    @property
    def num_rules(self) -> int:
        return self.resource_row.shape[0]

    @property
    def slots(self) -> int:
        return self.rules_by_row.shape[1]


class FlowState(NamedTuple):
    """Per-rule mutable device state (re-created on rule load)."""

    stored_tokens: torch.Tensor     # float32[FR] warm-up bucket
    last_filled_ms: torch.Tensor    # int64[FR]
    latest_passed_us: torch.Tensor  # int64[FR] rate-limiter leaky bucket head


def make_flow_state(num_rules: int, now_ms: int, device=None) -> FlowState:
    del now_ms  # kept in the signature, as in the JAX package
    device = resolve_device(device)
    # lastFilledTime starts at epoch 0 so the first sync refills the bucket
    # to maxToken — the reference's cold-start state.
    return FlowState(
        stored_tokens=torch.zeros((num_rules,), dtype=torch.float32,
                                  device=device),
        last_filled_ms=torch.zeros((num_rules,), dtype=torch.int64,
                                   device=device),
        latest_passed_us=torch.zeros((num_rules,), dtype=torch.int64,
                                     device=device),
    )


def named_origin_map(rules: List[FlowRule], registry: NodeRegistry) -> Dict[str, Set[int]]:
    """resource -> origin ids explicitly named by valid rules' limitApp."""
    named: Dict[str, Set[int]] = {}
    for r in rules:
        if r.is_valid() and r.limit_app not in (C.LIMIT_APP_DEFAULT, C.LIMIT_APP_OTHER):
            named.setdefault(r.resource, set()).add(registry.origin_id(r.limit_app))
    return named


def compile_flow_rules(
    rules: List[FlowRule],
    registry: NodeRegistry,
    num_rows: int,
    min_slots: int = 1,
    device=None,
) -> Tuple[FlowRuleTensors, Dict[str, Set[int]]]:
    """Host-side rule build (reference: ``FlowRuleUtil.buildFlowRuleMap``).
    Returns the tensors plus the per-resource set of named origin ids."""
    device = resolve_device(device)
    valid = [r for r in rules if r.is_valid()]
    fr = _round_up(len(valid), 8)
    res_row = np.full(fr, -1, np.int32)
    sync_row = np.full(fr, -1, np.int32)
    grade = np.zeros(fr, np.int32)
    threshold = np.zeros(fr, np.float32)
    strategy = np.zeros(fr, np.int32)
    limit_origin = np.full(fr, C.ORIGIN_ID_DEFAULT, np.int32)
    ref_row = np.full(fr, -1, np.int32)
    ref_context = np.full(fr, -1, np.int32)
    behavior = np.zeros(fr, np.int32)
    max_queue_us = np.zeros(fr, np.int64)
    cost_us = np.zeros(fr, np.int64)
    warning_token = np.zeros(fr, np.float32)
    max_token = np.zeros(fr, np.float32)
    slope = np.zeros(fr, np.float32)
    cluster_mode = np.zeros(fr, bool)
    remote_mode = np.zeros(fr, bool)
    dcn_mode = np.zeros(fr, bool)

    named_origins = named_origin_map(valid, registry)
    by_row: Dict[int, List[int]] = {}

    for i, r in enumerate(valid):
        row = registry.cluster_row(r.resource)
        res_row[i] = row
        grade[i] = r.grade
        threshold[i] = r.count
        strategy[i] = r.strategy
        behavior[i] = r.control_behavior
        cluster_mode[i] = r.cluster_mode
        remote_mode[i] = (r.cluster_mode
                          and (r.cluster_config or {}).get("flowId") is not None)
        dcn_mode[i] = (r.cluster_mode
                       and (r.cluster_config or {}).get("scope") == "global")
        if r.limit_app == C.LIMIT_APP_DEFAULT:
            limit_origin[i] = C.ORIGIN_ID_DEFAULT
        elif r.limit_app == C.LIMIT_APP_OTHER:
            limit_origin[i] = C.ORIGIN_ID_OTHER
        else:
            limit_origin[i] = registry.origin_id(r.limit_app)
        if r.strategy == C.FLOW_STRATEGY_RELATE:
            ref_row[i] = registry.cluster_row(r.ref_resource)
        elif r.strategy == C.FLOW_STRATEGY_CHAIN:
            ref_context[i] = registry.context_id(r.ref_resource)
        # Warm-up token sync reads the node admission checks against.
        if r.strategy == C.FLOW_STRATEGY_RELATE:
            sync_row[i] = ref_row[i]
        elif r.strategy == C.FLOW_STRATEGY_CHAIN:
            sync_row[i] = registry.default_row(
                r.ref_resource, r.resource, registry.entrance_row(r.ref_resource)
            )
        elif r.limit_app not in (C.LIMIT_APP_DEFAULT, C.LIMIT_APP_OTHER):
            sync_row[i] = registry.origin_row(r.resource, r.limit_app)
        else:
            sync_row[i] = row
        if r.control_behavior in (C.CONTROL_BEHAVIOR_RATE_LIMITER, C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER):
            cost_us[i] = int(round(1_000_000.0 / max(r.count, 1e-9)))
            max_queue_us[i] = r.max_queueing_time_ms * 1000
        if r.control_behavior in (C.CONTROL_BEHAVIOR_WARM_UP, C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER):
            cnt = max(r.count, 1e-9)
            wp, cold = r.warm_up_period_sec, C.COLD_FACTOR
            wt = (wp * cnt) / (cold - 1)
            mt = wt + 2.0 * wp * cnt / (1 + cold)
            warning_token[i] = wt
            max_token[i] = mt
            slope[i] = (cold - 1.0) / cnt / max(mt - wt, 1e-9)
        if row >= 0:
            by_row.setdefault(row, []).append(i)

    k = max(min_slots, max((len(v) for v in by_row.values()), default=1))
    rules_by_row = np.full((num_rows, k), -1, np.int32)
    for row, ids in by_row.items():
        rules_by_row[row, : len(ids)] = ids

    t = lambda a: torch.as_tensor(a, device=device)
    return FlowRuleTensors(
        resource_row=t(res_row),
        sync_row=t(sync_row),
        grade=t(grade),
        threshold=t(threshold),
        strategy=t(strategy),
        limit_origin=t(limit_origin),
        ref_row=t(ref_row),
        ref_context=t(ref_context),
        behavior=t(behavior),
        max_queue_us=t(max_queue_us),
        cost_us=t(cost_us),
        warning_token=t(warning_token),
        max_token=t(max_token),
        slope=t(slope),
        cluster_mode=t(cluster_mode),
        remote_mode=t(remote_mode),
        dcn_mode=t(dcn_mode),
        rules_by_row=t(rules_by_row),
    ), named_origins


class FlowRuleManager(RuleManager):
    """Registry of flow rules; wholesale swap semantics."""

    def has_origin_rules(self) -> bool:
        with self._lock:
            return any(r.limit_app != C.LIMIT_APP_DEFAULT for r in self._rules)


# ---------------------------------------------------------------------------
# Vectorized checker (device side)
# ---------------------------------------------------------------------------


class FlowVerdict(NamedTuple):
    blocked: torch.Tensor   # bool[N]
    wait_us: torch.Tensor   # int64[N] sleep-then-pass (rate limiter / occupy)
    occupied: torch.Tensor  # bool[N] prioritized grant borrowing the next bucket
    occ_add: torch.Tensor   # int32[R] borrow counts granted this step, per row
    state: FlowState
    slot: torch.Tensor      # int32[N] first-blocking rule slot (-1 = not blocked)


def _sync_warmup(rt: FlowRuleTensors, fs: FlowState,
                 prev_bucket_pass: torch.Tensor, now_ms: int) -> FlowState:
    """Vectorized ``WarmUpController.syncToken`` over all rules, 1 Hz/rule."""
    now_sec = (int(now_ms) // 1000) * 1000
    due = fs.last_filled_ms < now_sec
    is_warm = (rt.behavior == C.CONTROL_BEHAVIOR_WARM_UP) | (
        rt.behavior == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
    active = due & is_warm & (rt.resource_row >= 0)

    elapsed_s = (now_sec - fs.last_filled_ms).to(torch.float32) / 1000.0
    refill = fma32(elapsed_s, rt.threshold, fs.stored_tokens)
    below = fs.stored_tokens < rt.warning_token
    above = fs.stored_tokens > rt.warning_token
    low_qps = prev_bucket_pass < (rt.threshold / C.COLD_FACTOR)
    new_tokens = torch.where(below | (above & low_qps), refill, fs.stored_tokens)
    new_tokens = torch.minimum(new_tokens, rt.max_token)
    new_tokens = torch.clamp(new_tokens - prev_bucket_pass, min=0.0)

    return fs._replace(
        stored_tokens=torch.where(active, new_tokens, fs.stored_tokens),
        last_filled_ms=torch.where(active, now_sec, fs.last_filled_ms),
    )


def _pod_extra(extra, extra_global, dcn, sel_row) -> torch.Tensor:
    """float32[N]: the pod extra at each lane's selected row; the
    cross-slice one where the rule has scope="global" and it is given."""
    out = gather(extra, sel_row, 0).to(torch.float32)
    if extra_global is not None:
        out = torch.where(dcn, gather(extra_global, sel_row, 0)
                          .to(torch.float32), out)
    return out


def check_flow(
    rt: FlowRuleTensors,
    fs: FlowState,
    w1: W.Window,
    cur_threads: torch.Tensor,  # int32[R]
    batch: EntryBatch,
    now_ms: int,
    already_blocked: torch.Tensor,  # bool[N] blocked by an earlier slot
    occupied_next: Optional[torch.Tensor] = None,  # int32[R] next-bucket borrows
    spec: Optional[W.WindowSpec] = None,
    occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
    extra_pass: Optional[torch.Tensor] = None,  # [R] other shards' passes
    extra_next: Optional[torch.Tensor] = None,  # [R] other shards' next use
    extra_pass_global: Optional[torch.Tensor] = None,  # [R] cross-slice
    extra_next_global: Optional[torch.Tensor] = None,  # [R] cross-slice
) -> FlowVerdict:
    """Vectorized ``FlowRuleChecker.checkFlow`` over the micro-batch.

    Survivors resolve through ``ops/fixpoint.py`` (two passes for uniform
    acquire counts, the capped fixpoint loop for mixed ones); a final
    sweep gives verdicts, waits and occupy grants, then the leaky-bucket
    heads advance. Returns new state tensors; ``fs`` is not modified.
    The ``extra_*`` inputs are the pod's (module docstring).
    """
    if spec is None:
        spec = W.WindowSpec(C.SECOND_WINDOW_MS, C.SECOND_BUCKETS)
    candidate = (~already_blocked) & (batch.cluster_row >= 0)

    # Warm-up token sync against the node each rule admits on (sync_row).
    prev_idx = (W.current_index(now_ms, spec) - 1) % spec.buckets
    prev_pass_all = w1.counts[prev_idx, C.MetricEvent.PASS, :]
    rule_prev_pass = gather(prev_pass_all, rt.sync_row, 0).to(torch.float32)
    fs = _sync_warmup(rt, fs, rule_prev_pass, now_ms)

    pod = dict(extra_pass=extra_pass, extra_next=extra_next,
               extra_pass_global=extra_pass_global,
               extra_next_global=extra_next_global)

    def _blocked_for(survivors):
        return _eval_flow_slots(
            rt, fs, w1, cur_threads, batch, now_ms, candidate,
            survivors=survivors, occupied_next=occupied_next, spec=spec,
            occupy_timeout_ms=occupy_timeout_ms, **pod)[0]

    survivors = FX.survivor_fixpoint(candidate, _blocked_for, batch.count)

    (blocked, wait_us, consumed, rl_cmax, occupied, occ_add,
     first_slot) = _eval_flow_slots(
        rt, fs, w1, cur_threads, batch, now_ms, candidate,
        survivors=survivors, occupied_next=occupied_next, spec=spec,
        occupy_timeout_ms=occupy_timeout_ms, **pod)

    # Advance leaky buckets: latest' = max(latest, now - acquire·cost)
    # + consumed·cost.
    now_us = int(now_ms) * 1000
    new_latest = (torch.maximum(fs.latest_passed_us,
                                now_us - rt.cost_us * rl_cmax.clamp(min=1))
                  + consumed * rt.cost_us)
    fs = fs._replace(latest_passed_us=torch.where(
        consumed > 0, new_latest, fs.latest_passed_us))
    return FlowVerdict(blocked=blocked, wait_us=wait_us, occupied=occupied,
                       occ_add=occ_add, state=fs, slot=first_slot)


def _eval_flow_slots(
    rt: FlowRuleTensors,
    fs: FlowState,
    w1: W.Window,
    cur_threads: torch.Tensor,
    batch: EntryBatch,
    now_ms: int,
    candidate: torch.Tensor,
    survivors: Optional[torch.Tensor] = None,
    occupied_next: Optional[torch.Tensor] = None,
    spec: Optional[W.WindowSpec] = None,
    occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
    extra_pass: Optional[torch.Tensor] = None,
    extra_next: Optional[torch.Tensor] = None,
    extra_pass_global: Optional[torch.Tensor] = None,
    extra_next_global: Optional[torch.Tensor] = None,
):
    """One vectorized sweep over all rule slots. ``survivors`` (defaults
    to ``candidate``) selects which requests count toward within-batch
    prefixes. Pure: reads its inputs, returns new tensors."""
    n = batch.size
    dev = batch.cluster_row.device
    if survivors is None:
        survivors = candidate
    token_count = torch.where(survivors, batch.count, 0)
    entry_count = torch.where(survivors, 1, 0).to(token_count.dtype)

    # Within-batch arrival-order prefixes over the three row spaces each
    # request commits PASS to: one kernel launch on CUDA.
    vals2 = torch.stack([token_count, entry_count], dim=1).to(torch.float32)
    cols = [p for p, _ in segmented_prefix_dense_multi(
        [(rows, vals2)
         for rows in (batch.cluster_row, batch.dn_row, batch.origin_row)])]
    tok3 = torch.stack([c[:, 0] for c in cols], dim=1)  # (cluster, dn, origin)
    ent3 = torch.stack([c[:, 1] for c in cols], dim=1)

    num_rows = w1.num_rows
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    wait_us = torch.zeros((n,), dtype=torch.int64, device=dev)
    occupied = torch.zeros((n,), dtype=torch.bool, device=dev)
    occ_add = torch.zeros((num_rows,), dtype=torch.int32, device=dev)
    consumed = torch.zeros((rt.num_rules,), dtype=torch.int64, device=dev)
    rl_cmax = torch.zeros((rt.num_rules,), dtype=torch.int64, device=dev)

    if spec is None:
        spec = W.WindowSpec(C.SECOND_WINDOW_MS, C.SECOND_BUCKETS)
    cur_idx = W.current_index(now_ms, spec)
    oldest_idx = (cur_idx + 1) % spec.buckets
    oldest_pass_all = w1.counts[oldest_idx, C.MetricEvent.PASS, :]  # [R]
    now_ms = int(now_ms)
    occ_wait_us = (spec.bucket_ms - now_ms % spec.bucket_ms) * 1000
    now_us = now_ms * 1000
    # float32-rounded per-second normalization (1.0 at the default 1s).
    qps_scale = float(torch.tensor(1000.0 / spec.interval_ms,
                                   dtype=torch.float32))

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = rule_id >= 0
        g = lambda a, fill=0: gather(a, rule_id, fill)

        strat = g(rt.strategy)
        lim_o = g(rt.limit_origin, C.ORIGIN_ID_DEFAULT)
        behavior = g(rt.behavior)
        grade = g(rt.grade)
        thr = g(rt.threshold, 0.0)

        # --- node selection (selectNodeByRequesterAndStrategy)
        has_origin = batch.origin_id >= 0
        direct = strat == C.FLOW_STRATEGY_DIRECT
        sel_specific = direct & (lim_o >= 0) & (batch.origin_id == lim_o)
        sel_default = direct & (lim_o == C.ORIGIN_ID_DEFAULT)
        sel_other = (direct & (lim_o == C.ORIGIN_ID_OTHER) & has_origin
                     & (~batch.origin_named))
        relate = strat == C.FLOW_STRATEGY_RELATE
        chain = (strat == C.FLOW_STRATEGY_CHAIN) & (
            batch.context_id == g(rt.ref_context, -1))

        # A request granted an occupy borrow by an earlier slot has left
        # the chain; later slots never see it.
        applicable = (has_rule & candidate & (~occupied)
                      & (sel_specific | sel_default | sel_other | relate | chain))
        applicable = applicable & ~(g(rt.remote_mode, False) & batch.skip_cluster)
        sel_row = torch.where(sel_default, batch.cluster_row, -1)
        sel_row = torch.where(sel_specific | sel_other, batch.origin_row, sel_row)
        sel_row = torch.where(relate, g(rt.ref_row, -1), sel_row)
        sel_row = torch.where(chain, batch.dn_row, sel_row)
        applicable = applicable & (sel_row >= 0)

        # cluster=[:,0], dn=[:,1], origin=[:,2]; RELATE rows get no
        # within-batch credit (cross-resource, bounded by one micro-batch).
        def _sel(prefixes):
            p = torch.where(sel_default, prefixes[:, 0], 0.0)
            p = torch.where(sel_specific | sel_other, prefixes[:, 2], p)
            return torch.where(chain, prefixes[:, 1], p)

        tok_prefix = _sel(tok3)
        ent_prefix = _sel(ent3)

        # --- current usage of the selected node
        totals = W.row_totals(w1, sel_row)  # [N, E]
        pass_1s = totals[:, C.MetricEvent.PASS].to(torch.float32)
        used_qps = pass_1s + tok_prefix
        if extra_pass is not None:
            # Cluster-mode rules admit against the pod-global window, and
            # scope="global" rules against the cross-slice one; the extra
            # joins before the per-second scale, as in the reference.
            extra = _pod_extra(extra_pass, extra_pass_global,
                               g(rt.dcn_mode, False), sel_row)
            used_qps = used_qps + torch.where(g(rt.cluster_mode, False),
                                              extra, 0.0)
        used_qps = used_qps * qps_scale
        used_thr = gather(cur_threads, sel_row, 0).to(torch.float32) + ent_prefix
        used = torch.where(grade == C.FLOW_GRADE_QPS, used_qps, used_thr)
        acq = torch.where(grade == C.FLOW_GRADE_QPS, batch.count, 1).to(
            torch.float32)

        # --- DefaultController
        dflt_ok = used + acq <= thr

        # --- WarmUpController admission (tokens already synced)
        stored = g(fs.stored_tokens, 0.0)
        wtok = g(rt.warning_token, 0.0)
        above_warn = stored >= wtok
        inv_thr = 1.0 / torch.clamp(thr, min=1e-9)
        if batch.size == 1:
            # Follows the compiler of the JAX oracle, not a rule of the
            # reference: XLA's CPU backend contracts this multiply-add at
            # every ladder width but 1, where it rounds twice (checked at
            # 1, 8, 64, 512 and 2048 in tests/test_torch_models.py).
            # Whether XLA's TPU backend contracts it at width 1 is not
            # known.
            warning_qps = 1.0 / ((stored - wtok) * g(rt.slope, 0.0) + inv_thr)
        else:
            warning_qps = 1.0 / fma32(stored - wtok, g(rt.slope, 0.0),
                                      inv_thr)
        warm_thr = torch.where(above_warn, warning_qps, thr)
        warm_ok = used + acq <= warm_thr

        # --- RateLimiterController: leaky-bucket wait; only survivors
        # reserve bucket slots in the within-batch prefix.
        cost = g(rt.cost_us, 0)
        is_rl = (behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER) | (
            behavior == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER)
        any_rl = host_bool((applicable & is_rl).any(),
                           "sync.flow.rate_limiter")
        if any_rl:
            rl_prefix = segmented_prefix_dense(
                torch.where(applicable & is_rl, rule_id, -1),
                torch.where(applicable & survivors, batch.count, 0)
                .to(torch.float32))[0]
        else:
            rl_prefix = torch.zeros((n,), dtype=torch.float32, device=dev)
        # Idle clamp: the whole multi-token acquire is free after idle.
        latest = torch.maximum(g(fs.latest_passed_us, 0),
                               now_us - cost * batch.count)
        expected = latest + (rl_prefix + batch.count).to(torch.int64) * cost
        rl_wait = torch.clamp(expected - now_us, min=0)
        rl_ok = rl_wait <= g(rt.max_queue_us, 0)

        ok = torch.where(behavior == C.CONTROL_BEHAVIOR_DEFAULT, dflt_ok, True)
        ok = torch.where(behavior == C.CONTROL_BEHAVIOR_WARM_UP, warm_ok, ok)
        ok = torch.where(behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER, rl_ok, ok)
        ok = torch.where(behavior == C.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER,
                         warm_ok & rl_ok, ok)

        slot_blocked = applicable & (~ok)

        # --- prioritized occupy-next-window (tryOccupyNext): a prioritized
        # QPS request rejected by the DEFAULT controller may borrow from
        # the next bucket if the next window has room and the wait fits
        # the occupy timeout. Only requests no earlier slot rejected.
        occ_cand = (slot_blocked & (~blocked) & batch.prioritized
                    & (grade == C.FLOW_GRADE_QPS)
                    & (behavior == C.CONTROL_BEHAVIOR_DEFAULT))
        if occupied_next is not None and host_bool(occ_cand.any(),
                                                   "sync.flow.occupy"):
            occ_prefix, _ = segmented_prefix_dense(
                torch.where(occ_cand, sel_row, -1),
                torch.where(occ_cand & survivors, batch.count, 0)
                .to(torch.float32))
            next_used = (
                pass_1s
                - gather(oldest_pass_all, sel_row, 0).to(torch.float32)
                + gather(occupied_next, sel_row, 0).to(torch.float32)
                + occ_prefix)
            if extra_next is not None:
                # Cluster-mode rules borrow against the pod-global next
                # window, or every shard would lend up to the threshold.
                extra = _pod_extra(extra_next, extra_next_global,
                                   g(rt.dcn_mode, False), sel_row)
                next_used = next_used + torch.where(
                    g(rt.cluster_mode, False), extra, 0.0)
            grant = occ_cand & (next_used * qps_scale + acq <= thr) & (
                occ_wait_us <= occupy_timeout_ms * 1000)
            occupied = occupied | grant
            wait_us = torch.maximum(wait_us, torch.where(grant, occ_wait_us, 0))
            slot_blocked = slot_blocked & (~grant)
            add_at(occ_add, (sel_row,), torch.where(grant, batch.count, 0),
                   in_range(sel_row, num_rows))

        first_slot = torch.where(slot_blocked & (~blocked), k, first_slot)
        blocked = blocked | slot_blocked

        # Bucket tokens are consumed only by requests that survive every
        # slot.
        admitted_rl = applicable & is_rl & ok & survivors
        wait_us = torch.maximum(wait_us, torch.where(admitted_rl, rl_wait, 0))
        if any_rl:
            admitted_counts = torch.where(admitted_rl, batch.count, 0).to(
                torch.int64)
            r_ok = in_range(rule_id, rt.num_rules)
            add_at(consumed, (rule_id,), admitted_counts, r_ok)
            max_at(rl_cmax, (rule_id,), admitted_counts, r_ok)

    return blocked, wait_us, consumed, rl_cmax, occupied, occ_add, first_slot
