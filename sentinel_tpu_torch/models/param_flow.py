"""Hot-parameter flow rules: per-argument-value token buckets (port of
``sentinel_tpu/models/param_flow.py``).

Two tiers, as in the JAX package:

  * **Hot tier — exact.** Each rule owns a direct-mapped slot table
    (``slot = hash(value) % S``) holding exact bucket state (owner key,
    tokens, refill time, leaky-bucket head, thread gauge).
  * **Cold tier — count-min sketch.** A per-rule ``[D, W]`` CMS counts
    every admitted acquire in the current duration window; a key that
    does not own its slot admits against ``max_count − CMS estimate``
    (one-sided: cold keys can only be under-admitted).
  * **Promotion.** An admitted non-owner takes the slot only when its
    decayed-sketch count has caught up with the owner's.

uint32 arithmetic. The value hashes are uint32 in JAX and rely on
wrap-around (``(h · A_d) >> 16 mod W`` and ``h % S``). Here they are
int64 tensors holding the same value; products are formed from 16-bit
halves so no intermediate leaves int64, and reduced with
``& 0xFFFFFFFF``.

Duplicate-index scatter-*set* (owner key, token level): the winner is the
last lane by position (``ops/window.py:set_at``), XLA's CPU order.

Device state is updated IN PLACE by the commit pass of
:func:`check_param_flow` and by :func:`feed_param_exit` (the JAX state is
donated; callers must not reuse the input state).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import EntryBatch, ExitBatch, MAX_PARAMS
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.ops import fixpoint as FX
from sentinel_tpu_torch.ops.segment import segmented_prefix_dense
from sentinel_tpu_torch.ops.window import (
    add_at, gather, in_range, max_at, set_at)
from sentinel_tpu_torch.utils.device import host_bool, resolve_device
from sentinel_tpu_torch.utils.fp import fma32
from sentinel_tpu_torch.utils.shapes import round_up as _round_up

DEFAULT_SLOTS = 2048  # per-rule bucket table width
MAX_ITEMS = 8         # per-rule exact-value exception slots

CMS_DEPTH = 4
CMS_WIDTH = 2048
_CMS_MULT = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_U32 = 0xFFFFFFFF


def _cms_positions(pv_hash: torch.Tensor) -> torch.Tensor:
    """[N] uint32 value hashes (held in int64) -> [N, D] int32 sketch
    columns ``((h · A_d mod 2^32) >> 16) mod W``."""
    h = pv_hash.to(torch.int64) & _U32
    a = torch.tensor(_CMS_MULT, dtype=torch.int64, device=h.device)[None, :]
    lo = (h & 0xFFFF)[:, None]
    hi = (h >> 16)[:, None]
    # h·A mod 2^32 = (lo·A + ((hi·A) mod 2^16) << 16) mod 2^32; every
    # partial product is below 2^48.
    prod = (lo * a + (((hi * a) & 0xFFFF) << 16)) & _U32
    return ((prod >> 16) % CMS_WIDTH).to(torch.int32)


@dataclass
class ParamFlowItem:
    """Per-value threshold exception (reference: ``ParamFlowItem``)."""

    object: object
    count: float


@dataclass
class ParamFlowRule:
    resource: str
    param_idx: int
    count: float
    grade: int = C.PARAM_FLOW_GRADE_QPS
    duration_in_sec: int = 1
    burst_count: int = 0
    control_behavior: int = C.CONTROL_BEHAVIOR_DEFAULT
    max_queueing_time_ms: int = 0
    items: List[ParamFlowItem] = field(default_factory=list)
    cluster_mode: bool = False
    cluster_config: Optional[dict] = None
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0 or self.duration_in_sec <= 0:
            return False
        if self.burst_count < 0 or self.max_queueing_time_ms < 0:
            return False
        if not (0 <= self.param_idx < MAX_PARAMS):
            return False
        if self.grade not in (C.PARAM_FLOW_GRADE_QPS, C.PARAM_FLOW_GRADE_THREAD):
            return False
        if self.control_behavior not in (
            C.CONTROL_BEHAVIOR_DEFAULT, C.CONTROL_BEHAVIOR_RATE_LIMITER
        ):
            return False
        return True


class ParamRuleTensors(NamedTuple):
    resource_row: torch.Tensor  # int32[PR]
    param_idx: torch.Tensor     # int32[PR]
    grade: torch.Tensor         # int32[PR]
    threshold: torch.Tensor     # float32[PR]
    duration_ms: torch.Tensor   # int64[PR]
    burst: torch.Tensor         # float32[PR]
    behavior: torch.Tensor      # int32[PR]
    max_queue_us: torch.Tensor  # int64[PR]
    item_hash: torch.Tensor     # int64[PR, MAX_ITEMS] uint32 values, 0 = empty
    item_count: torch.Tensor    # float32[PR, MAX_ITEMS]
    cluster_mode: torch.Tensor  # bool[PR]
    remote_mode: torch.Tensor   # bool[PR] cluster rule with a flowId
    rules_by_row: torch.Tensor  # int32[R, K]

    @property
    def num_rules(self) -> int:
        return self.resource_row.shape[0]

    @property
    def slots(self) -> int:
        return self.rules_by_row.shape[1]


class ParamFlowState(NamedTuple):
    """Per-(rule, hash-slot) bucket table + cold-tier CMS."""

    key: torch.Tensor        # int64[PR, S] owner param hash (uint32), 0 = empty
    tokens: torch.Tensor     # float32[PR, S] remaining tokens (QPS/default)
    filled_ms: torch.Tensor  # int64[PR, S] last refill time
    passed_us: torch.Tensor  # int64[PR, S] throttle-mode leaky-bucket head
    threads: torch.Tensor    # int32[PR, S] concurrency gauge (THREAD grade)
    cms: torch.Tensor        # float32[PR, D, W] this-window acquire sketch
    cms_hot: torch.Tensor    # float32[PR, D, W] decayed hotness sketch
    cms_start: torch.Tensor  # int64[PR] sketch window start


def make_param_state(num_rules: int, table_slots: int = DEFAULT_SLOTS,
                     device=None) -> ParamFlowState:
    device = resolve_device(device)
    pr, s = num_rules, table_slots
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return ParamFlowState(
        key=z((pr, s), torch.int64),
        tokens=z((pr, s), torch.float32),
        filled_ms=z((pr, s), torch.int64),
        passed_us=z((pr, s), torch.int64),
        threads=z((pr, s), torch.int32),
        cms=z((pr, CMS_DEPTH, CMS_WIDTH), torch.float32),
        cms_hot=z((pr, CMS_DEPTH, CMS_WIDTH), torch.float32),
        cms_start=z((pr,), torch.int64),
    )


def compile_param_rules(
    rules: List["ParamFlowRule"],
    registry: NodeRegistry,
    num_rows: int,
    hash_fn=None,
    min_slots: int = 0,
    device=None,
) -> ParamRuleTensors:
    from sentinel_tpu_torch.utils.param_hash import hash_param

    device = resolve_device(device)
    hash_fn = hash_fn or hash_param
    valid = [r for r in rules if r.is_valid()]
    pr = _round_up(len(valid), 8)
    res_row = np.full(pr, -1, np.int32)
    param_idx = np.zeros(pr, np.int32)
    grade = np.zeros(pr, np.int32)
    threshold = np.zeros(pr, np.float32)
    duration_ms = np.full(pr, 1000, np.int64)
    burst = np.zeros(pr, np.float32)
    behavior = np.zeros(pr, np.int32)
    max_queue_us = np.zeros(pr, np.int64)
    item_hash = np.zeros((pr, MAX_ITEMS), np.int64)
    item_count = np.zeros((pr, MAX_ITEMS), np.float32)
    cluster_mode = np.zeros(pr, bool)
    remote_mode = np.zeros(pr, bool)
    by_row: Dict[int, List[int]] = {}

    for i, r in enumerate(valid):
        row = registry.cluster_row(r.resource)
        res_row[i] = row
        param_idx[i] = r.param_idx
        grade[i] = r.grade
        threshold[i] = r.count
        duration_ms[i] = r.duration_in_sec * 1000
        burst[i] = r.burst_count
        behavior[i] = r.control_behavior
        max_queue_us[i] = r.max_queueing_time_ms * 1000
        cluster_mode[i] = r.cluster_mode
        remote_mode[i] = (r.cluster_mode
                          and (r.cluster_config or {}).get("flowId") is not None)
        for j, item in enumerate(r.items[:MAX_ITEMS]):
            item_hash[i, j] = hash_fn(item.object) & _U32
            item_count[i, j] = item.count
        if row >= 0:
            by_row.setdefault(row, []).append(i)

    k = max(min_slots, max((len(v) for v in by_row.values()), default=0))
    rules_by_row = np.full((num_rows, k), -1, np.int32)
    for row, ids in by_row.items():
        rules_by_row[row, : len(ids)] = ids

    t = lambda a: torch.as_tensor(a, device=device)
    return ParamRuleTensors(
        resource_row=t(res_row),
        param_idx=t(param_idx),
        grade=t(grade),
        threshold=t(threshold),
        duration_ms=t(duration_ms),
        burst=t(burst),
        behavior=t(behavior),
        max_queue_us=t(max_queue_us),
        item_hash=t(item_hash),
        item_count=t(item_count),
        cluster_mode=t(cluster_mode),
        remote_mode=t(remote_mode),
        rules_by_row=t(rules_by_row),
    )


class ParamFlowRuleManager(RuleManager):
    """Wholesale-swap registry (reference: ``ParamFlowRuleManager``).

    Gateway-derived rules live in a separate partition so a user
    ``load_rules`` and a ``GatewayRuleManager.load_rules`` can't clobber
    each other; checkers see the union via ``get_rules``: user rules
    first, then gateway rules, which fixes the rule slots.
    """

    def __init__(self):
        super().__init__()
        self._gateway_rules: List[ParamFlowRule] = []

    def load_gateway_rules(self, rules: List[ParamFlowRule]) -> None:
        with self._lock:
            self._gateway_rules = [r for r in rules if r.is_valid()]
            self.version += 1
            listeners = list(self._listeners)
        for fn in listeners:
            fn()

    def get_rules(self) -> List[ParamFlowRule]:
        with self._lock:
            return list(self._rules) + list(self._gateway_rules)


class ParamVerdict(NamedTuple):
    blocked: torch.Tensor  # bool[N]
    wait_us: torch.Tensor  # int64[N] throttle-mode sleep-then-pass
    state: ParamFlowState
    slot: torch.Tensor     # int32[N] first-blocking rule slot (-1 = not blocked)


def _gather2(arr, r, s, fill):
    ok = in_range(r, arr.shape[0])
    return torch.where(ok, arr[torch.where(ok, r, 0), s], fill)


def _cms_min(cms: torch.Tensor, srule: torch.Tensor, pos: torch.Tensor,
             extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """min over depth of ``cms[rule, d, pos[:, d]]`` (the CMS estimate);
    ``srule`` < 0 reads row 0 and is masked to 0. ``extra`` (the pod's
    other shards' sketch) is added cell by cell before the min: the
    reference's ``_cms_min(cms + extra_cms, ...)``, reading only the
    gathered cells."""
    d = cms.shape[1]
    ok = in_range(srule, cms.shape[0])
    r = torch.where(ok, srule, 0)
    darange = torch.arange(d, device=cms.device)[None, :]
    vals = cms[r[:, None], darange, pos[:, :d]]  # [N, d]
    if extra is not None:
        vals = vals + extra[r[:, None], darange, pos[:, :d]]
    return torch.where(ok, vals.min(dim=1).values, 0.0)


def check_param_flow(
    rt: ParamRuleTensors,
    ps: ParamFlowState,
    batch: EntryBatch,
    now_ms: int,
    candidate: torch.Tensor,  # bool[N]
    extra_cms: Optional[torch.Tensor] = None,  # f32[PR, D, W] other shards'
) -> ParamVerdict:
    """Vectorized ``ParamFlowChecker.passLocalCheck`` over the micro-batch:
    survivor resolution (ops/fixpoint.py), then one commit pass that
    updates ``ps`` in place.

    ``extra_cms`` (the pod path): the sum of the other shards' sketches.
    Cluster-mode param rules admit every value, the hot owner included,
    against the pod-global estimate (local + others'); local rules ignore
    it."""
    ps = roll_sketch_windows(rt, ps, now_ms)

    def _blocked_for(survivors):
        return _eval_param(rt, ps, batch, now_ms, candidate,
                           survivors=survivors, commit=False,
                           extra_cms=extra_cms).blocked

    survivors = FX.survivor_fixpoint(candidate, _blocked_for, batch.count)
    return _eval_param(rt, ps, batch, now_ms, candidate,
                       survivors=survivors, commit=True, extra_cms=extra_cms)


def roll_sketch_windows(rt: ParamRuleTensors, ps: ParamFlowState,
                        now_ms: int, lazy: bool = True) -> ParamFlowState:
    """Per-rule sketch window roll, IN PLACE: the admission sketch
    hard-resets each window, the promotion sketch halves per elapsed
    window. Idempotent within a window. ``lazy`` runs it only when some
    active rule's window rolled (JAX: ``lax.cond``; here one counted
    sync); the pod's roll before its reduction passes ``lazy=False`` and
    applies the masks unconditionally, which reads nothing back and
    leaves every unrolled cell as it was (a fill under a false mask, a
    multiply by 1.0)."""
    dur = rt.duration_ms.clamp(min=1)
    now = int(now_ms)
    win_start = now - now % dur
    elapsed = torch.clamp((win_start - ps.cms_start) // dur, 0, 30)
    rolled = (elapsed > 0) & (rt.resource_row >= 0)
    if lazy and not host_bool(rolled.any(), "sync.param.roll"):
        return ps
    factor = torch.exp2(-elapsed.to(torch.float32))
    ps.cms.masked_fill_(rolled[:, None, None], 0.0)
    ps.cms_hot.mul_(factor[:, None, None])
    ps.cms_start.copy_(torch.where(rolled, win_start, ps.cms_start))
    return ps


def _eval_param(
    rt: ParamRuleTensors,
    ps: ParamFlowState,
    batch: EntryBatch,
    now_ms: int,
    candidate: torch.Tensor,
    survivors: torch.Tensor,
    commit: bool,
    extra_cms: Optional[torch.Tensor] = None,
) -> ParamVerdict:
    n = batch.size
    dev = batch.cluster_row.device
    table_slots = ps.key.shape[1]
    n_rules = ps.key.shape[0]

    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    wait_us = torch.zeros((n,), dtype=torch.int64, device=dev)
    now_us = int(now_ms) * 1000

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = rule_id >= 0
        g = lambda a, fill=0: gather(a, rule_id, fill)

        pidx = g(rt.param_idx).to(torch.int64)
        pv_hash = torch.gather(batch.param_hash, 1, pidx[:, None])[:, 0]
        pv_present = torch.gather(batch.param_present, 1, pidx[:, None])[:, 0]
        applicable = has_rule & candidate & pv_present
        applicable = applicable & ~(g(rt.remote_mode, False) & batch.skip_cluster)

        # Per-value exception items (exact hash match) override the count.
        items_h = gather(rt.item_hash, rule_id, 0)          # [N, MAX_ITEMS]
        items_c = gather(rt.item_count, rule_id, 0.0)
        item_match = (items_h == pv_hash[:, None]) & (items_h != 0)
        has_item = item_match.any(dim=1)
        item_thr = torch.where(item_match, items_c, -1.0).max(dim=1).values
        thr = torch.where(has_item, item_thr, g(rt.threshold, 0.0))

        slot = (pv_hash % table_slots).to(torch.int32)
        srule = torch.where(applicable, rule_id, -1)
        stored_key = _gather2(ps.key, srule, slot, 0)
        fresh = stored_key != pv_hash  # empty or evicted -> full bucket

        grade = g(rt.grade)
        behavior = g(rt.behavior)
        dur_ms = g(rt.duration_ms, 1000).to(torch.int64)
        max_count = thr + g(rt.burst, 0.0)

        # Group identity for within-batch sequencing: same (rule, slot).
        gid = torch.where(applicable, rule_id * table_slots + slot, -1)
        acq = torch.where(survivors & applicable, batch.count, 0)
        pre2, _ = segmented_prefix_dense(
            gid,
            torch.stack([acq, torch.where(survivors & applicable, 1, 0)
                         .to(acq.dtype)], dim=1).to(torch.float32),
        )
        tok_prefix, ent_prefix = pre2[:, 0], pre2[:, 1]

        # --- QPS / DEFAULT: windowed token bucket
        stored_tokens = _gather2(ps.tokens, srule, slot, 0.0)
        filled = _gather2(ps.filled_ms, srule, slot, 0)
        windows = torch.clamp((now_ms - filled) // dur_ms.clamp(min=1), min=0)
        refilled = torch.minimum(
            fma32(windows.to(torch.float32), thr, stored_tokens), max_count)
        pos = _cms_positions(pv_hash)                    # [N, D]
        est = _cms_min(ps.cms, srule, pos)               # [N]
        avail = torch.where(fresh, torch.clamp(max_count - est, min=0.0),
                            refilled)
        if extra_cms is not None:
            est_pod = _cms_min(ps.cms, srule, pos, extra=extra_cms)
            avail = torch.where(g(rt.cluster_mode, False),
                                torch.clamp(max_count - est_pod, min=0.0),
                                avail)
        acqf = batch.count.to(torch.float32)
        qps_ok = (thr > 0) & (tok_prefix + acqf <= avail)

        # --- THREAD: concurrency gauge per value
        gauge = _gather2(ps.threads, srule, slot, 0)
        gauge = torch.where(fresh, 0, gauge)
        thread_ok = (thr > 0) & (
            gauge.to(torch.float32) + ent_prefix + 1.0 <= thr)

        # --- RATE_LIMITER: per-value leaky bucket, cost = duration / thr
        cost_us = torch.where(
            thr > 0,
            dur_ms.to(torch.float32) * 1000.0 / torch.clamp(thr, min=1e-9),
            1e18,
        ).to(torch.int64)
        head0 = _gather2(ps.passed_us, srule, slot, 0)
        head0 = torch.where(fresh, 0, head0)
        latest = torch.maximum(head0,
                               now_us - cost_us * batch.count.to(torch.int64))
        expected = latest + (tok_prefix + batch.count).to(torch.int64) * cost_us
        rl_wait = torch.clamp(expected - now_us, min=0)
        rl_ok = (thr > 0) & (rl_wait <= g(rt.max_queue_us, 0))

        is_thread = grade == C.PARAM_FLOW_GRADE_THREAD
        is_rl = (~is_thread) & (behavior == C.CONTROL_BEHAVIOR_RATE_LIMITER)
        ok = torch.where(is_thread, thread_ok, torch.where(is_rl, rl_ok, qps_ok))

        slot_blocked = applicable & (~ok)
        first_slot = torch.where(slot_blocked & (~blocked), k, first_slot)
        blocked = blocked | slot_blocked
        admitted = applicable & ok & survivors
        wait_us = torch.maximum(wait_us,
                                torch.where(admitted & is_rl, rl_wait, 0))

        if commit:
            dflt = applicable & (~is_thread) & (~is_rl)
            hot_est = _cms_min(ps.cms_hot, srule, pos)
            owner_est = _cms_min(ps.cms_hot, srule, _cms_positions(stored_key))
            promoted = (admitted & dflt & fresh
                        & ((stored_key == 0) | (hot_est + acqf >= owner_est)))
            claim_other = (admitted | (applicable & fresh)) & (is_thread | is_rl)
            claim = promoted | claim_other | (admitted & dflt & (~fresh))
            r_ok = in_range(srule, n_rules)
            set_at(ps.key, (srule, slot), pv_hash, claim & r_ok)
            need_stamp = dflt & (~fresh) & (windows >= 1)
            stamp = need_stamp | promoted | (claim_other & fresh)
            if host_bool(stamp.any(), "sync.param.stamp"):
                set_at(ps.filled_ms, (srule, slot), int(now_ms),
                       stamp & r_ok)
            touch = dflt & ((~fresh) | promoted)
            set_at(ps.tokens, (srule, slot), avail, touch & r_ok)
            add_at(ps.tokens, (srule, slot), -acqf, admitted & touch & r_ok)
            ps.tokens.clamp_(min=0.0)
            # Conservative CMS update: only cells at the current minimum
            # grow (reads happen before either sketch is written).
            cms_on = admitted & dflt & r_ok
            r0 = torch.where(srule >= 0, srule, 0)
            darange = torch.arange(CMS_DEPTH, device=dev)[None, :]
            depth_vals = ps.cms[r0[:, None], darange, pos]
            at_min = depth_vals <= depth_vals.min(dim=1, keepdim=True).values
            inc = torch.where(cms_on[:, None] & at_min, acqf[:, None], 0.0)
            cidx = r0[:, None].expand(n, CMS_DEPTH)
            didx = darange.expand(n, CMS_DEPTH)
            add_at(ps.cms, (cidx, didx, pos), inc,
                   cms_on[:, None].expand(n, CMS_DEPTH))
            hot_vals = ps.cms_hot[r0[:, None], darange, pos]
            hot_min = hot_vals <= hot_vals.min(dim=1, keepdim=True).values
            hot_inc = torch.where(cms_on[:, None] & hot_min, acqf[:, None], 0.0)
            add_at(ps.cms_hot, (cidx, didx, pos), hot_inc,
                   cms_on[:, None].expand(n, CMS_DEPTH))
            # Throttle-mode head advance: head' = latest + consumed · cost,
            # evicted slots first dropping their stale head.
            if host_bool((applicable & is_rl).any(),
                         "sync.param.rate_limiter"):
                set_at(ps.passed_us, (srule, slot), 0,
                       applicable & is_rl & fresh & r_ok)
                consumed_after, _ = segmented_prefix_dense(
                    gid, torch.where(admitted & is_rl, batch.count, 0)
                    .to(torch.float32))
                last_total = consumed_after + torch.where(
                    admitted & is_rl, batch.count, 0)
                new_head = latest + last_total.to(torch.int64) * cost_us
                max_at(ps.passed_us, (srule, slot), new_head,
                       admitted & is_rl & r_ok)
            # Thread gauge: reset evicted buckets, then increment admits.
            if host_bool((applicable & is_thread).any(),
                         "sync.param.thread"):
                set_at(ps.threads, (srule, slot), 0,
                       applicable & fresh & is_thread & r_ok)
                add_at(ps.threads, (srule, slot), 1,
                       admitted & is_thread & r_ok)

    return ParamVerdict(blocked=blocked, wait_us=wait_us, state=ps,
                        slot=first_slot)


def feed_param_exit(
    rt: ParamRuleTensors,
    ps: ParamFlowState,
    batch: ExitBatch,
) -> ParamFlowState:
    """Decrement THREAD-grade gauges on completion, IN PLACE."""
    table_slots = ps.key.shape[1]
    valid = batch.cluster_row >= 0

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = rule_id >= 0
        grade = gather(rt.grade, rule_id, 0)
        pidx = gather(rt.param_idx, rule_id, 0).to(torch.int64)
        pv_hash = torch.gather(batch.param_hash, 1, pidx[:, None])[:, 0]
        pv_present = torch.gather(batch.param_present, 1, pidx[:, None])[:, 0]
        slot = (pv_hash % table_slots).to(torch.int32)
        # Only decrement buckets this value still owns.
        stored_key = _gather2(ps.key, torch.where(has_rule, rule_id, -1),
                              slot, 0)
        dec = (valid & has_rule & pv_present
               & (grade == C.PARAM_FLOW_GRADE_THREAD) & (stored_key == pv_hash))
        if not host_bool(dec.any(), "sync.param.exit_thread"):
            continue
        add_at(ps.threads, (rule_id, slot), -1,
               dec & in_range(rule_id, ps.key.shape[0]))
        ps.threads.clamp_(min=0)
    return ps
