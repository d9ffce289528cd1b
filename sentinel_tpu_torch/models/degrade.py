"""Circuit breaking (degrade rules) as a vectorized state machine (port of
``sentinel_tpu/models/degrade.py``).

Every breaker is one row of ``state int32[DR]`` (CLOSED / OPEN /
HALF_OPEN), ``next_retry_ms int64[DR]`` and a ``[DR, 1, 3]``
:class:`~sentinel_tpu_torch.ops.window.RowWindow` (one tumbling
``statIntervalMs`` bucket with TOTAL / ERROR / SLOW channels). Entry:
CLOSED passes; OPEN passes one probe per rule (the batch's first arrival)
once ``next_retry_ms`` elapses and flips to HALF_OPEN; HALF_OPEN blocks.
Exit: completions feed the window; any bad HALF_OPEN completion re-opens,
a good one closes; CLOSED rules may trip OPEN.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import EntryBatch, ExitBatch
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.segment import first_in_segment
from sentinel_tpu_torch.ops.window import gather, in_range, set_at
from sentinel_tpu_torch.utils.device import host_bool, resolve_device
from sentinel_tpu_torch.utils.shapes import round_up as _round_up

# RowWindow channels
CH_TOTAL = 0
CH_ERROR = 1
CH_SLOW = 2
NUM_CH = 3

BREAKER_BUCKETS = 1  # tumbling statIntervalMs bucket (reference sampleCount=1)


@dataclass
class DegradeRule:
    resource: str
    count: float                      # RT grade: max rt (ms); else threshold
    grade: int = C.DEGRADE_GRADE_RT
    time_window: int = 0              # recovery timeout (seconds)
    slow_ratio_threshold: float = C.DEGRADE_DEFAULT_SLOW_RATIO_THRESHOLD
    min_request_amount: int = C.DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT
    stat_interval_ms: int = C.DEGRADE_DEFAULT_STAT_INTERVAL_MS
    limit_app: str = C.LIMIT_APP_DEFAULT
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None

    def is_valid(self) -> bool:
        if not self.resource or self.count < 0 or self.time_window < 0:
            return False
        if self.grade not in (C.DEGRADE_GRADE_RT, C.DEGRADE_GRADE_EXCEPTION_RATIO,
                              C.DEGRADE_GRADE_EXCEPTION_COUNT):
            return False
        if self.grade == C.DEGRADE_GRADE_EXCEPTION_RATIO and self.count > 1.0:
            return False
        if self.min_request_amount <= 0 or self.stat_interval_ms <= 0:
            return False
        return True


class DegradeRuleTensors(NamedTuple):
    resource_row: torch.Tensor    # int32[DR]
    grade: torch.Tensor           # int32[DR]
    threshold: torch.Tensor       # float32[DR] (max rt | ratio | count)
    slow_ratio: torch.Tensor      # float32[DR]
    min_request: torch.Tensor     # int32[DR]
    time_window_ms: torch.Tensor  # int64[DR]
    rules_by_row: torch.Tensor    # int32[R, K] degrade-rule ids per resource row

    @property
    def num_rules(self) -> int:
        return self.resource_row.shape[0]

    @property
    def slots(self) -> int:
        return self.rules_by_row.shape[1]


class DegradeState(NamedTuple):
    state: torch.Tensor          # int32[DR] BREAKER_*
    next_retry_ms: torch.Tensor  # int64[DR]
    win: W.RowWindow             # [DR, 1, 3] per-rule statIntervalMs window


def make_degrade_state(rt: DegradeRuleTensors, stat_interval_ms: np.ndarray
                       ) -> DegradeState:
    dr = rt.num_rules
    device = rt.resource_row.device
    return DegradeState(
        state=torch.zeros((dr,), dtype=torch.int32, device=device),
        next_retry_ms=torch.zeros((dr,), dtype=torch.int64, device=device),
        win=W.make_row_window(dr, BREAKER_BUCKETS, NUM_CH, stat_interval_ms,
                              device),
    )


def compile_degrade_rules(
    rules: List[DegradeRule], registry: NodeRegistry, num_rows: int,
    min_slots: int = 0, device=None,
) -> Tuple[DegradeRuleTensors, np.ndarray]:
    """Returns (tensors, per-rule statIntervalMs host array — the window
    geometry feeds state construction)."""
    device = resolve_device(device)
    valid = [r for r in rules if r.is_valid()]
    dr = _round_up(len(valid), 8)
    res_row = np.full(dr, -1, np.int32)
    grade = np.zeros(dr, np.int32)
    threshold = np.zeros(dr, np.float32)
    slow_ratio = np.ones(dr, np.float32)
    min_request = np.full(dr, C.DEGRADE_DEFAULT_MIN_REQUEST_AMOUNT, np.int32)
    time_window_ms = np.zeros(dr, np.int64)
    stat_interval = np.zeros(dr, np.int64)  # 0 => unused row
    by_row: Dict[int, List[int]] = {}

    for i, r in enumerate(valid):
        row = registry.cluster_row(r.resource)
        res_row[i] = row
        grade[i] = r.grade
        threshold[i] = r.count
        slow_ratio[i] = r.slow_ratio_threshold
        min_request[i] = r.min_request_amount
        time_window_ms[i] = r.time_window * 1000
        stat_interval[i] = r.stat_interval_ms
        if row >= 0:
            by_row.setdefault(row, []).append(i)

    k = max(min_slots, max((len(v) for v in by_row.values()), default=0))
    rules_by_row = np.full((num_rows, k), -1, np.int32)
    for row, ids in by_row.items():
        rules_by_row[row, : len(ids)] = ids

    t = lambda a: torch.as_tensor(a, device=device)
    return DegradeRuleTensors(
        resource_row=t(res_row),
        grade=t(grade),
        threshold=t(threshold),
        slow_ratio=t(slow_ratio),
        min_request=t(min_request),
        time_window_ms=t(time_window_ms),
        rules_by_row=t(rules_by_row),
    ), stat_interval


class DegradeRuleManager(RuleManager):
    """Wholesale-swap registry (reference: ``DegradeRuleManager``)."""


class DegradeVerdict(NamedTuple):
    blocked: torch.Tensor  # bool[N]
    state: DegradeState
    slot: torch.Tensor     # int32[N] first-blocking rule slot (-1 = not blocked)


def check_degrade(
    rt: DegradeRuleTensors,
    ds: DegradeState,
    batch: EntryBatch,
    now_ms: int,
    candidate: torch.Tensor,  # bool[N] not blocked by earlier slots
) -> DegradeVerdict:
    """Vectorized ``CircuitBreaker.tryPass`` over the micro-batch. The
    returned state holds a new ``state`` tensor; ``ds`` is not modified."""
    n = batch.size
    dev = batch.cluster_row.device
    blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
    first_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    state = ds.state.clone()
    next_retry = ds.next_retry_ms
    probe_rules = []  # per-slot int32[N]: rule id probed by request i, or -1

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = (rule_id >= 0) & candidate & (~blocked)

        st = gather(state, rule_id, C.BREAKER_CLOSED)
        nr = gather(next_retry, rule_id, 0)

        is_open = st == C.BREAKER_OPEN
        is_half = st == C.BREAKER_HALF_OPEN
        retry_due = is_open & (nr <= now_ms)

        # One probe per rule per batch: first arrival with a due retry.
        probe_ids = torch.where(has_rule & retry_due, rule_id, -1)
        probe = has_rule & retry_due & first_in_segment(probe_ids, rt.num_rules)

        blocked_k = has_rule & (is_half | (is_open & ~probe))
        first_slot = torch.where(blocked_k, k, first_slot)
        blocked = blocked | blocked_k

        # OPEN -> HALF_OPEN where a probe was admitted.
        set_at(state, (rule_id,), C.BREAKER_HALF_OPEN,
               probe & in_range(rule_id, rt.num_rules))
        probe_rules.append(torch.where(probe, rule_id, -1))

    # A probe granted at one slot whose request another slot then blocked
    # never completes: revert those breakers to OPEN (retry untouched).
    for pr in probe_rules:
        dead = torch.where(blocked, pr, -1)
        set_at(state, (dead,), C.BREAKER_OPEN, in_range(dead, rt.num_rules))

    return DegradeVerdict(blocked=blocked, state=ds._replace(state=state),
                          slot=first_slot)


def feed_degrade(
    rt: DegradeRuleTensors,
    ds: DegradeState,
    batch: ExitBatch,
    now_ms: int,
) -> DegradeState:
    """Vectorized ``onRequestComplete``: window feed + state transitions.
    Returns new tensors; ``ds`` is not modified."""
    n = batch.cluster_row.shape[0]
    dev = batch.cluster_row.device
    win = W.row_rotate(ds.win, now_ms)
    state = ds.state
    next_retry = ds.next_retry_ms

    valid = batch.cluster_row >= 0
    err = valid & batch.error

    half_bad = torch.zeros((rt.num_rules,), dtype=torch.bool, device=dev)
    half_good = torch.zeros((rt.num_rules,), dtype=torch.bool, device=dev)

    for k in range(rt.slots):
        rule_id = gather(rt.rules_by_row[:, k], batch.cluster_row, -1)
        has_rule = (rule_id >= 0) & valid
        # JAX gates this on a lax.cond; with no breaker-ruled completion
        # every write below is dropped, so skipping it changes nothing.
        if not host_bool(has_rule.any(), "sync.degrade.exit_rules"):
            continue
        rid = torch.where(has_rule, rule_id, -1)
        thr = gather(rt.threshold, rule_id, 0.0)
        grade = gather(rt.grade, rule_id, 0)
        slow = has_rule & (grade == C.DEGRADE_GRADE_RT) & (
            batch.rt_ms.to(torch.float32) > thr)
        bad = torch.where(grade == C.DEGRADE_GRADE_RT, slow, err & has_rule)

        cnt = torch.where(has_rule, batch.count, 0)
        ch = lambda c: torch.full((n,), c, dtype=torch.int32, device=dev)
        win = W.row_window_add(win, now_ms, rid, ch(CH_TOTAL), cnt)
        win = W.row_window_add(win, now_ms, rid, ch(CH_ERROR),
                               torch.where(err & has_rule, batch.count, 0))
        win = W.row_window_add(win, now_ms, rid, ch(CH_SLOW),
                               torch.where(slow, batch.count, 0))

        # HALF_OPEN probe verdicts: any completion of the rule votes.
        st = gather(state, rule_id, -1)
        on_half = has_rule & (st == C.BREAKER_HALF_OPEN)
        ok_r = in_range(rule_id, rt.num_rules)
        set_at(half_bad, (rule_id,), True, on_half & bad & ok_r)
        set_at(half_good, (rule_id,), True, on_half & ~bad & ok_r)

    # --- rule-axis transitions -------------------------------------------
    totals = W.row_window_totals(
        win, torch.arange(rt.num_rules, device=dev))  # [DR, 3] int64
    total = totals[:, CH_TOTAL].to(torch.float32)
    error = totals[:, CH_ERROR].to(torch.float32)
    slowc = totals[:, CH_SLOW].to(torch.float32)
    enough = totals[:, CH_TOTAL] >= rt.min_request

    ratio_den = torch.clamp(total, min=1.0)
    slow_r = slowc / ratio_den
    err_r = error / ratio_den
    trip_slow = (slow_r > rt.slow_ratio) | ((rt.slow_ratio >= 1.0) & (slow_r >= 1.0))
    trip = torch.where(rt.grade == C.DEGRADE_GRADE_RT, trip_slow,
                       err_r > rt.threshold)
    trip = torch.where(rt.grade == C.DEGRADE_GRADE_EXCEPTION_COUNT,
                       error > rt.threshold, trip)
    trip = trip & enough

    is_closed = state == C.BREAKER_CLOSED
    is_half = state == C.BREAKER_HALF_OPEN

    # HALF_OPEN verdict: bad wins over good.
    to_open = (is_closed & trip) | (is_half & half_bad)
    to_closed = is_half & half_good & (~half_bad)

    state = torch.where(to_open, C.BREAKER_OPEN, state)
    state = torch.where(to_closed, C.BREAKER_CLOSED, state)
    next_retry = torch.where(to_open, rt.time_window_ms + now_ms, next_retry)

    # Closing resets the breaker's stats window (reference: resetStat()).
    win = win._replace(counts=torch.where(to_closed[:, None, None], 0,
                                          win.counts))
    return DegradeState(state=state, next_retry_ms=next_retry, win=win)
