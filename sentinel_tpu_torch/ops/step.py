"""The fused admission/commit step (port of ``sentinel_tpu/ops/step.py``).

``entry_step(state, rules, batch, now) -> (state', decisions)``:

  1. rotates the 1s window to ``now`` and folds the staged second into the
     minute window when the second rolled (``_roll_second``);
  2. runs the rule slots authority → system → param → flow → degrade, the
     reference chain's order;
  3. commits statistics like ``StatisticSlot`` — pass / block / thread
     gauge — AFTER the verdicts, to the DefaultNode, ClusterNode, origin
     and (inbound) ENTRY_NODE rows, as one exact integer bincount.

``exit_step`` commits RT / success / exception, the min-RT, the thread
decrement, the RT histogram, and feeds the breakers and THREAD-grade
param gauges.

The JAX state is donated every step; here the step CONSUMES its input
state: the minute window, the second staging, the telemetry staging and
the param-flow tables are updated in place, the small tensors are
replaced. Callers keep only the returned state.

The flight recorder (``state.flight``, a per-second ring of the staged
second's deltas) is written at the once-per-second fold in
``_roll_second``. A bare ``make_state`` leaves it ``None`` unless
``flight_seconds`` is given; the engine asks for it by default
(``csp.sentinel.telemetry.timeseries.seconds``, 128), as the reference
engine does. The SPI device checkers ride ``entry_step``'s
``extra_checkers``.

The staged-rollout shadow world (``state.shadow``, a ``ShadowState``)
is present while a candidate ruleset holds the device (``rollout/``):
``entry_step(shadow_rules=...)`` runs the candidate's cascade in
non-enforcing lanes of the same step, commits its would-verdicts through
the live commit's one bincount, and with ``canary_bps`` set lets the
candidate's verdict govern a hash-selected slice of lanes;
``exit_step(shadow_rules=...)`` feeds live completions to the candidate's
breakers and THREAD-grade param gauges.

The pod (``parallel/cluster.py``, ``parallel/namespaces.py``) runs this
step on every shard with the other shards' contributions summed over the
pod: ``extra_pass`` / ``extra_next`` (and the cross-slice twins
``extra_pass_global`` / ``extra_next_global``) for cluster-mode flow
rules, ``extra_cms`` for cluster-mode param rules, and
``shadow_extra_pass`` / ``shadow_extra_cms`` for a pod-wide candidate's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import Decisions, EntryBatch, ExitBatch
from sentinel_tpu_torch.core.registry import ENTRY_ROW
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.ops import segment as seg
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.ops.window import add_at, in_range, min_at
from sentinel_tpu_torch.rollout.canary import device_in_canary
from sentinel_tpu_torch.telemetry.attribution import (
    NUM_ATTR_REASONS,
    NUM_RT_BUCKETS,
    NUM_SLOT_BINS,
    REASON_CHANNEL_TABLE,
    rt_bucket_index,
    slot_bin_index,
)
from sentinel_tpu_torch.utils.device import SYNCS, resolve_device

SPEC_1S = W.WindowSpec(C.SECOND_WINDOW_MS, C.SECOND_BUCKETS)
SPEC_60S = W.WindowSpec(C.MINUTE_WINDOW_MS, C.MINUTE_BUCKETS)

# Shadow-lane counter channels (rollout/): cumulative per node row since
# the candidate set was installed. WOULD_* are the candidate ("shadow
# world") verdicts; LIVE_* mirror the live commit, so a rollout guardrail
# diffs the two worlds from ONE tensor read.
SH_WOULD_PASS = 0
SH_WOULD_BLOCK = 1
SH_WB_AUTHORITY = 2
SH_WB_SYSTEM = 3
SH_WB_PARAM = 4
SH_WB_FLOW = 5
SH_WB_DEGRADE = 6
SH_LIVE_PASS = 7
SH_LIVE_BLOCK = 8
NUM_SHADOW_COUNTERS = 9


class SecondAccum(NamedTuple):
    """Staging buffer for the current second's statistics, folded into
    ``w60`` once per second."""

    counts: torch.Tensor  # int32[E, R] event deltas of the second at `stamp`
    min_rt: torch.Tensor  # int32[R] min RT observed this second
    stamp: torch.Tensor   # int64[] bucket-start ms of the second; -1 = unset


class TelemetryState(NamedTuple):
    """Cumulative telemetry plus the current second's int32 staging; the
    int64 counters fold from the staging once per second."""

    block_by_reason: torch.Tensor  # int64[NUM_ATTR_REASONS, R]
    rt_hist: torch.Tensor          # int64[NUM_RT_BUCKETS, R]
    totals: torch.Tensor           # int64[NUM_EVENTS, R]
    block_by_slot: torch.Tensor    # int64[NUM_ATTR_REASONS, NUM_SLOT_BINS]
    stage_attr: torch.Tensor       # int32[NUM_ATTR_REASONS, R]
    stage_hist: torch.Tensor       # int32[NUM_RT_BUCKETS, R]
    stage_slot: torch.Tensor       # int32[NUM_ATTR_REASONS, NUM_SLOT_BINS]


def make_telemetry_state(num_rows: int, device) -> TelemetryState:
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return TelemetryState(
        block_by_reason=z((NUM_ATTR_REASONS, num_rows), torch.int64),
        rt_hist=z((NUM_RT_BUCKETS, num_rows), torch.int64),
        totals=z((C.NUM_EVENTS, num_rows), torch.int64),
        block_by_slot=z((NUM_ATTR_REASONS, NUM_SLOT_BINS), torch.int64),
        stage_attr=z((NUM_ATTR_REASONS, num_rows), torch.int32),
        stage_hist=z((NUM_RT_BUCKETS, num_rows), torch.int32),
        stage_slot=z((NUM_ATTR_REASONS, NUM_SLOT_BINS), torch.int32),
    )


class ShadowState(NamedTuple):
    """The candidate ruleset's parallel world (``rollout/``).

    The shadow flow and param checks admit against what the candidate
    WOULD have passed, so the shadow world carries its own instant window
    and controller state for every stateful family. Thread gauges, RT and
    exception outcomes and the host OS signals come from the live tensors
    (which requests ran is decided by the live world). Every tensor here
    is the shadow's own: no live write reaches it and no shadow write
    reaches the live state."""

    w1: W.Window             # shadow instant window (candidate-passed)
    flow: F.FlowState        # candidate warm-up / leaky-bucket state
    param: P.ParamFlowState
    degrade: D.DegradeState  # candidate breakers, fed by LIVE completions
    counts: torch.Tensor     # int64[NUM_SHADOW_COUNTERS, R] cumulative


class FlightRecorder(NamedTuple):
    """Device-resident per-second telemetry ring (the flight recorder).

    One slot per second, indexed ``(second_start_ms // 1000) % ring``:
    each holds that second's exact deltas, the tensors the
    ``_roll_second`` fold already stages (``sec.counts`` and the
    attribution / histogram / slot staging), copied in place at the fold,
    at most once per second. ``stamps`` holds each slot's second-start ms
    (-1 = never written); a reader checks the stamp before trusting a
    slot. The host spill and the longer history are in
    ``telemetry/timeseries.py``."""

    stamps: torch.Tensor     # int64[RING] second-start ms per slot; -1 unset
    events: torch.Tensor     # int32[RING, NUM_EVENTS, R] per-second deltas
    attr: torch.Tensor       # int32[RING, NUM_ATTR_REASONS, R]
    hist: torch.Tensor       # int32[RING, NUM_RT_BUCKETS, R]
    slot_attr: torch.Tensor  # int32[RING, NUM_ATTR_REASONS, NUM_SLOT_BINS]


def make_flight_recorder(num_rows: int, seconds: int,
                         device) -> FlightRecorder:
    z = lambda shape: torch.zeros(shape, dtype=torch.int32, device=device)
    return FlightRecorder(
        stamps=torch.full((seconds,), -1, dtype=torch.int64, device=device),
        events=z((seconds, C.NUM_EVENTS, num_rows)),
        attr=z((seconds, NUM_ATTR_REASONS, num_rows)),
        hist=z((seconds, NUM_RT_BUCKETS, num_rows)),
        slot_attr=z((seconds, NUM_ATTR_REASONS, NUM_SLOT_BINS)),
    )


class SentinelState(NamedTuple):
    """All mutable device state, consumed and returned by every step."""

    w1: W.Window             # 1s / 2-bucket window over all node rows
    w60: W.Window            # 60s / 60-bucket window (metric log source)
    cur_threads: torch.Tensor  # int32[R] live concurrency gauge per row
    flow: F.FlowState
    degrade: D.DegradeState
    param: P.ParamFlowState
    sys_signals: torch.Tensor  # f32[2] caller-sampled [load1, cpu_usage]
    sec: SecondAccum         # current-second staging for the minute window
    occupied_next: torch.Tensor   # int32[R] pending occupy borrows per row
    occupied_stamp: torch.Tensor  # int64[] w1 bucket-start of the grants
    telemetry: TelemetryState
    # The staged-rollout shadow world, present only while a candidate
    # ruleset holds the device.
    shadow: Optional[ShadowState] = None
    # The per-second flight-recorder ring, or None when recording is off
    # (the default of a bare make_state). Written only at the fold.
    flight: Optional[FlightRecorder] = None


class RulePack(NamedTuple):
    """All compiled rule tensors (host-rebuilt wholesale on config push)."""

    flow: F.FlowRuleTensors
    degrade: D.DegradeRuleTensors
    authority: A.AuthorityRuleTensors
    system: Y.SystemRuleTensors
    param: P.ParamRuleTensors


def make_state(num_rows: int, flow_rules: int, now_ms: int,
               degrade: D.DegradeState = None,
               param: P.ParamFlowState = None,
               spec1: W.WindowSpec = SPEC_1S,
               device=None, flight_seconds: int = 0) -> SentinelState:
    device = resolve_device(device)
    if degrade is None:
        dt, di = D.compile_degrade_rules([], None, num_rows, device=device)
        degrade = D.make_degrade_state(dt, di)
    if param is None:
        param = P.make_param_state(0, device=device)
    return SentinelState(
        w1=W.make_window(num_rows, spec1, device),
        w60=W.make_window(num_rows, SPEC_60S, device),
        cur_threads=torch.zeros((num_rows,), dtype=torch.int32, device=device),
        flow=F.make_flow_state(flow_rules, now_ms, device=device),
        degrade=degrade,
        param=param,
        sys_signals=torch.full((Y.NUM_SIGNALS,), -1.0, dtype=torch.float32,
                               device=device),
        sec=SecondAccum(
            counts=torch.zeros((C.NUM_EVENTS, num_rows), dtype=torch.int32,
                               device=device),
            min_rt=torch.full((num_rows,), W.MIN_RT_EMPTY, dtype=torch.int32,
                              device=device),
            stamp=torch.tensor(-1, dtype=torch.int64, device=device),
        ),
        occupied_next=torch.zeros((num_rows,), dtype=torch.int32,
                                  device=device),
        occupied_stamp=torch.tensor(-1, dtype=torch.int64, device=device),
        telemetry=make_telemetry_state(num_rows, device),
        flight=(make_flight_recorder(num_rows, flight_seconds, device)
                if flight_seconds > 0 else None),
    )


def make_shadow_state(num_rows: int, shadow_rules: RulePack,
                      degrade_state: D.DegradeState,
                      spec1: W.WindowSpec = SPEC_1S,
                      device=None) -> ShadowState:
    """A fresh shadow world for a just-installed candidate ruleset: cold
    controller state, as a live rule load makes, an empty window, zero
    counters. ``degrade_state`` must be the candidate's own breakers
    (``D.make_degrade_state`` of its compiled degrade rules)."""
    device = resolve_device(device)
    return ShadowState(
        w1=W.make_window(num_rows, spec1, device),
        flow=F.make_flow_state(shadow_rules.flow.num_rules, 0, device=device),
        param=P.make_param_state(shadow_rules.param.num_rules, device=device),
        degrade=degrade_state,
        counts=torch.zeros((NUM_SHADOW_COUNTERS, num_rows), dtype=torch.int64,
                           device=device),
    )


def _roll_second(w60: W.Window, sec: SecondAccum, telemetry: TelemetryState,
                 flight: Optional[FlightRecorder], now_ms: int
                 ) -> Tuple[W.Window, SecondAccum, TelemetryState,
                            Optional[FlightRecorder]]:
    """Fold the staged second into the minute window if the second rolled
    (IN PLACE on all four). The fold freshens only the stamped bucket and
    lands the whole [E, R] delta with one dense add; the cumulative
    telemetry counters fold from the same pre-reset staging, and the
    flight recorder (when present) copies that pre-reset staging into the
    completed second's ring slot first. One counted sync reads the stamp;
    the ring write rides the same branch."""
    now = int(now_ms)
    sec_start = now - now % SPEC_60S.bucket_ms
    SYNCS.count += 1
    stamp = int(sec.stamp)
    if stamp >= 0 and stamp != sec_start:
        t = telemetry
        if flight is not None:
            # Slot of the COMPLETED second (the stamp, not sec_start).
            i = (stamp // SPEC_60S.bucket_ms) % flight.stamps.shape[0]
            flight.stamps[i] = stamp
            flight.events[i].copy_(sec.counts)
            flight.attr[i].copy_(t.stage_attr)
            flight.hist[i].copy_(t.stage_hist)
            flight.slot_attr[i].copy_(t.stage_slot)
        W.rotate_current(w60, stamp, SPEC_60S)
        idx = W.current_index(stamp, SPEC_60S)
        w60.counts[idx] += sec.counts
        w60.min_rt[idx] = torch.minimum(w60.min_rt[idx], sec.min_rt)
        t.block_by_reason.add_(t.stage_attr)
        t.rt_hist.add_(t.stage_hist)
        t.totals.add_(sec.counts)
        t.block_by_slot.add_(t.stage_slot)
        t.stage_attr.zero_()
        t.stage_hist.zero_()
        t.stage_slot.zero_()
        sec.counts.zero_()
        sec.min_rt.fill_(W.MIN_RT_EMPTY)
    sec.stamp.fill_(sec_start)
    return w60, sec, telemetry, flight


def telemetry_view(state: SentinelState) -> TelemetryState:
    """Read-side exact telemetry: the cumulative counters plus the live
    staged second (the staging zeroed in the returned view, since it has
    been folded in). Allocates new tensors; ``state`` is not changed."""
    t = state.telemetry
    return TelemetryState(
        block_by_reason=t.block_by_reason + t.stage_attr.to(torch.int64),
        rt_hist=t.rt_hist + t.stage_hist.to(torch.int64),
        totals=t.totals + state.sec.counts.to(torch.int64),
        block_by_slot=t.block_by_slot + t.stage_slot.to(torch.int64),
        stage_attr=torch.zeros_like(t.stage_attr),
        stage_hist=torch.zeros_like(t.stage_hist),
        stage_slot=torch.zeros_like(t.stage_slot),
    )


def flush_seconds(state: SentinelState, now_ms: int) -> SentinelState:
    """Host-boundary flush: fold any completed staged second into ``w60``,
    the cumulative telemetry counters and the flight ring (in place)."""
    w60, sec, telemetry, flight = _roll_second(
        state.w60, state.sec, state.telemetry, state.flight, now_ms)
    return state._replace(w60=w60, sec=sec, telemetry=telemetry,
                          flight=flight)


def _target_rows(cluster_row, dn_row, origin_row, entry_in):
    """[N, 4] node rows each request commits to (−1 entries are dropped)."""
    entry_row = torch.where(entry_in, ENTRY_ROW, -1).to(cluster_row.dtype)
    return torch.stack([dn_row, cluster_row, origin_row, entry_row], dim=1)


def _event_delta(rows4: torch.Tensor, pairs, num_rows: int,
                 extra_cols=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """All (event, values4) commits as one dense int32[E, R] delta.

    ``pairs``: list of (MetricEvent, values4, wide) with values4 shaped
    like ``rows4``; ``wide`` values (RT sums) are clipped to [0, 65535] as
    in the JAX step. The bincount is an exact integer ``index_add_``, so
    the JAX byte-limb split (for bf16 operands) is not needed.
    ``extra_cols``: further [N, 4] value sets folded into the same call.
    Returns ``(delta, extras)`` with ``extras`` int32[len(extra_cols), R].
    """
    rows_flat = rows4.reshape(-1)
    cols = []
    for _, v, wide in pairs:
        vf = v.reshape(-1)
        if wide:
            vf = torch.clamp(vf, 0, 65535)
        cols.append(vf.to(torch.int32))
    cols += [v.reshape(-1).to(torch.int32) for v in extra_cols]
    out = seg.bincount_matmul(rows_flat, torch.stack(cols, dim=1), num_rows)
    delta = torch.zeros((C.NUM_EVENTS, num_rows), dtype=torch.int32,
                        device=rows4.device)
    for i, (ev, _, _) in enumerate(pairs):
        delta[ev] = out[i]
    return delta, out[len(pairs):]


def _apply_delta(w1: W.Window, sec: SecondAccum, delta: torch.Tensor,
                 now_ms: int, spec1: W.WindowSpec) -> Tuple[W.Window, SecondAccum]:
    """Fold a dense [E, R] delta into w1's current bucket + the second
    accumulator (in place)."""
    idx1 = W.current_index(now_ms, spec1)
    w1.counts[idx1] += delta
    sec.counts.add_(delta)
    return w1, sec


def _checker_verdict(chk, verdict, cand: torch.Tensor) -> torch.Tensor:
    """A device checker's verdict, held to bool[N] on the batch's device.
    Anything else raises, as the reference's trace fails on it: the
    engine's dispatch then drops the state cold and fails open."""
    if not isinstance(verdict, torch.Tensor) or verdict.dtype != torch.bool \
            or verdict.shape != cand.shape or verdict.device != cand.device:
        got = (f"{verdict.dtype}{list(verdict.shape)} on {verdict.device}"
               if isinstance(verdict, torch.Tensor) else type(verdict).__name__)
        raise TypeError(
            f"device checker {getattr(chk, '__name__', chk)!r} returned "
            f"{got}; expected torch.bool{list(cand.shape)} on {cand.device}")
    return verdict


def _shadow_entry_eval(state: SentinelState, shadow_rules: RulePack,
                       batch: EntryBatch, now_ms: int, w1_live: W.Window,
                       w60_live: W.Window, sec_counts: torch.Tensor,
                       spec1: W.WindowSpec, occupy_timeout_ms: int,
                       shadow_extra_pass: Optional[torch.Tensor] = None,
                       shadow_extra_cms: Optional[torch.Tensor] = None):
    """The candidate ruleset's cascade in non-enforcing lanes: authority
    -> system -> param -> flow -> degrade, as the live chain. Every real
    lane counts, pre-decided or not. Flow and param admit against the
    shadow world (its rotated window and its controller state, updated in
    place where the live checks update theirs); the system check reads
    the live rotated window and the ROLLED minute window and second
    staging (the same tensors the live check reads); thread gauges and OS
    signals are live. Occupy borrows are not simulated: a prioritized
    request the candidate rejects counts as would-block. On the pod the
    candidate's cluster-mode rules admit against the pod-global shadow
    window and sketch (``shadow_extra_pass`` / ``shadow_extra_cms``).

    Returns ``(blocked, reason, wait_us, (flow, param, degrade) states,
    rotated shadow w1, per-family block masks, rule_slot)``."""
    sh = state.shadow
    lanes = batch.cluster_row >= 0
    sh_w1 = W.rotate(sh.w1, now_ms, spec1)

    s_reason = torch.where(lanes, int(C.BlockReason.PASS), -1).to(torch.int32)
    s_slot = torch.full_like(s_reason, -1)
    s_av = A.check_authority(shadow_rules.authority, batch, lanes)
    s_auth = s_av.blocked
    s_reason = torch.where(lanes & s_auth, int(C.BlockReason.AUTHORITY),
                           s_reason)
    s_slot = torch.where(lanes & s_auth, s_av.slot, s_slot)
    s_blocked = s_auth

    cand = lanes & (~s_blocked)
    s_sys = Y.check_system(shadow_rules.system, state.sys_signals, w1_live,
                           w60_live, sec_counts, state.cur_threads, batch,
                           cand, now_ms, spec1=spec1)
    s_reason = torch.where(cand & s_sys, int(C.BlockReason.SYSTEM), s_reason)
    s_slot = torch.where(cand & s_sys, 0, s_slot)
    s_blocked = s_blocked | s_sys

    cand = lanes & (~s_blocked)
    s_pv = P.check_param_flow(shadow_rules.param, sh.param, batch, now_ms,
                              cand, extra_cms=shadow_extra_cms)
    s_reason = torch.where(cand & s_pv.blocked,
                           int(C.BlockReason.PARAM_FLOW), s_reason)
    s_slot = torch.where(cand & s_pv.blocked, s_pv.slot, s_slot)
    s_blocked = s_blocked | s_pv.blocked

    s_fv = F.check_flow(shadow_rules.flow, sh.flow, sh_w1, state.cur_threads,
                        batch, now_ms, s_blocked | (~lanes), spec=spec1,
                        occupy_timeout_ms=occupy_timeout_ms,
                        extra_pass=shadow_extra_pass)
    s_flow = lanes & (~s_blocked) & s_fv.blocked
    s_reason = torch.where(s_flow, int(C.BlockReason.FLOW), s_reason)
    s_slot = torch.where(s_flow, s_fv.slot, s_slot)
    s_blocked = s_blocked | s_fv.blocked

    cand = lanes & (~s_blocked)
    s_dv = D.check_degrade(shadow_rules.degrade, sh.degrade, batch, now_ms,
                           cand)
    s_degr = cand & s_dv.blocked
    s_reason = torch.where(s_degr, int(C.BlockReason.DEGRADE), s_reason)
    s_slot = torch.where(s_degr, s_dv.slot, s_slot)
    s_blocked = s_blocked | s_dv.blocked

    s_wait_us = torch.where(lanes & (~s_blocked),
                            torch.maximum(s_fv.wait_us, s_pv.wait_us), 0)
    fam_blocks = (s_auth & lanes, s_sys, s_pv.blocked & lanes, s_flow,
                  s_degr)
    return (s_blocked & lanes, s_reason, s_wait_us,
            (s_fv.state, s_pv.state, s_dv.state), sh_w1, fam_blocks, s_slot)


def entry_step(
    state: SentinelState,
    rules: RulePack,
    batch: EntryBatch,
    now_ms: int,
    spec1: W.WindowSpec = SPEC_1S,
    occupy_timeout_ms: int = C.DEFAULT_OCCUPY_TIMEOUT_MS,
    extra_checkers: Sequence[Callable] = (),
    shadow_rules: Optional[RulePack] = None,
    canary_bps: Optional[int] = None,
    canary_salt: Optional[int] = None,
    extra_pass: Optional[torch.Tensor] = None,
    extra_next: Optional[torch.Tensor] = None,
    extra_cms: Optional[torch.Tensor] = None,
    extra_pass_global: Optional[torch.Tensor] = None,
    extra_next_global: Optional[torch.Tensor] = None,
    shadow_extra_pass: Optional[torch.Tensor] = None,
    shadow_extra_cms: Optional[torch.Tensor] = None,
) -> Tuple[SentinelState, Decisions]:
    """One admission step; consumes ``state``.

    ``extra_pass`` / ``extra_next`` ([R]) and ``extra_cms`` (f32[PR, D,
    W]), all optional, are the other shards' pass counts, next-window use
    and param sketch, for cluster-mode rules; ``extra_pass_global`` /
    ``extra_next_global`` are the cross-slice twins that scope="global"
    rules read instead; ``shadow_extra_pass`` / ``shadow_extra_cms`` are
    the candidate's. The pod drivers (``parallel/``) supply them.

    ``extra_checkers``: the SPI device checkers (``core/spi.py``), each
    ``fn(state, rules, batch, now_ms, candidate) -> bool[N]``, spliced
    after param flow and before flow (the reference chain's custom-slot
    position). Each sees the state with the ROTATED ``w1`` and, as its
    candidate, only the lanes still undecided; a lane it blocks takes
    reason ``CUSTOM`` with the checker's index as ``rule_slot`` and
    reaches flow decided. The fold above ran in place, so the checker sees
    the minute window and the second staging after it (the reference
    passes them before it): their sum, which a reader combines, is the
    same either way.

    ``shadow_rules`` (with ``state.shadow`` present) evaluates a staged
    candidate ruleset in non-enforcing lanes: its would-verdicts
    accumulate in ``state.shadow.counts`` with no effect on live
    decisions, unless ``canary_bps`` is set; then the lanes whose
    (origin, context) hash falls inside the canary slice take the
    candidate's verdict instead of the live one, before the stat commit.
    ``canary_bps`` and ``canary_salt`` are host ints: the mix reads
    nothing back from the device."""
    now_ms = int(now_ms)
    w1 = W.rotate(state.w1, now_ms, spec1)
    w60, sec, tele, flight = _roll_second(state.w60, state.sec,
                                          state.telemetry, state.flight,
                                          now_ms)

    # Land pending occupy borrows once the bucket after the granting one
    # is current; a jump of 2+ buckets drops them.
    idx1 = W.current_index(now_ms, spec1)
    cur_start = now_ms - now_ms % spec1.bucket_ms
    moved = (state.occupied_stamp >= 0) & (state.occupied_stamp != cur_start)
    land = moved & (state.occupied_stamp + spec1.bucket_ms == cur_start)
    w1.counts[idx1, C.MetricEvent.PASS] += torch.where(
        land, state.occupied_next, 0)
    occupied_next = torch.where(moved, 0, state.occupied_next)

    valid = batch.cluster_row >= 0
    reason = torch.where(valid, int(C.BlockReason.PASS), -1).to(torch.int32)
    rule_slot = torch.full_like(reason, -1)
    # Pre-decided lanes (remote rejections / host admissions) skip every
    # slot and only commit their statistics.
    blocked = valid & batch.pre_blocked
    reason = torch.where(blocked, batch.pre_reason, reason)
    pre_ok = valid & batch.pre_passed & (~blocked)
    decided = blocked | pre_ok

    # --- rule slots: authority → system → param-flow → flow → degrade ----
    av = A.check_authority(rules.authority, batch, valid & (~decided))
    hit = valid & (~decided) & av.blocked
    reason = torch.where(hit, int(C.BlockReason.AUTHORITY), reason)
    rule_slot = torch.where(hit, av.slot, rule_slot)
    blocked = blocked | av.blocked
    decided = decided | blocked

    cand = valid & (~decided)
    sys_blocked = Y.check_system(rules.system, state.sys_signals, w1, w60,
                                 sec.counts, state.cur_threads, batch, cand,
                                 now_ms, spec1=spec1)
    reason = torch.where(cand & sys_blocked, int(C.BlockReason.SYSTEM), reason)
    # System rules are one global set, not per-resource slots: slot 0.
    rule_slot = torch.where(cand & sys_blocked, 0, rule_slot)
    blocked = blocked | sys_blocked
    decided = decided | blocked

    cand = valid & (~decided)
    pv = P.check_param_flow(rules.param, state.param, batch, now_ms, cand,
                            extra_cms=extra_cms)
    reason = torch.where(cand & pv.blocked, int(C.BlockReason.PARAM_FLOW),
                         reason)
    rule_slot = torch.where(cand & pv.blocked, pv.slot, rule_slot)
    blocked = blocked | pv.blocked
    decided = decided | blocked

    for chk_idx, chk in enumerate(extra_checkers):
        cand = valid & (~decided)
        custom_blocked = cand & _checker_verdict(
            chk, chk(state._replace(w1=w1), rules, batch, now_ms, cand),
            cand)
        reason = torch.where(custom_blocked, int(C.BlockReason.CUSTOM),
                             reason)
        rule_slot = torch.where(custom_blocked, chk_idx, rule_slot)
        blocked = blocked | custom_blocked
        decided = decided | blocked

    fv = F.check_flow(rules.flow, state.flow, w1, state.cur_threads, batch,
                      now_ms, decided, occupied_next=occupied_next,
                      spec=spec1, occupy_timeout_ms=occupy_timeout_ms,
                      extra_pass=extra_pass, extra_next=extra_next,
                      extra_pass_global=extra_pass_global,
                      extra_next_global=extra_next_global)
    hit = valid & (~decided) & fv.blocked
    reason = torch.where(hit, int(C.BlockReason.FLOW), reason)
    rule_slot = torch.where(hit, fv.slot, rule_slot)
    blocked = blocked | fv.blocked
    decided = decided | blocked

    # Occupy grants leave the chain before the degrade slot.
    granted = valid & (~decided) & fv.occupied
    dv = D.check_degrade(rules.degrade, state.degrade, batch, now_ms,
                         valid & (~decided) & (~granted))
    hit = valid & (~decided) & dv.blocked
    reason = torch.where(hit, int(C.BlockReason.DEGRADE), reason)
    rule_slot = torch.where(hit, dv.slot, rule_slot)
    blocked = blocked | dv.blocked

    # --- shadow lanes (rollout/) ----------------------------------------
    # The candidate's verdicts ride the same step; canary lanes swap their
    # ENFORCED verdict to the candidate's BEFORE the stat commit, so the
    # live windows record what actually happened to them.
    s_eval = None
    wait_pick = torch.maximum(fv.wait_us, pv.wait_us)
    if shadow_rules is not None and state.shadow is not None:
        s_eval = _shadow_entry_eval(state, shadow_rules, batch, now_ms, w1,
                                    w60, sec.counts, spec1,
                                    occupy_timeout_ms, shadow_extra_pass,
                                    shadow_extra_cms)
        (s_blocked, s_reason, s_wait_us, s_states, sh_w1, s_fam,
         s_slot) = s_eval
        if canary_bps is not None:
            # Pre-decided lanes (remote verdicts, lease commits) and
            # occupy-granted lanes stay live-governed: their decision was
            # made elsewhere.
            mix = (valid & (~batch.pre_blocked) & (~batch.pre_passed)
                   & (~granted)
                   & device_in_canary(batch.origin_id, batch.context_id,
                                      0 if canary_salt is None
                                      else canary_salt, canary_bps))
            blocked = torch.where(mix, s_blocked, blocked)
            reason = torch.where(mix, s_reason, reason)
            rule_slot = torch.where(mix, s_slot, rule_slot)
            wait_pick = torch.where(mix, s_wait_us, wait_pick)

    # --- StatisticSlot commit --------------------------------------------
    rows4 = _target_rows(batch.cluster_row, batch.dn_row, batch.origin_row,
                         batch.entry_in)
    admit = valid & (~blocked)
    # Granted occupies commit their PASS in the bucket they borrowed (the
    # fold above, a later step); the minute staging gets PASS +
    # OCCUPIED_PASS at grant time.
    pass_counts = torch.where(admit & (~granted), batch.count, 0)
    block_counts = torch.where(valid & blocked, batch.count, 0)
    pass4 = pass_counts[:, None].expand(rows4.shape)
    block4 = block_counts[:, None].expand(rows4.shape)
    thread_inc = torch.where(admit, 1, 0)[:, None].expand(rows4.shape)
    extra_cols = [thread_inc]
    if s_eval is not None:
        # The shadow window's PASS and every would-verdict channel ride
        # the live commit's bincount as extra value columns: still one
        # bincount. The LIVE channels need no column: they are exactly
        # delta[PASS] / delta[BLOCK].
        s_pass = torch.where(valid & (~s_blocked), batch.count, 0)
        s_block = torch.where(valid & s_blocked, batch.count, 0)
        for col in (s_pass, s_block,
                    *(torch.where(m, batch.count, 0) for m in s_fam)):
            extra_cols.append(col[:, None].expand(rows4.shape))
    delta, extras = _event_delta(
        rows4, [(C.MetricEvent.PASS, pass4, False),
                (C.MetricEvent.BLOCK, block4, False)], w1.num_rows,
        extra_cols=extra_cols)
    w1, sec = _apply_delta(w1, sec, delta, now_ms, spec1)
    occupied_next = occupied_next + fv.occ_add
    occupied_stamp = torch.full((), cur_start, dtype=torch.int64,
                                device=valid.device)
    sec.counts[C.MetricEvent.PASS] += fv.occ_add
    sec.counts[C.MetricEvent.OCCUPIED_PASS] += fv.occ_add

    cur_threads = state.cur_threads + extras[0]

    # Telemetry: blocked lanes into the staged per-(reason, ClusterNode)
    # and per-(reason, slot bin) counters (in place).
    table = torch.as_tensor(REASON_CHANNEL_TABLE, device=valid.device)
    attr_ch = table[torch.clamp(reason, 0, REASON_CHANNEL_TABLE.shape[0] - 1)]
    attr_on = valid & blocked & (attr_ch >= 0)
    ch0 = torch.clamp(attr_ch, min=0)
    add_at(tele.stage_attr, (ch0, batch.cluster_row), batch.count,
           attr_on & in_range(batch.cluster_row, w1.num_rows))
    add_at(tele.stage_slot, (ch0, slot_bin_index(rule_slot)), batch.count,
           attr_on)

    # The shadow commit (in place on the shadow's own tensors): the
    # would-pass into its window's current bucket, the seven would-verdict
    # channels, then the live PASS / BLOCK of the same rows.
    shadow = state.shadow
    if s_eval is not None:
        sh_w1.counts[idx1, C.MetricEvent.PASS] += extras[1]
        counts = shadow.counts
        counts[SH_WOULD_PASS:SH_LIVE_PASS] += extras[1:8].to(torch.int64)
        counts[SH_LIVE_PASS] += delta[C.MetricEvent.PASS].to(torch.int64)
        counts[SH_LIVE_BLOCK] += delta[C.MetricEvent.BLOCK].to(torch.int64)
        shadow = ShadowState(w1=sh_w1, flow=s_states[0], param=s_states[1],
                             degrade=s_states[2], counts=counts)

    wait_us = torch.where(admit, wait_pick, 0)

    new_state = SentinelState(w1=w1, w60=w60, cur_threads=cur_threads,
                              flow=fv.state, degrade=dv.state, param=pv.state,
                              sys_signals=state.sys_signals, sec=sec,
                              occupied_next=occupied_next,
                              occupied_stamp=occupied_stamp,
                              telemetry=tele, shadow=shadow, flight=flight)
    return new_state, Decisions(reason=reason, wait_us=wait_us,
                                rule_slot=rule_slot)


def exit_step(
    state: SentinelState,
    rules: RulePack,
    batch: ExitBatch,
    now_ms: int,
    spec1: W.WindowSpec = SPEC_1S,
    shadow_rules: Optional[RulePack] = None,
) -> SentinelState:
    """Completion commit: RT + success/exception, thread decrement, min-RT,
    RT histogram, breaker feed and THREAD-grade param gauges. Consumes
    ``state``. With a candidate installed (``shadow_rules`` and
    ``state.shadow``), live completions also feed the candidate's breakers
    and THREAD-grade param gauges: which requests completed, and how, is
    decided by what actually ran."""
    now_ms = int(now_ms)
    w1 = W.rotate(state.w1, now_ms, spec1)
    w60, sec, tele, flight = _roll_second(state.w60, state.sec,
                                          state.telemetry, state.flight,
                                          now_ms)

    valid = batch.cluster_row >= 0
    rows4 = _target_rows(batch.cluster_row, batch.dn_row, batch.origin_row,
                         batch.entry_in)
    succ_mask = valid & batch.success
    succ = torch.where(succ_mask, batch.count, 0)
    exc = torch.where(valid & batch.error, batch.count, 0)
    rt = torch.where(succ_mask, batch.rt_ms, 0)
    succ4 = succ[:, None].expand(rows4.shape)
    exc4 = exc[:, None].expand(rows4.shape)
    rt4 = rt[:, None].expand(rows4.shape)

    thread_dec = torch.where(valid, -1, 0)[:, None].expand(rows4.shape)
    delta, extras = _event_delta(
        rows4, [(C.MetricEvent.SUCCESS, succ4, False),
                (C.MetricEvent.EXCEPTION, exc4, False),
                (C.MetricEvent.RT, rt4, True)], w1.num_rows,
        extra_cols=[thread_dec])
    w1, sec = _apply_delta(w1, sec, delta, now_ms, spec1)

    # RT histogram: one count per success completion (in place).
    num_rows = w1.num_rows
    add_at(tele.stage_hist, (rt_bucket_index(batch.rt_ms), batch.cluster_row),
           1, succ_mask & in_range(batch.cluster_row, num_rows))

    # min-RT: stage one dense [R] min, then fold into the current buckets.
    rt_obs = torch.where(succ_mask[:, None], rt4, W.MIN_RT_EMPTY)
    mstage = torch.full((num_rows,), W.MIN_RT_EMPTY, dtype=torch.int32,
                        device=valid.device)
    rows_flat = rows4.reshape(-1)
    min_at(mstage, (rows_flat,), rt_obs.reshape(-1).to(torch.int32),
           in_range(rows_flat, num_rows))
    idx1 = W.current_index(now_ms, spec1)
    w1.min_rt[idx1] = torch.minimum(w1.min_rt[idx1], mstage)
    sec.min_rt.copy_(torch.minimum(sec.min_rt, mstage))

    # Clamp at zero: exits never outnumber entries in a correct stream.
    cur_threads = torch.clamp(state.cur_threads + extras[0], min=0)

    degrade = D.feed_degrade(rules.degrade, state.degrade, batch, now_ms)
    param = P.feed_param_exit(rules.param, state.param, batch)

    shadow = state.shadow
    if shadow_rules is not None and shadow is not None:
        shadow = shadow._replace(
            degrade=D.feed_degrade(shadow_rules.degrade, shadow.degrade,
                                   batch, now_ms),
            param=P.feed_param_exit(shadow_rules.param, shadow.param, batch))

    return state._replace(w1=w1, w60=w60, cur_threads=cur_threads,
                          degrade=degrade, param=param, sec=sec,
                          telemetry=tele, shadow=shadow, flight=flight)
