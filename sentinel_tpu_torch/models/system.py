"""System rules: whole-process adaptive protection, BBR-style (port of
``sentinel_tpu/models/system.py``).

The five effective thresholds compile to 0-d float32 tensors. Only inbound
traffic is guarded, against the global ENTRY_NODE row. load1 / CPU usage
come from the caller as a 2-element signal vector in the state (-1 = not
sampled); the host sampler (``SystemStatusListener``) is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import EntryBatch
from sentinel_tpu_torch.core.registry import ENTRY_ROW
from sentinel_tpu_torch.core.rule_manager import RuleManager
from sentinel_tpu_torch.ops import fixpoint as FX
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.utils.device import resolve_device

NOT_SET = C.SYSTEM_RULE_NOT_SET  # -1.0

SIG_LOAD = 0
SIG_CPU = 1
NUM_SIGNALS = 2


@dataclass
class SystemRule:
    highest_system_load: float = NOT_SET
    highest_cpu_usage: float = NOT_SET
    qps: float = NOT_SET
    max_thread: float = NOT_SET
    avg_rt: float = NOT_SET
    candidate_set: Optional[str] = None
    rollout_stage: Optional[str] = None

    def is_valid(self) -> bool:
        return any(
            v is not None and v >= 0
            for v in (
                self.highest_system_load,
                self.highest_cpu_usage,
                self.qps,
                self.max_thread,
                self.avg_rt,
            )
        )


class SystemRuleTensors(NamedTuple):
    """Effective thresholds (min across loaded rules; NOT_SET = unguarded)."""

    qps: torch.Tensor         # f32[] scalar
    max_thread: torch.Tensor  # f32[]
    avg_rt: torch.Tensor      # f32[]
    load: torch.Tensor        # f32[]
    cpu: torch.Tensor         # f32[]
    enabled: torch.Tensor     # bool[] any dimension set


def compile_system_rules(rules: List[SystemRule], device=None
                         ) -> SystemRuleTensors:
    """Merge to one threshold per dimension (``SystemRuleManager.loadRules``)."""
    device = resolve_device(device)

    def eff(values: List[float]) -> float:
        vs = [v for v in values if v is not None and v >= 0]
        return min(vs) if vs else NOT_SET

    valid = [r for r in rules if r.is_valid()]
    qps = eff([r.qps for r in valid])
    max_thread = eff([r.max_thread for r in valid])
    avg_rt = eff([r.avg_rt for r in valid])
    load = eff([r.highest_system_load for r in valid])
    cpu = eff([r.highest_cpu_usage for r in valid])
    enabled = any(v >= 0 for v in (qps, max_thread, avg_rt, load, cpu))
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return SystemRuleTensors(
        qps=f(qps), max_thread=f(max_thread), avg_rt=f(avg_rt),
        load=f(load), cpu=f(cpu),
        enabled=torch.tensor(enabled, dtype=torch.bool, device=device),
    )


class SystemRuleManager(RuleManager):
    """Wholesale-swap registry (reference: ``SystemRuleManager``)."""


def check_system(
    rt: SystemRuleTensors,
    signals: torch.Tensor,      # f32[NUM_SIGNALS] [load1, cpu]
    w1: W.Window,
    w60: W.Window,
    sec_counts: torch.Tensor,   # int32[E, R] live current-second accumulator
    cur_threads: torch.Tensor,  # int32[R]
    batch: EntryBatch,
    candidate: torch.Tensor,    # bool[N]
    now_ms: int,
    spec1: Optional[W.WindowSpec] = None,
) -> torch.Tensor:
    """Vectorized ``SystemRuleManager.checkSystem``: bool[N] blocked.

    Survivor resolution follows check_flow's convention (ops/fixpoint.py);
    only IN entries feed the global prefix, so only their counts decide
    the uniform two-pass route.
    """

    def _blocked_for(survivors):
        return _eval_system(rt, signals, w1, w60, sec_counts, cur_threads,
                            batch, candidate, survivors=survivors,
                            now_ms=now_ms, spec1=spec1)

    survivors = FX.survivor_fixpoint(candidate, _blocked_for, batch.count,
                                     relevant=batch.entry_in)
    return _blocked_for(survivors)


def _eval_system(
    rt: SystemRuleTensors,
    signals: torch.Tensor,
    w1: W.Window,
    w60: W.Window,
    sec_counts: torch.Tensor,
    cur_threads: torch.Tensor,
    batch: EntryBatch,
    candidate: torch.Tensor,
    survivors: torch.Tensor,
    now_ms: int,
    spec1: Optional[W.WindowSpec] = None,
) -> torch.Tensor:
    applicable = candidate & batch.entry_in & rt.enabled

    # Within-batch arrival prefixes on the single ENTRY_NODE row.
    contrib = torch.where(survivors & batch.entry_in, batch.count, 0)
    tok_prefix = torch.cumsum(contrib, 0, dtype=torch.int32) - contrib
    ent_contrib = torch.where(survivors & batch.entry_in, 1, 0).to(torch.int32)
    ent_prefix = torch.cumsum(ent_contrib, 0, dtype=torch.int32) - ent_contrib

    qps_scale = torch.tensor(
        1000.0 / (spec1.interval_ms if spec1 is not None
                  else C.SECOND_WINDOW_MS), dtype=torch.float32)
    qps_scale = float(qps_scale)  # the float32-rounded scale, as a scalar
    totals = W.all_totals(w1)[ENTRY_ROW]  # [E] int64
    pass_qps = (totals[C.MetricEvent.PASS].to(torch.float32)
                + tok_prefix.to(torch.float32)) * qps_scale
    succ = torch.clamp(totals[C.MetricEvent.SUCCESS].to(torch.float32), min=1.0)
    cur_rt = totals[C.MetricEvent.RT].to(torch.float32) / succ
    threads = (cur_threads[ENTRY_ROW].to(torch.float32)
               + ent_prefix.to(torch.float32))

    qps_ok = (rt.qps < 0) | (pass_qps + batch.count.to(torch.float32) <= rt.qps)
    thr_ok = (rt.max_thread < 0) | (threads <= rt.max_thread)
    rt_ok = (rt.avg_rt < 0) | (cur_rt <= rt.avg_rt)

    # BBR gate on load: estimated capacity = maxSuccessQps * minRt / 1000,
    # with maxSuccessQps over the fresh folded minute buckets plus the
    # live staged second.
    spec_60s = W.WindowSpec(C.MINUTE_WINDOW_MS, C.MINUTE_BUCKETS)
    fresh = W.staleness_mask(w60, now_ms, spec_60s)
    bucket_succ = torch.where(
        fresh, w60.counts[:, C.MetricEvent.SUCCESS, ENTRY_ROW], 0
    ).to(torch.float32)
    max_succ_qps = torch.maximum(
        bucket_succ.max(),
        sec_counts[C.MetricEvent.SUCCESS, ENTRY_ROW].to(torch.float32),
    )
    min_rt = w1.min_rt[:, ENTRY_ROW].min().to(torch.float32)
    min_rt = torch.where(min_rt >= W.MIN_RT_EMPTY, 0.0, min_rt)
    bbr_ok = (threads <= 1.0) | (threads <= max_succ_qps * min_rt / 1000.0)
    load_ok = (rt.load < 0) | (signals[SIG_LOAD] <= rt.load) | bbr_ok

    cpu_ok = (rt.cpu < 0) | (signals[SIG_CPU] <= rt.cpu)

    ok = qps_ok & thr_ok & rt_ok & load_ok & cpu_ok
    return applicable & (~ok)
