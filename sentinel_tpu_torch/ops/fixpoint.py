"""Survivor-fixpoint iteration for within-batch greedy admission (port of
``sentinel_tpu/ops/fixpoint.py``).

The flow, param-flow and system sweeps decide verdicts from within-batch
prefixes over a ``survivors`` set. With UNIFORM acquire counts the
serial-admitted set is a prefix of the candidates and two passes recover
it exactly. With MIXED counts this iterates ``S_{k+1} = candidate &
~blocked(S_k)``: the map is antitone, so odd iterates under- and even
iterates over-approximate the serial set. Every caller applies the map
once more for its final verdict, so on non-convergence this returns the
last EVEN iterate — the shipped decisions are then an ODD iterate, which
can only UNDER-admit (the safe direction).

JAX runs this as ``lax.cond`` + ``lax.while_loop`` on the device; here it
is a host loop, each predicate one counted sync (``utils/device.py``).
While the span recorder is on, each ``blocked_for`` evaluation is a
``fixpoint.sweep`` span and one ``fixpoint.sweeps`` count.
"""

from __future__ import annotations

import torch

from sentinel_tpu_torch.metrics import profiling as _prof
from sentinel_tpu_torch.utils.device import host_bool


def survivor_fixpoint(candidate: torch.Tensor, blocked_for,
                      counts: torch.Tensor, cap: int = 12,
                      relevant: torch.Tensor | None = None) -> torch.Tensor:
    """Resolve the survivor set for a batch.

    ``candidate`` bool[N]; ``blocked_for(survivors) -> bool[N]`` is one
    evaluation sweep; ``counts`` the per-entry acquire counts (uniform
    batches take the two-pass route); ``cap`` bounds the mixed-count loop;
    ``relevant`` narrows whose counts the uniformity check reads.
    Zero-width batches return ``candidate`` unchanged.
    """
    if candidate.shape[0] == 0:
        return candidate
    two_pass = _counts_uniform(
        candidate if relevant is None else candidate & relevant, counts)
    if host_bool(two_pass, "sync.fixpoint.uniform"):
        return candidate & (~_sweep(blocked_for, candidate))
    s = candidate
    last_even = candidate  # S0 is itself a valid even iterate
    k = 0
    done = False
    while not done and k < cap:
        s_next = candidate & (~_sweep(blocked_for, s))
        done = host_bool(torch.equal(s_next, s), "sync.fixpoint.converged")
        if k % 2 == 1:  # this computed S_{k+1}, even when k is odd
            last_even = s_next
        s = s_next
        k += 1
    return s if done else last_even


def _sweep(blocked_for, survivors: torch.Tensor) -> torch.Tensor:
    _prof.count("fixpoint.sweeps")
    with _prof.span("fixpoint.sweep"):
        return blocked_for(survivors)


def _counts_uniform(candidate: torch.Tensor, counts: torch.Tensor
                    ) -> torch.Tensor:
    """0-d bool: every candidate carries the same acquire count (no
    candidates -> True)."""
    c = counts.to(torch.int32)
    big = 1 << 30
    c_min = torch.where(candidate, c, big).min()
    c_max = torch.where(candidate, c, -big).max()
    return c_max <= c_min
