"""The within-batch invariants of ``tests/test_flow_batch_semantics.py``
on one mixed numpy batch, the port against the JAX package.

``chip_smoke.py``'s reference phase builds this batch at the main path's
widths (2048 and 8192 lanes over 1,000 resources) and holds the card to
the port's CPU path bit for bit. Here the same construction
(``chip_smoke.invariant_run``) runs at width 64 over 60 resources on both
packages: a count-0 origin rule ahead of a shared QPS rule and of a
shared rate limiter, THREAD-grade lanes asking up to five tokens,
pre-passed and pre-blocked lanes, and open breakers, all in one
``check_batch`` of a numpy ``EntryBatch`` (the form ROADMAP C22 repairs).
The decisions and the state after it must be equal, and both must hold
the serial reference's invariants. One JAX width, one compile.
"""

from __future__ import annotations

import numpy as np

import sentinel_tpu as jst
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.batch import EntryBatch as JEntryBatch
from sentinel_tpu.core.batch import ExitBatch as JExitBatch

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.batch import EntryBatch as PEntryBatch
from sentinel_tpu_torch.core.batch import ExitBatch as PExitBatch

import chip_smoke as cs
from tests.test_torch_support import assert_tree_equal, jax_to_np, port_np

WIDTH = 64
RESOURCES = 60
CAPACITY = 512


def test_invariant_batch_matches_the_reference():
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()
    j = jst.SentinelEngine(CAPACITY, clock=cs.Clock(cs.INV_T0))
    p = pst.SentinelEngine(CAPACITY, device="cpu", clock=cs.Clock(cs.INV_T0))
    try:
        got_j, plan = cs.invariant_run(jst, j, JEntryBatch, JExitBatch, WIDTH,
                                       RESOURCES, cs.INV_SEED)
        got_p, plan_p = cs.invariant_run(pst, p, PEntryBatch, PExitBatch,
                                         WIDTH, RESOURCES, cs.INV_SEED)
        np.testing.assert_array_equal(plan_p, plan)
        for f in ("reason", "wait_us", "rule_slot"):
            np.testing.assert_array_equal(got_p[f], got_j[f], f)
        with j._lock, p._lock:
            assert_tree_equal(jax_to_np(j._state), port_np(p.state))
        assert cs.invariant_checks(got_p, plan) == []
        # The batch holds every kind of lane it is meant to.
        reason, kind = got_p["reason"], plan[:, 0] % 5
        assert (reason == C.BlockReason.DEGRADE).any()
        assert ((kind <= 1) & (plan[:, 1] == 1)).any()
        assert (got_p["wait_us"] > 0).any()
        assert ((kind == 2) & (plan[:, 2] > 1)).any()
        assert (plan[:, 3] == 1).any() and (plan[:, 4] == 1).any()
    finally:
        for ctx in (jctx, pctx):
            ctx.replace_context(None)
        p.close()
        j.close()
