"""The port's step timing (``sentinel_tpu_torch/metrics/profiling.py``)
against the JAX package's ``StepTimer``, and the engine's use of it.

Both timers are fed the same ``record`` / ``record_pipeline`` sequences;
their ``snapshot()``, ``pipeline_snapshot()`` and ``duration_histogram()``
must be equal. The cases follow ``tests/test_observability.py``'s step
timer tests; the engine test runs the port alone on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest

from sentinel_tpu.core.config import \
    DEFAULT_PROFILE_SYNC_EVERY as J_DEFAULT_SYNC_EVERY
from sentinel_tpu.metrics.profiling import StepTimer as JStepTimer

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.batch import (make_entry_batch_np,
                                          make_exit_batch_np)
from sentinel_tpu_torch.core.config import DEFAULT_PROFILE_SYNC_EVERY
from sentinel_tpu_torch.metrics.profiling import StepTimer, timed_call
from sentinel_tpu_torch.utils import time_util


def both(ring, sync_every):
    return JStepTimer(ring=ring, sync_every=sync_every), \
        StepTimer(ring=ring, sync_every=sync_every)


def assert_same(j, p):
    assert p.snapshot() == j.snapshot()
    assert p.pipeline_snapshot() == j.pipeline_snapshot()
    assert p.duration_histogram() == j.duration_histogram()


def feed(timers, method, *args):
    for t in timers:
        getattr(t, method)(*args)


def test_records_and_samples():
    timers = both(4, 2)
    j, p = timers
    assert p.should_sync("entry") and j.should_sync("entry")
    feed(timers, "record", "entry", 8, 0.5, 1.5)
    assert not p.should_sync("entry")
    feed(timers, "record", "entry", 8, 0.6)
    assert p.should_sync("entry")
    snap = p.snapshot()["entry"]
    assert snap["dispatches"] == 2 and snap["entries"] == 16
    assert snap["stepSamples"] == 1 and snap["stepP50Ms"] == 1.5
    assert_same(j, p)
    # read-and-clear in one call, the histogram survives it
    assert p.snapshot(reset=True) == j.snapshot(reset=True)
    assert p.snapshot() == {} and p.duration_histogram()["entry"]["count"] == 1
    assert_same(j, p)
    feed(timers, "reset")
    assert p.snapshot() == {}
    assert_same(j, p)


def test_ring_bounded():
    timers = both(4, 1)
    for i in range(20):
        feed(timers, "record", "exit", 1, float(i), float(i))
    snap = timers[1].snapshot()["exit"]
    assert snap["dispatches"] == 20
    assert snap["stepP50Ms"] >= 16.0  # only the last 4 samples survive
    assert_same(*timers)


def test_reports_p95():
    timers = both(128, 1)
    for i in range(100):
        feed(timers, "record", "entry", 1, float(i), float(i))
    snap = timers[1].snapshot()["entry"]
    assert snap["stepP50Ms"] <= snap["stepP95Ms"] <= snap["stepP99Ms"]
    assert 90 <= snap["stepP95Ms"] <= 99
    assert_same(*timers)


def test_small_n_quantiles_are_exact():
    timers = both(128, 1)
    samples = [3.0, 9.0, 1.0, 7.0, 5.0, 2.0, 100.0]
    for s in samples:
        feed(timers, "record", "entry", 1, s, s)
    snap = timers[1].snapshot()["entry"]
    assert snap["stepP99Ms"] == snap["stepP95Ms"] == 100.0
    assert snap["stepP50Ms"] == 5.0  # the 4th order statistic
    assert_same(*timers)
    one = both(8, 1)
    feed(one, "record", "exit", 1, 4.25, 4.25)
    assert one[1].snapshot()["exit"]["stepP50Ms"] == 4.25
    assert_same(*one)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_agree(seed):
    """Mixed kinds, sampled and unsampled records, the histogram's edges
    and overflow, and pipeline harvests past the ring's bound."""
    rng = np.random.default_rng(seed)
    timers = both(32, 3)
    edges = [0.25, 0.5, 64.0, 4096.0, 5000.0]
    for _ in range(300):
        r = rng.random()
        kind = ("entry", "exit", "entry_pipelined")[int(rng.integers(3))]
        if r < 0.6:
            sync = timers[1].should_sync(kind)
            assert sync == timers[0].should_sync(kind)
            step = float(rng.choice(edges)) if rng.random() < 0.3 \
                else float(rng.exponential(20.0))
            feed(timers, "record", kind, int(rng.integers(1, 2049)),
                 float(rng.exponential(5.0)), step if sync else None)
        else:
            feed(timers, "record_pipeline", int(rng.integers(1, 4)),
                 float(rng.exponential(3.0)), float(rng.exponential(8.0)))
    assert_same(*timers)
    assert timers[1].pipeline_snapshot()["harvestedCycles"] > 32


def test_timed_call_records_enqueue_and_sampled_sync():
    t = StepTimer(ring=8, sync_every=2)
    waits = []
    assert timed_call(t, "entry", 8, lambda: waits.append(1), lambda x: x,
                      41) == 41  # sampled: the sync runs
    assert timed_call(t, "entry", 8, lambda: waits.append(1), lambda x: x,
                      42) == 42
    assert waits == [1]
    snap = t.snapshot()["entry"]
    assert snap["dispatches"] == 2 and snap["stepSamples"] == 1
    timed_call(t, "exit", 1, None, lambda: None)  # the CPU: no sync
    assert t.snapshot()["exit"]["stepSamples"] == 1


def test_sync_every_from_config(monkeypatch):
    assert DEFAULT_PROFILE_SYNC_EVERY == J_DEFAULT_SYNC_EVERY
    monkeypatch.setenv("CSP_SENTINEL_PROFILE_SYNCEVERY", "8")
    eng = pst.reset(capacity=64, device="cpu")
    assert eng.step_timer.sync_every == 8
    monkeypatch.setenv("CSP_SENTINEL_PROFILE_SYNCEVERY", "-3")
    eng = pst.reset(capacity=64, device="cpu")
    assert eng.step_timer.sync_every == DEFAULT_PROFILE_SYNC_EVERY
    monkeypatch.delenv("CSP_SENTINEL_PROFILE_SYNCEVERY")
    pst.reset(capacity=64, device="cpu").close()


def _dispatches(eng, kind):
    return eng.step_timer.snapshot().get(kind, {}).get("dispatches", 0)


def test_engine_times_every_dispatch_path():
    """The committer's flushes, the width-1 device path and the pipeline
    each land in ``step_timer``; the batch API does not (as the
    reference's ``check_batch`` / ``complete_batch``)."""
    time_util.freeze_time(1_700_000_000_000)
    pctx.replace_context(None)
    try:
        eng = pst.reset(capacity=256, device="cpu")
        pst.load_flow_rules([pst.FlowRule(resource="leased", count=100)])
        # A breaker keeps "dev" off the lease: the width-1 device path.
        pst.load_degrade_rules([pst.DegradeRule(
            resource="dev", count=100, grade=C.DEGRADE_GRADE_RT,
            time_window=10)])
        counts = [(_dispatches(eng, "entry"), _dispatches(eng, "exit"))]

        def moved():
            counts.append((_dispatches(eng, "entry"),
                           _dispatches(eng, "exit")))
            (e0, x0), (e1, x1) = counts[-2:]
            return e1 - e0, x1 - x0

        pst.entry("leased").exit()
        eng._flush_committer()  # the committer: one entry + one exit batch
        assert moved() == (1, 1)
        pst.entry("dev").exit()  # the width-1 device path
        assert moved() == (1, 1)
        eng.start_pipeline(max_batch=8, linger_s=0.0)
        pst.entry("dev").exit()
        pst.entry("leased").exit()  # the lease stands down: a cycle too
        eng.stop_pipeline()
        assert moved() == (2, 2)
        assert eng.pipeline_stats()["harvestedCycles"] == 2
        eng.check_batch(make_entry_batch_np(8))
        eng.complete_batch(make_exit_batch_np(8))
        assert moved() == (0, 0)
        snap = eng.step_timer.snapshot()
        assert snap["entry"]["stepSamples"] >= 1
        assert snap["entry"]["entries"] == 1 + 1 + 1 + 1
        eng.close()
    finally:
        pctx.replace_context(None)
        time_util.unfreeze_time()


def test_reference_caveat_reset_without_a_default_engine_keeps_contexts():
    """``reset()`` retires the thread's contexts only when a default engine
    existed before it (``sentinel_tpu/__init__.py:78-93``, copied as is):
    a pooled auto context that a directly built engine left on this thread
    survives a first ``reset()`` and carries that engine's entrance row
    into the new default engine."""
    saved = pst._default_engine
    pctx.replace_context(None)
    pctx.bump_generation()
    direct = eng = None
    try:
        pst._default_engine = None
        direct = pst.SentinelEngine(64, device="cpu")
        direct.entry("x").exit()
        pooled = pctx._auto_pool.get()
        assert pooled is not None and pooled.entrance_row >= 0
        eng = pst.reset(capacity=64, device="cpu")  # nothing to retire
        h = pst.entry("y")
        assert h.context is pooled  # the other engine's row, reused
        h.exit()
    finally:
        for e in (eng, direct):
            if e is not None:
                e.close()
        pctx.replace_context(None)
        pctx.bump_generation()
        pst._default_engine = saved



def test_batch_api_leaves_the_step_timer_as_the_reference():
    """``check_batch`` and ``complete_batch`` dispatch untimed in both
    packages: after the same batches, with one timed width-1 entry among
    them (the lease fast path off), both engines' ``step_timer``
    snapshots hold the same kinds, dispatches and entries."""
    from sentinel_tpu.core import context as jctx
    from sentinel_tpu.core.batch import EntryBatch as JEntryBatch
    from sentinel_tpu.core.batch import ExitBatch as JExitBatch
    from sentinel_tpu.core.config import config as jconfig
    from sentinel_tpu.core.engine import SentinelEngine as JEngine
    from sentinel_tpu.utils import time_util as jtu

    from sentinel_tpu_torch.core.config import config as pconfig

    lease = "csp.sentinel.lease.enabled"

    def run(make, cfg, ctx, tu, entry_cls, exit_cls):
        saved = cfg._config.get(lease)
        cfg.set(lease, "false")
        tu.freeze_time(1_700_000_000_000)
        ctx.replace_context(None)
        ctx.bump_generation()
        eng = make()
        try:
            snaps = [eng.step_timer.snapshot()]
            for k in range(3):
                now = tu.current_time_millis()
                eng.check_batch(entry_cls(make_entry_batch_np(8)), now_ms=now)
                eng.complete_batch(exit_cls(make_exit_batch_np(8)),
                                   now_ms=now)
                snaps.append(eng.step_timer.snapshot())
                if k == 1:
                    eng.entry("timed").exit()
                    snaps.append(eng.step_timer.snapshot())
            return [{kind: (row["dispatches"], row["entries"])
                     for kind, row in snap.items()} for snap in snaps]
        finally:
            eng.close()
            ctx.replace_context(None)
            tu.unfreeze_time()
            if saved is None:
                cfg._config.pop(lease, None)
            else:
                cfg.set(lease, saved)

    jax_out = run(lambda: JEngine(capacity=64), jconfig, jctx, jtu,
                  lambda b: JEntryBatch(**b), lambda b: JExitBatch(**b))
    port_out = run(lambda: pst.SentinelEngine(capacity=64, device="cpu"),
                   pconfig, pctx, time_util, lambda b: b, lambda b: b)
    assert port_out == jax_out
    assert port_out[0] == {} and port_out[1] == {}
    assert port_out[-1] == {"entry": (1, 1), "exit": (1, 1)}
