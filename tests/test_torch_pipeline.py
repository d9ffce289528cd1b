"""The port's pipelined admission (``sentinel_tpu_torch/core/pipeline.py``)
against the JAX package's, scenario by scenario from
``tests/test_pipeline.py`` and ``tests/test_lease.py``.

The harness is ``tests/test_torch_api.py``'s: one JAX engine and one port
engine (``device="cpu"``) for the whole module, both frozen at the same
epoch; every test starts on a whole second at least 100 s on with all
rule families re-pushed. Every pipeline here runs with ``max_batch=8`` on
both sides, so the JAX reference compiles only widths 1 and 8.

Parity tests run one script on each package (sequentially: each side's
collector, clock and contexts are its own) and hold the verdicts and
``node_snapshot()`` equal. Port-behavior tests hold the reference's
assertion on the port alone.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time

import numpy as np
import pytest

from sentinel_tpu.core import constants as JC

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core.engine import DeviceDispatchError
from sentinel_tpu_torch.log import record_log as plog

from tests.test_torch_api import Pair, _assert_close

MAX_BATCH = 8
FLOW = int(JC.BlockReason.FLOW)
RL = JC.CONTROL_BEHAVIOR_RATE_LIMITER


@pytest.fixture(scope="module")
def engines():
    pr = Pair()
    pr.open()
    yield pr
    pr.close()


@pytest.fixture
def pair(engines, request):
    if engines.broken:
        engines.close()
        engines.open()
    failed = request.session.testsfailed
    engines.start()
    yield engines
    for s in engines.sides:
        s.eng.stop_pipeline()
    if request.session.testsfailed > failed:
        engines.broken = True


@contextlib.contextmanager
def piped(side, **kw):
    kw.setdefault("max_batch", MAX_BATCH)
    pipe = side.eng.start_pipeline(**kw)
    try:
        yield pipe
    finally:
        side.eng.stop_pipeline()


def each(pair, script, **kw):
    """``script(side)`` on each package under its own pipeline;
    ``{side name: result}``."""
    out = {}
    for s in pair.sides:
        with piped(s, **kw):
            out[s.name] = script(s)
    return out


def snapshots_equal(pair):
    _assert_close(pair.p.eng.node_snapshot(), pair.j.eng.node_snapshot(),
                  "node_snapshot")


def _ticket_fields(side, resource, context="t_ctx"):
    """The fields dict ``_submit_entry`` builds, for direct ticket
    injection (saturates the collector without blocking callers)."""
    reg = side.eng.registry
    cr, dr, orow, oid = reg.resolve_entry(
        resource, context, "", reg.entrance_row(context), 0)
    return dict(cluster_row=cr, dn_row=dr, origin_row=orow, origin_id=oid,
                origin_named=False, context_id=reg.context_id(context),
                count=1, prioritized=False, entry_in=False,
                skip_cluster=False, pre_blocked=False, params=())


# ---------------------------------------------------------------------------
# Parity: the same script on both packages
# ---------------------------------------------------------------------------


def test_qps_quota_exact_under_pipeline(pair):
    pair.rules(flow=[dict(resource="p", count=10)])

    def script(s):
        got = []
        for _ in range(16):
            h = s.st.entry_ok("p")
            got.append(h is not None)
            if h:
                h.exit()
        return got

    out = each(pair, script, linger_s=0.0005)
    assert out["jax"] == out["port"] == [True] * 10 + [False] * 6
    pair.check()


def test_concurrent_callers_share_quota_exactly(pair):
    pair.rules(flow=[dict(resource="conc", count=25)])

    def script(s):
        results = []
        lock = threading.Lock()

        def worker():
            local = 0
            for _ in range(10):
                h = s.st.entry_ok("conc")
                if h:
                    local += 1
                    h.exit()
            with lock:
                results.append(local)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return sum(results)

    out = each(pair, script, linger_s=0.0005)
    assert out == {"jax": 25, "port": 25}  # 80 attempts, no overshoot
    snapshots_equal(pair)


def test_exit_lands_before_next_entry_for_thread_grade(pair):
    pair.rules(flow=[dict(resource="tg", count=1,
                          grade=JC.FLOW_GRADE_THREAD)])

    def script(s):
        got = []
        for _ in range(5):
            h = s.st.entry_ok("tg")
            got.append(h is not None)
            if h:
                h.exit()
        return got

    out = each(pair, script, linger_s=0.0005)
    assert out["jax"] == out["port"] == [True] * 5
    pair.check()


def test_pipeline_batches_concurrent_submissions(pair):
    pair.rules(flow=[dict(resource="b", count=1000)])

    def script(s):
        barrier = threading.Barrier(16)

        def worker():
            barrier.wait()
            for _ in range(5):
                h = s.st.entry_ok("b")
                if h:
                    h.exit()

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pipe = s.eng._pipeline
        return pipe.batched, pipe.cycles

    out = each(pair, script, linger_s=0.0005)
    for batched, cycles in out.values():
        assert batched > cycles  # some cycle carried more than one entry
        assert batched == 16 * 5
    snapshots_equal(pair)


@pytest.mark.parametrize("resource", ["s", "fast"])
def test_stop_pipeline_restores_sync_path_and_shares_quota(pair, resource):
    """``tests/test_pipeline.py:87`` ("s") and ``tests/test_lease.py:119``
    ("fast"): a pass served by the pipeline counts against the lease once
    the pipeline stops."""
    pair.rules(flow=[dict(resource=resource, count=2)])

    def script(s):
        got = []
        with piped(s):
            assert resource in s.eng._leases
            got.append(s.st.entry_ok(resource) is not None)  # device path
        got.append(s.st.entry_ok(resource) is not None)  # lease path
        got.append(s.st.entry_ok(resource) is not None)
        return got

    out = {s.name: script(s) for s in pair.sides}
    assert out["jax"] == out["port"] == [True, True, False]
    pair.check()


def test_double_buffer_engages_with_exact_fifo_verdicts(pair):
    pair.rules(flow=[dict(resource="deep", count=50)])

    def script(s):
        pipe = s.eng._pipeline
        tickets = [pipe.submit_entry(_ticket_fields(s, "deep"))
                   for _ in range(100)]
        for t in tickets:
            assert t.done.wait(10.0), "ticket never resolved"
        assert pipe.max_inflight >= 2, "double buffer never engaged"
        assert pipe.stats()["poolAllocated"] <= len(
            pipe.pool._free) + pipe.inflight_depth + 2
        return [t.reason for t in tickets]

    out = each(pair, script, linger_s=0.0)
    assert out["jax"] == out["port"] == [0] * 50 + [FLOW] * 50
    snapshots_equal(pair)


def _run_stream(s, ops, poison=None):
    """Drive a deterministic entry/exit stream on one side; the verdict
    per entry op. ``poison`` arms a one-shot dispatch failure on the first
    entry batch that carries that resource's row (the JAX engine's
    ``_entry_jit``, the port engine's ``_entry_step``)."""
    verdicts = []
    open_handles = {}
    attr = "_entry_jit" if s.name == "jax" else "_entry_step"
    orig = getattr(s.eng, attr)
    if poison is not None:
        prow = s.eng.registry.cluster_row(poison)
        armed = {"on": True}

        def poisoned(state, rules, batch, now, **kw):
            if armed["on"] and bool(np.any(
                    np.asarray(batch.cluster_row) == prow)):
                armed["on"] = False
                raise RuntimeError("injected mid-stream dispatch failure")
            return orig(state, rules, batch, now, **kw)

        setattr(s.eng, attr, poisoned)
    try:
        for op in ops:
            if op[0] == "advance":
                s.tu.advance_time(op[1])
            elif op[0] == "entry":
                _, key, res, count = op
                try:
                    open_handles[key] = s.st.entry(res, count=count)
                    verdicts.append("pass")
                except s.st.BlockException as ex:
                    verdicts.append(type(ex).__name__)
            elif op[0] == "exit":
                h = open_handles.pop(op[1], None)
                if h is not None:
                    h.exit()
        for h in open_handles.values():
            h.exit()
    finally:
        setattr(s.eng, attr, orig)
    return verdicts


def _stream_ops(seed: int, n: int = 90):
    """``tests/test_pipeline.py:_stream_ops``: three resources (QPS quota,
    THREAD gauge, rate-limited device path), mixed acquire counts, random
    holds and time advances."""
    rng = random.Random(seed)
    ops = []
    live = []
    for i in range(n):
        if rng.random() < 0.15:
            ops.append(("advance", rng.choice([1, 40, 300, 1000])))
        if live and rng.random() < 0.4:
            ops.append(("exit", live.pop(rng.randrange(len(live)))))
        res = rng.choice(["sa", "sa", "st_thread", "sr"])
        ops.append(("entry", i, res, rng.choice([1, 1, 2, 3])))
        live.append(i)
    return ops


STREAM_RULES = [
    dict(resource="sa", count=25),
    dict(resource="st_thread", count=3, grade=JC.FLOW_GRADE_THREAD),
    dict(resource="sr", count=40, control_behavior=RL,
         max_queueing_time_ms=0),
]


def _stream_both_modes(pair, ops, poison=None):
    """The stream synchronously, then pipelined, on both packages, each
    mode from a fresh whole second; verdicts by (side, pipelined)."""
    out = {}
    for pipelined in (False, True):
        pair.start()
        pair.rules(flow=STREAM_RULES)
        for s in pair.sides:
            fail_open = s.eng.fail_open_count
            if poison is not None:
                with s.st.entry(poison):  # resolve the poison row first
                    pass
            ctx = piped(s, linger_s=0.0005) if pipelined \
                else contextlib.nullcontext()
            with ctx:
                out[(s.name, pipelined)] = _run_stream(s, ops, poison)
            if poison is not None:
                assert s.eng.fail_open_count > fail_open, "fault never fired"
                s.eng._flush_committer()
                snap = s.eng.node_snapshot()
                # No lost exits: every gauge drained.
                for res in ("sa", "st_thread", "sr"):
                    assert snap.get(res, {}).get("curThreadNum", 0) == 0, res
        snapshots_equal(pair)
    return out


@pytest.mark.parametrize("seed", [
    11,
    pytest.param(23, marks=pytest.mark.slow),
    pytest.param(47, marks=pytest.mark.slow),
])
def test_async_pipeline_matches_sync_differential(pair, seed):
    out = _stream_both_modes(pair, _stream_ops(seed))
    want = out[("jax", False)]
    assert {k: v == want for k, v in out.items()} == {k: True for k in out}
    assert {"pass", "FlowException"} <= set(want)


def test_async_pipeline_mid_stream_fault_parity(pair):
    out = _stream_both_modes(pair, _stream_ops(31, n=60), poison="sr")
    want = out[("jax", False)]
    assert {k: v == want for k, v in out.items()} == {k: True for k in out}


# ---------------------------------------------------------------------------
# Port behavior (the reference's assertions on the port alone)
# ---------------------------------------------------------------------------


def test_cycle_error_fails_open_counted_and_logged(pair, caplog):
    pair.rules(flow=[dict(resource="fo", count=0)])  # blocks everything
    eng = pair.p.eng

    def boom(batch):
        raise RuntimeError("boom")

    eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0005)
    before = eng.fail_open_count
    eng._run_entry_batch = boom
    try:
        with caplog.at_level(logging.WARNING, logger="sentinel_tpu_torch"):
            with pst.entry("fo"):  # passes unguarded despite count=0
                pass
    finally:
        del eng._run_entry_batch
    assert eng.fail_open_count == before + 1
    assert any("UNGUARDED" in r.message for r in caplog.records)
    assert eng._pipeline.fail_open_cycles == 1


def test_sync_device_failure_fails_open_and_recovers(pair):
    pair.rules(flow=[dict(resource="dead", count=1, control_behavior=RL,
                          max_queueing_time_ms=0)])  # device path
    eng = pair.p.eng
    assert pst.entry_ok("dead")
    eng._flush_committer()

    def dying(*a, **kw):
        raise RuntimeError("device died mid-dispatch")

    before = eng.fail_open_count
    healthy, eng._entry_step = eng._entry_step, dying
    try:
        h = pst.entry_ok("dead")  # must not raise
        assert h is not None  # failed open
        assert eng.fail_open_count > before
        assert eng._state is None  # the state was dropped cold
        h.exit()  # the exit rebuilds cold and commits
    finally:
        eng._entry_step = healthy
    assert pst.entry_ok("dead") is not None  # protection on cold stats
    assert eng.node_snapshot()["dead"]["passQps"] >= 1


def test_exit_device_failure_never_breaks_caller(pair):
    pair.rules(flow=[dict(resource="dx", count=5, control_behavior=RL,
                          max_queueing_time_ms=1000)])
    eng = pair.p.eng
    h = pst.entry_ok("dx")
    assert h

    def dying(*a, **kw):
        raise RuntimeError("device died on exit")

    before = eng.fail_open_count
    healthy, eng._exit_step = eng._exit_step, dying
    try:
        h.exit()  # must not raise
    finally:
        eng._exit_step = healthy
    assert eng.fail_open_count > before


def test_pipeline_buffer_pool_recycles(pair):
    pair.rules(flow=[dict(resource="pool", count=1e9)])
    with piped(pair.p, linger_s=0.0) as pipe:
        for _ in range(6):  # warm: distinct widths allocate once
            assert pst.entry_ok("pool")
        before = pipe.pool.allocated
        for _ in range(40):
            assert pst.entry_ok("pool")
        assert pipe.pool.allocated == before, \
            "a steady-state cycle allocated a fresh staging buffer"
        assert pipe.pool.reused > 0


def test_harvest_failure_fails_tickets_open_and_recovers(pair):
    pair.rules(flow=[dict(resource="hv", count=0)])  # blocks everything
    eng = pair.p.eng
    eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0)
    orig = eng.harvest_decisions
    fired = {"n": 0}

    def dying_harvest(dec):
        if fired["n"] == 0:
            fired["n"] = 1
            with eng._lock:
                eng._state = None
            raise DeviceDispatchError("injected harvest death")
        return orig(dec)

    eng.harvest_decisions = dying_harvest
    try:
        before = eng.fail_open_count
        with pst.entry("hv"):  # blocked by count=0, unless failed open
            pass
        assert eng.fail_open_count > before
        assert eng._pipeline.fail_open_cycles == 1
        del eng.harvest_decisions  # healthy again: count=0 enforces
        assert pst.entry_ok("hv") is None
    finally:
        eng.__dict__.pop("harvest_decisions", None)


def test_harvest_failure_drops_state_cold_and_raises(pair):
    """The engine's own harvest: a verdict read that fails drops the state
    cold under the lock and raises ``DeviceDispatchError``."""
    pair.rules(flow=[dict(resource="hd", count=5)])
    eng = pair.p.eng
    with eng._lock:
        eng._ensure_compiled()
    assert eng.state is not None

    class Broken:
        @property
        def reason(self):
            raise RuntimeError("device lost")

    with pytest.raises(DeviceDispatchError):
        eng.harvest_decisions(Broken())
    assert eng.state is None


def test_stop_timeout_refuses_inline_drain(pair, monkeypatch):
    pair.rules(flow=[dict(resource="hang", count=1e9)])
    eng = pair.p.eng
    pipe = eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0)
    pipe.join_timeout_s = 0.2
    release = threading.Event()
    entered = threading.Event()
    orig_cycle = pipe._cycle

    def hanging_cycle(items):
        entered.set()
        release.wait(10.0)
        orig_cycle(items)

    pipe._cycle = hanging_cycle
    warnings = []
    monkeypatch.setattr(plog.record_log, "warn",
                        lambda msg, *a: warnings.append(msg % a if a else msg))
    ticket = pipe.submit_entry(_ticket_fields(pair.p, "hang"))
    assert entered.wait(5.0), "the collector never picked the ticket up"
    t0 = time.perf_counter()
    eng.stop_pipeline()  # the join times out: must refuse the drain
    assert time.perf_counter() - t0 < 5.0
    assert any("refusing inline drain" in w for w in warnings), warnings
    assert not ticket.done.is_set()  # nothing double-drained it
    release.set()  # the collector finishes; the straggler lands
    assert ticket.done.wait(10.0)
    assert ticket.reason == 0


def test_shutdown_with_cycles_in_flight_resolves_every_ticket(pair):
    pair.rules(flow=[dict(resource="sfl", count=1e9)])
    eng = pair.p.eng
    pipe = eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0)
    tickets = [pipe.submit_entry(_ticket_fields(pair.p, "sfl"))
               for _ in range(64)]
    eng.stop_pipeline()  # races the collector mid-stream
    for t in tickets:
        assert t.done.is_set(), "ticket unresolved after stop()"
        assert t.reason in (0, -2)
    assert pipe.inflight_depth_now() == 0
    assert pipe._thread is None
    harvests = pipe.harvests
    time.sleep(0.05)
    assert pipe.harvests == harvests, "a harvest ran after stop() returned"


def test_shutdown_midstream_concurrency_gauge_drains(pair):
    pair.rules(flow=[dict(resource="sg", count=1e9)])
    eng = pair.p.eng
    eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0005)

    def worker():
        for _ in range(40):
            h = pst.entry_ok("sg")
            if h:
                h.exit()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    eng.stop_pipeline()  # mid-stream
    for t in threads:
        t.join()
    eng._flush_committer()
    assert eng.node_snapshot()["sg"]["curThreadNum"] == 0


def test_pipeline_stats_monotone_across_generations(pair):
    pair.rules(flow=[dict(resource="ps", count=1e9)])
    eng = pair.p.eng
    eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0)
    for _ in range(5):
        assert pst.entry_ok("ps")
    eng.stop_pipeline()
    first = eng.pipeline_stats()
    assert first["cycles"] >= 1 and not first["active"]
    assert first["harvestedCycles"] >= first["cycles"]
    eng.start_pipeline(max_batch=MAX_BATCH, linger_s=0.0)
    assert pst.entry_ok("ps")
    second = eng.pipeline_stats()
    assert second["active"] and second["cycles"] > first["cycles"]
    for k in ("batched", "harvests", "poolReused", "inflightDepthMax"):
        assert second[k] >= first[k], k
    eng.stop_pipeline()
    assert eng.pipeline_stats()["cycles"] == second["cycles"]


def test_cpu_engine_stages_in_plain_numpy(pair):
    """On the CPU the pool's buffers are plain (unpinned) numpy views,
    and the engine stays on the device it was built for."""
    pair.rules(flow=[dict(resource="cpu", count=10)])
    eng = pair.p.eng
    with piped(pair.p, linger_s=0.0) as pipe:
        assert pst.entry_ok("cpu")
        assert not pipe.pool.pinned
        buf = pipe.pool.acquire("entry", 8)
        assert not buf.block.is_pinned()
        assert all(isinstance(a, np.ndarray) for a in buf.values())
        assert buf["param_hash"].dtype == np.int64
        assert int(buf["cluster_row"][0]) == -1  # padding default
        pipe.pool.release("entry", buf)
        assert eng.device.type == "cpu"
        assert eng.state.w1.counts.device.type == "cpu"


@pytest.mark.parametrize("kind", ["entry", "exit"])
@pytest.mark.parametrize("width", [1, 8, 64])
def test_staging_buffer_matches_the_allocator_and_round_trips(kind, width):
    """A pool buffer reads exactly like a fresh ``make_*_batch_np`` dict
    (``param_hash`` widened to int64), copies to a batch field by field,
    and ``reset()`` restores every padding default."""
    from sentinel_tpu_torch.core.batch import (StagingBuffer,
                                               make_entry_batch_np,
                                               make_exit_batch_np, to_device)

    fresh = (make_entry_batch_np if kind == "entry"
             else make_exit_batch_np)(width)
    buf = StagingBuffer(kind, width, pinned=False)
    assert set(buf) == set(fresh)
    for k, want in fresh.items():
        np.testing.assert_array_equal(buf[k], want.astype(buf[k].dtype), k)
    rng = np.random.default_rng(width)
    for k, a in buf.items():
        a[...] = rng.integers(0, 2, size=a.shape) if a.dtype == bool \
            else rng.integers(-5, 2**31 - 1, size=a.shape)
    buf["param_hash"][0, 0] = 2**32 - 1  # a uint32 hash's top value
    batch = to_device(buf, "cpu")
    for k in fresh:
        np.testing.assert_array_equal(getattr(batch, k).numpy(), buf[k], k)
    buf.reset()
    for k, want in fresh.items():
        np.testing.assert_array_equal(buf[k], want.astype(buf[k].dtype), k)
    # the CPU batch is a copy: resetting the buffer left it as staged
    assert int(batch.param_hash[0, 0]) == 2**32 - 1
