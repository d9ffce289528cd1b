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


# -- the span and counter recorder (port only) --------------------------------

from sentinel_tpu_torch.metrics import profiling as prof  # noqa: E402
from sentinel_tpu_torch.metrics.timer import MetricTimerListener  # noqa: E402
from sentinel_tpu_torch.metrics.writer import MetricWriter  # noqa: E402
from sentinel_tpu_torch.utils.device import SYNCS  # noqa: E402

T0_MS = 1_700_000_000_000
MESH_RESOURCES = 8
MESH_WIDTH = 64


class _Clock:
    def __init__(self, now_ms: int):
        self.now = now_ms

    def __call__(self) -> int:
        return self.now


@pytest.fixture
def mesh():
    """An engine with a flow rule (QPS 3) and a hot-parameter rule (count
    2) on each of 8 resources and a system rule that never binds, so
    every rule slot and each of the three fixpoints runs; the recorder is
    stopped afterwards whatever the test did."""
    from sentinel_tpu_torch.core.engine import SentinelEngine
    from sentinel_tpu_torch.models import flow as F
    from sentinel_tpu_torch.models import param_flow as P
    from sentinel_tpu_torch.models import system as Y

    clock = _Clock(T0_MS)
    eng = SentinelEngine(capacity=256, device="cpu", clock=clock)
    names = [f"r{i}" for i in range(MESH_RESOURCES)]
    eng.flow_rules.load_rules([F.FlowRule(resource=n, count=3)
                               for n in names])
    eng.param_rules.load_rules([P.ParamFlowRule(n, param_idx=0, count=2)
                                for n in names])
    eng.system_rules.load_rules([Y.SystemRule(qps=1e12)])
    rows = np.array([eng.registry.cluster_row(n, entry_type=int(
        C.EntryType.IN)) for n in names], np.int32)
    eng.warmup(widths=[MESH_WIDTH])
    try:
        yield eng, clock, rows
    finally:
        prof.stop()
        eng.close()


def _round(eng, rows, counts=1):
    """One ``check_batch`` / ``harvest_decisions`` / ``complete_batch``
    round over every resource; returns the lanes that passed."""
    lane = np.arange(MESH_WIDTH)
    b = make_entry_batch_np(MESH_WIDTH)
    b["cluster_row"][:] = rows[lane % MESH_RESOURCES]
    b["count"][:] = counts
    b["entry_in"][:] = True
    b["param_present"][:, 0] = True
    b["param_hash"][:, 0] = lane
    reason, _ = eng.harvest_decisions(eng.check_batch(b))
    x = make_exit_batch_np(MESH_WIDTH)
    x["cluster_row"][:] = np.where(reason == 0, b["cluster_row"], -1)
    x["count"][:] = b["count"]
    x["entry_in"][:] = True
    x["param_present"][:, 0] = True
    eng.complete_batch(x)
    return int((reason == 0).sum())


def _mine(snap):
    """The calling thread's part of a snapshot."""
    import threading

    tid = threading.get_native_id()
    return next(t for t in snap["threads"] if t["tid"] == tid)


def test_recorder_off_records_nothing_reads_no_clock_allocates_nothing(
        mesh, monkeypatch):
    import tracemalloc

    eng, _, rows = mesh
    rec = prof.start()
    _round(eng, rows)
    prof.stop()
    before = rec.snapshot()
    clock_reads = []

    class _Time:
        @staticmethod
        def time_ns():
            clock_reads.append(1)
            return 0

    monkeypatch.setattr(prof, "time", _Time)
    tracemalloc.start()
    try:
        _round(eng, rows)
        allocated = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, prof.__file__)]).traces
    finally:
        tracemalloc.stop()
    assert prof.recorder is None
    assert rec.snapshot() == before
    assert clock_reads == [] and len(allocated) == 0


def test_one_round_gives_the_span_tree(mesh):
    eng, _, rows = mesh
    prof.start()
    _round(eng, rows)
    prof.stop()
    spans = _mine(prof.snapshot())["spans"]
    by_id = {s["id"]: s for s in spans}
    names = {s["id"]: s["name"] for s in spans}
    roots = [s["name"] for s in spans if s["parent"] is None]
    assert roots == ["check_batch", "harvest", "complete_batch"]
    children = {}
    for s in spans:
        if s["parent"] is not None:
            children.setdefault(names[s["parent"]], []).append(s["name"])
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
    assert children["check_batch"] == [
        "to_device", "step.entry", "telemetry.traces_submit",
        "telemetry.population"]
    assert children["step.entry"] == ["slot.authority", "slot.system",
                                      "slot.param", "slot.flow",
                                      "slot.degrade"]
    for slot in ("slot.system", "slot.param", "slot.flow"):
        assert children[slot] == ["fixpoint.sweep"]
    assert children["complete_batch"] == ["to_device", "step.exit"]
    # One step number for an entry step's spans and its harvest, the next
    # for the exit step's.
    step = {s["name"]: s["step"] for s in spans}
    entry = step["check_batch"]
    assert entry is not None and step["complete_batch"] == entry + 1
    assert {s["step"] for s in spans if s["name"] != "complete_batch"
            and not (s["parent"] is not None
                     and names[s["parent"]] == "complete_batch")} == {entry}
    assert step["step.exit"] == entry + 1


def test_syncs_by_site_sum_to_the_sync_count(mesh):
    eng, _, rows = mesh
    prof.start()
    before = SYNCS.count
    _round(eng, rows)
    delta = SYNCS.count - before
    counters = _mine(prof.snapshot())["counters"]
    prof.stop()
    sites = {k: v for k, v in counters.items() if k.startswith("sync.")}
    assert sum(sites.values()) == delta > 0
    assert sites["sync.step.roll_second"] == 2  # the entry and exit steps
    assert sites["sync.fixpoint.uniform"] == 3


@pytest.mark.parametrize("counts,least,most", [
    (1, 3, 3),     # uniform counts: one sweep a fixpoint
    (np.arange(MESH_WIDTH) % 3 + 1, 4, 3 * 12),  # mixed: re-sweeps
])
def test_fixpoint_sweeps_counted(mesh, counts, least, most):
    eng, _, rows = mesh
    prof.start()
    _round(eng, rows, counts)
    mine = _mine(prof.snapshot())
    prof.stop()
    sweeps = mine["counters"]["fixpoint.sweeps"]
    assert least <= sweeps <= most
    assert sweeps == sum(s["name"] == "fixpoint.sweep" for s in mine["spans"])
    assert mine["counters"].get("sync.fixpoint.converged", 0) == (
        0 if least == most else sweeps)


def test_timed_step_and_its_span_share_one_timing():
    """``timed_call`` reads the clock once before and once after the step:
    the same two reads make the ``step.<kind>`` span and the step timer's
    enqueue wall; ``timer=None`` (the batch API) records the span alone."""
    timer = StepTimer(ring=8, sync_every=1)
    rec = prof.start()
    try:
        assert timed_call(timer, "entry", 8, None, lambda x: x, 7) == 7
        assert timed_call(None, "exit", 8, None, lambda: None) is None
    finally:
        prof.stop()
    spans = {s["name"]: s for s in _mine(rec.snapshot())["spans"]}
    assert set(spans) == {"step.entry", "step.exit"}
    wall_ms = (spans["step.entry"]["end_ns"]
               - spans["step.entry"]["start_ns"]) / 1e6
    assert timer.snapshot()["entry"]["enqueueP50Ms"] == round(wall_ms, 3)
    assert "exit" not in timer.snapshot()


def test_step_timer_keeps_the_monotonic_clock(monkeypatch):
    """The wall clock may step (NTP): the step timer reads the monotonic
    clock, and the span takes only its start from the wall clock."""
    import time as _time

    class _SteppingWall:
        perf_counter_ns = staticmethod(_time.perf_counter_ns)
        steps = []

        @staticmethod
        def time_ns():
            _SteppingWall.steps.append(3600 * 10 ** 9)
            return _time.time_ns() + sum(_SteppingWall.steps)

    monkeypatch.setattr(prof, "time", _SteppingWall)
    timer = StepTimer(ring=8, sync_every=1)
    rec = prof.start()
    try:
        timed_call(timer, "entry", 8, None, lambda: None)
    finally:
        prof.stop()
    span = _mine(rec.snapshot())["spans"][0]
    wall_ms = (span["end_ns"] - span["start_ns"]) / 1e6
    snap = timer.snapshot()["entry"]
    assert len(_SteppingWall.steps) == 2  # the recorder's start, the span's
    assert 0 <= wall_ms < 1000 and snap["enqueueP50Ms"] == round(wall_ms, 3)
    assert snap["stepP50Ms"] < 1000


def test_spans_past_a_threads_capacity_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(prof, "SPAN_CAPACITY", 2)
    rec = prof.start()
    try:
        for name in ("a", "b", "c"):
            rec.close(rec.open(name))
    finally:
        prof.stop()
    mine = _mine(rec.snapshot())
    assert [s["name"] for s in mine["spans"]] == ["a", "b"]
    assert mine["dropped"] == 1


def test_seal_spans_lie_inside_the_tick_and_do_not_overlap(mesh, tmp_path):
    import time

    eng, clock, rows = mesh
    _round(eng, rows)
    clock.now += 2000
    timer = MetricTimerListener(eng, writer=MetricWriter(
        base_dir=str(tmp_path)))
    prof.start()
    t0 = time.time_ns()
    written = timer.tick()
    t1 = time.time_ns()
    prof.stop()
    timer.stop()
    assert written > 0
    seal = sorted((s for s in _mine(prof.snapshot())["spans"]
                   if s["name"].startswith("seal.")),
                  key=lambda s: s["start_ns"])
    assert [s["name"] for s in seal] == [
        "seal.flush_committer", "seal.read", "seal.nodes", "seal.write"]
    assert t0 <= seal[0]["start_ns"] and seal[-1]["end_ns"] <= t1
    for a, b in zip(seal, seal[1:]):
        assert a["start_ns"] <= a["end_ns"] <= b["start_ns"]


def test_span_clock_is_the_profilers(mesh):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        for _ in range(3):
            with torch.profiler.record_function("probe"):
                rec = prof.start()
                span = rec.open("probe")
                rec.close(span)
                prof.stop()
    kineto = p.profiler.kineto_results
    if not hasattr(kineto, "trace_start_ns"):
        pytest.skip("this torch's profiler does not give its clock's origin")
    starts = [kineto.trace_start_ns() + e.time_range.start * 1000
              for e in p.events() if e.name == "probe"]
    mine = [s["start_ns"] for t in prof.snapshot()["threads"]
            for s in t["spans"] if s["name"] == "probe"]
    assert len(starts) == 3 and len(mine) == 1  # the last recorder's
    assert abs(starts[-1] - mine[0]) < 5e6


def test_operator_trace_carries_every_threads_spans(mesh, tmp_path):
    import json
    import threading

    eng, _, rows = mesh

    def beside():
        rec = prof.recorder
        rec.close(rec.open("beside"))

    with prof.trace(str(tmp_path)):
        _round(eng, rows)
        t = threading.Thread(target=beside)
        t.start()
        t.join(timeout=10)
    assert prof.recorder is None
    with open(tmp_path / "trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "sentinel"]
    names = {e["name"] for e in ours}
    assert {"check_batch", "step.entry", "complete_batch",
            "beside"} <= names
    assert len({e["tid"] for e in ours}) >= 2
    # On the trace's clock: each check_batch span starts where the
    # profiler's own events of the same call do.
    cpu = [e for e in doc["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") != "sentinel"]
    first = min(e["ts"] for e in cpu)
    last = max(e["ts"] + e.get("dur", 0) for e in cpu)
    cb = next(e for e in ours if e["name"] == "check_batch")
    assert first - 5e3 <= cb["ts"] <= last


def test_stale_seal_between_steps_keeps_every_pass(mesh):
    """C26: a step of a later second that runs between the seal's start and
    its hold on the engine lock (here, inside the committer's flush) is
    not folded under the older second: the flight ring plus the staged
    second still hold every PASS the engine counted."""
    eng, clock, rows = mesh
    assert eng.state.flight is not None
    for _ in range(3):
        _round(eng, rows)
        clock.now += 400
    flush = eng._flush_committer

    def step_of_a_later_second():
        flush()
        clock.now += 1000
        _round(eng, rows)

    eng._flush_committer = step_of_a_later_second
    eng.seal_metrics()
    eng._flush_committer = flush
    for _ in range(4):
        _round(eng, rows)
        clock.now += 300
    state = eng.state
    p = int(C.MetricEvent.PASS)
    stamps = state.flight.stamps.numpy()
    ring = int(state.flight.events.numpy()[stamps >= 0][:, p].sum())
    staged = int(state.sec.counts.numpy()[p].sum())
    total = int(eng.telemetry_counts()["totals"][p].sum())
    assert total > 0 and ring + staged == total


def test_operator_trace_carries_every_threads_counters(mesh, tmp_path):
    import json
    import threading

    eng, _, rows = mesh
    with prof.trace(str(tmp_path)):
        _round(eng, rows)
    with open(tmp_path / "trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    mine = sorted((e for e in doc["traceEvents"] if e.get("ph") == "C"
                   and e.get("cat") == "sentinel"
                   and e["tid"] == threading.get_native_id()),
                  key=lambda e: e["ts"])
    assert len(mine) == 2 and mine[0]["name"] == mine[1]["name"]
    assert set(mine[0]["args"].values()) == {0}
    assert mine[1]["args"]["fixpoint.sweeps"] == 3
    assert mine[1]["args"]["sync.step.roll_second"] == 2


def test_trace_pump_splits_its_waits_from_its_python(mesh):
    eng, _, rows = mesh
    eng.traces.drain()  # the warm-up's batch, before recording
    prof.start()
    for _ in range(3):
        _round(eng, rows)
    eng.traces.drain()
    prof.stop()
    snap = prof.snapshot()
    spans = [s for t in snap["threads"] for s in t["spans"]
             if s["name"].startswith("pump.")]
    items = sum(t["counters"].get("pump.items", 0) for t in snap["threads"])
    process = {(s["id"], s["start_ns"]): s for s in spans
               if s["name"] == "pump.process"}
    assert items == len(process) == 3
    by_parent = {}
    for t in snap["threads"]:
        ids = {s["id"]: s for s in t["spans"]}
        for s in t["spans"]:
            if s["name"] in ("pump.wait", "pump.row_stats"):
                parent = ids[s["parent"]]
                assert parent["name"] == "pump.process"
                assert parent["start_ns"] <= s["start_ns"] \
                    <= s["end_ns"] <= parent["end_ns"]
                by_parent.setdefault((t["tid"], parent["id"]), []).append(
                    s["name"])
    assert sum(v.count("pump.wait") for v in by_parent.values()) == 3
    # Three rounds block more than 64 entries: one trace is sampled, and
    # its window read is the pump's engine read.
    assert eng.traces.snapshot(limit=0)["recorded"] >= 1
    assert sum(v.count("pump.row_stats") for v in by_parent.values()) >= 1


def test_lock_take_that_waits_is_a_span(mesh):
    import threading

    eng, _, rows = mesh
    held, free = threading.Event(), threading.Event()

    def holder():
        with eng._lock:
            held.set()
            free.wait(10)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(10)
    timer = threading.Timer(0.05, free.set)
    timer.start()
    prof.start()
    try:
        _round(eng, rows)
    finally:
        prof.stop()
        free.set()
        t.join(10)
    spans = _mine(prof.snapshot())["spans"]
    names = {s["id"]: s["name"] for s in spans}
    waits = [s for s in spans if s["name"] == "lock_wait"]
    # check_batch's take waited out the hold; the exit's found it free.
    assert [names[s["parent"]] for s in waits] == ["check_batch"]
    assert waits[0]["end_ns"] - waits[0]["start_ns"] >= 20e6


def test_lock_take_goes_through_a_wrapped_lock(mesh):
    """A caller may wrap the engine lock in a ``with``-only measuring
    lock: the engine's takes go through it, recorder on or off."""
    eng, _, rows = mesh

    class _WithOnly:
        def __init__(self, inner):
            self.inner, self.takes = inner, 0

        def __enter__(self):
            self.inner.acquire()
            self.takes += 1

        def __exit__(self, *exc):
            self.inner.release()

    inner = eng._lock
    eng._lock = wrapped = _WithOnly(inner)
    try:
        _round(eng, rows)
        off = wrapped.takes
        prof.start()
        _round(eng, rows)
        prof.stop()
    finally:
        eng._lock = inner
    assert off >= 2 and wrapped.takes == 2 * off
    assert not any(s["name"] == "lock_wait"
                   for s in _mine(prof.snapshot())["spans"])
