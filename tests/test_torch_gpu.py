"""Card-only tests of the port (marker ``gpu``): the segmented-prefix CUDA
kernels (block sort and tile walk) against the plain version and each
other, the fused step on ``cuda`` against the same step on ``cpu``, and the
``st.entry`` path on the card: the native lease ring, the stats committer
flushing from its thread and drained by ``close()``, and the device path
launching the kernel at width 1; and pipelined admission on the card: pinned
staging buffers released only after their cycle's harvest, the same
verdicts as on the CPU, a clean stop with cycles in flight, the trace pump
reading verdicts from a CUDA engine, and a retune resetting the window on
the card; and the boot surface: a config-seeded engine, checkpoints
crossing between the card and the CPU bit for bit, the checkpoint timer
saving from its own thread while another dispatches, torch device
checkers deciding as on the CPU (and a verdict on the host refused), and
no host sync added by the splice; and staged rollout: an engine with a
candidate in shadow and in canary deciding as on the CPU (the shadow world
included), the canary hash on the card over the int32 edges, the host
syncs unchanged with no candidate, and the kernel's launches with one; and
the cluster token path: the acquire kernel bit-equal to its plain form at
every width and status, the wrapper's refusals, a raised error (never a
fallback) when the build or a launch fails, and a port server on the card
answering a client as one on the CPU does; and the pod: four shards on the
card deciding as on the CPU, leaf for leaf, and the distributed driver
over NCCL at world size 1 equal to gloo on the CPU and to the one-process
driver; and the control plane: the SLO evaluation, the waterfall's seal
and the adaptive tick add no sync or launch to a step.

Whether a card exists is decided inside the fixture, never at import, so
every pytest worker collects the same tests; without a card they skip.
On the H100 run them with::

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


# Id patterns a radix sort gets wrong, beside the engine-like random ids:
# repeats of INT32_MIN, INT32_MAX, -1, -7, 0 and large keys of both signs;
# distinct keys spread over the whole int32 range; one key (INT32_MIN).
PATTERNS = ("random", "full_int32", "all_distinct", "all_equal")
_I32 = np.iinfo(np.int32)


def _ids(pattern, k, n, rng):
    if pattern == "random":
        return rng.integers(-1, max(2, n // 8), size=(k, n)).astype(np.int32)
    if pattern == "full_int32":
        pool = np.concatenate([
            [_I32.min, _I32.max, -1, -7, 0],
            rng.integers(2**30, _I32.max, size=8),
            rng.integers(_I32.min + 1, -2**30, size=8)])
        return rng.choice(pool, size=(k, n)).astype(np.int32)
    if pattern == "all_distinct":
        step = (2**32 - 1) // n
        return np.stack([rng.permutation(n).astype(np.int64) * step + _I32.min
                         for _ in range(k)]).astype(np.int32)
    return np.full((k, n), _I32.min, np.int32)


def _inputs(cuda, pattern, n, k, m, seed):
    rng = np.random.default_rng(seed)
    ids = _ids(pattern, k, n, rng)
    vals = rng.integers(0, 257, size=(k, n, m)).astype(np.float32)
    return torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,k,m", [(1, 1, 1), (8, 3, 2), (127, 1, 2),
                                   (129, 3, 1), (1000, 3, 2), (2048, 3, 2),
                                   (8192, 1, 2), (300, 2, 2), (513, 1, 1),
                                   (1025, 2, 2), (2049, 1, 2), (4097, 3, 1),
                                   (8191, 1, 2), (8192, 3, 1), (8193, 1, 2),
                                   (16384, 1, 2)])
def test_kernel_bit_equal_to_plain(cuda, n, k, m, pattern):
    """Both sides of the single-block capacity (8192): the block sort up to
    it, the tile walk above it, chosen by N alone; and both sides of each
    keys-per-thread step of the block sort (512, 1024, 2048, 4096)."""
    from sentinel_tpu_torch.ops import prefix_cuda
    from sentinel_tpu_torch.ops.segment import segmented_prefix_plain

    ids_t, vals_t = _inputs(cuda, pattern, n, k, m, n * 10 + k)
    before = prefix_cuda.launches
    tiles_before = prefix_cuda.tile_launches
    prefix, first = prefix_cuda.segmented_prefix_cuda(ids_t, vals_t)
    torch.cuda.synchronize()
    assert prefix_cuda.launches == before + 1
    tiles = n > prefix_cuda.block_capacity()
    assert prefix_cuda.tile_launches == tiles_before + tiles
    for kk in range(k):
        want_p, want_f = segmented_prefix_plain(ids_t[kk], vals_t[kk])
        assert torch.equal(prefix[kk], want_p)
        assert torch.equal(first[kk], want_f)


def test_block_capacity_is_8192(cuda):
    from sentinel_tpu_torch.ops import prefix_cuda

    assert prefix_cuda.block_capacity() == 8192


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,k,m", [(64, 2, 1), (2048, 3, 2), (5000, 1, 2),
                                   (8192, 2, 1)])
def test_block_sort_matches_tiles(cuda, n, k, m, pattern):
    """The two paths agree bit for bit where both can run."""
    from sentinel_tpu_torch.ops import prefix_cuda

    ids_t, vals_t = _inputs(cuda, pattern, n, k, m, n + 7 * k)
    tiles_before = prefix_cuda.tile_launches
    block_p, block_f = prefix_cuda.segmented_prefix_cuda(ids_t, vals_t)
    assert prefix_cuda.tile_launches == tiles_before
    tile_p, tile_f = prefix_cuda.segmented_prefix_tiles_cuda(ids_t, vals_t)
    assert prefix_cuda.tile_launches == tiles_before + 1
    torch.cuda.synchronize()
    assert torch.equal(block_p, tile_p)
    assert torch.equal(block_f, tile_f)


def test_kernel_replays_in_a_cuda_graph(cuda):
    """The launcher neither syncs nor allocates: it captures and replays."""
    from sentinel_tpu_torch.ops import prefix_cuda
    from sentinel_tpu_torch.ops.segment import segmented_prefix_plain

    ids_t, vals_t = _inputs(cuda, "full_int32", 8192, 3, 2, 5)
    prefix_cuda.segmented_prefix_cuda(ids_t, vals_t)  # build, load, allow
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prefix, first = prefix_cuda.segmented_prefix_cuda(ids_t, vals_t)
    vals_t.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    for kk in range(3):
        want_p, want_f = segmented_prefix_plain(ids_t[kk], vals_t[kk])
        assert torch.equal(prefix[kk], want_p)
        assert torch.equal(first[kk], want_f)


def test_kernel_rejects_bad_inputs(cuda):
    from sentinel_tpu_torch.ops import prefix_cuda

    ids = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        prefix_cuda.segmented_prefix_cuda(
            ids, torch.zeros((1, 8, 2), device=cuda))
    ids = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        prefix_cuda.segmented_prefix_cuda(
            ids, torch.zeros((1, 8, 9), device=cuda))
    with pytest.raises(ValueError):
        prefix_cuda.segmented_prefix_cuda(
            ids, torch.zeros((1, 16, 2), device=cuda)[:, ::2])


def test_width_zero_launches_nothing(cuda):
    from sentinel_tpu_torch.ops import prefix_cuda

    before = prefix_cuda.launches
    p, f = prefix_cuda.segmented_prefix_cuda(
        torch.zeros((3, 0), dtype=torch.int32, device=cuda),
        torch.zeros((3, 0, 2), device=cuda))
    assert p.shape == (3, 0, 2) and f.shape == (3, 0)
    assert prefix_cuda.launches == before


def test_step_on_cuda_matches_cpu(cuda):
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.batch import (
        make_entry_batch_np, make_exit_batch_np)
    from sentinel_tpu_torch.core.engine import SentinelEngine
    from sentinel_tpu_torch.models import degrade as D
    from sentinel_tpu_torch.models import flow as F
    from sentinel_tpu_torch.models import param_flow as P

    runs = {}
    for dev in (cuda, torch.device("cpu")):
        now = [1_700_000_000_000]
        eng = SentinelEngine(capacity=512, device=dev, clock=lambda: now[0])
        reg = eng.registry
        ent = reg.entrance_row("sentinel_default_context")
        rows = [(reg.cluster_row(f"r{i}"),
                 reg.default_row("sentinel_default_context", f"r{i}", ent))
                for i in range(40)]
        eng.flow_rules.load_rules([
            F.FlowRule(f"r{i}", count=2 + i % 3, control_behavior=i % 4,
                       warm_up_period_sec=2, max_queueing_time_ms=200)
            for i in range(0, 40, 2)])
        eng.degrade_rules.load_rules([
            D.DegradeRule(f"r{i}", count=1, grade=2, time_window=1,
                          min_request_amount=1) for i in range(1, 40, 4)])
        eng.param_rules.load_rules([P.ParamFlowRule(f"r{i}", 0, count=2)
                                    for i in range(3, 40, 4)])
        rng = np.random.default_rng(1)
        decs = []
        for step in range(6):
            now[0] += 230
            b = make_entry_batch_np(256)
            pick = rng.integers(0, 40, size=256)
            b["cluster_row"][:] = [rows[p][0] for p in pick]
            b["dn_row"][:] = [rows[p][1] for p in pick]
            b["count"][:] = rng.integers(1, 3, size=256) if step == 2 else 1
            b["param_hash"][:, 0] = rng.integers(1, 6, size=256)
            b["param_present"][:, 0] = True
            dec = eng.check_batch(b)
            reason = dec.reason.cpu().numpy()
            decs.append([getattr(dec, f).cpu().numpy() for f in dec._fields])
            x = make_exit_batch_np(256)
            x["cluster_row"][:] = np.where(reason == 0, b["cluster_row"], -1)
            x["dn_row"][:] = b["dn_row"]
            x["count"][:] = b["count"]
            x["success"][:] = reason == 0
            x["error"][:] = rng.random(256) < 0.3
            x["rt_ms"][:] = rng.integers(1, 50, size=256)
            now[0] += 5
            eng.complete_batch(x)
        runs[dev.type] = (decs, convert.state_to_numpy(eng.state))
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def cmp(x, y):
        for k in x:
            if isinstance(x[k], dict):
                cmp(x[k], y[k])
            elif x[k].dtype.kind == "f":
                np.testing.assert_allclose(x[k], y[k], rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(x[k], y[k])
    cmp(*[runs[d][1] for d in ("cuda", "cpu")])


# -- the st.entry path on the card -----------------------------------------


@pytest.fixture
def api(cuda):
    """The port's module API on a fresh default engine on the card."""
    import sentinel_tpu_torch as st

    eng = st.reset(capacity=512)
    assert eng.device.type == "cuda"
    yield st
    eng.close()


def test_native_lease_ring_builds(api):
    eng = api.get_engine()
    assert eng.lease_ring == "native"
    api.load_flow_rules([api.FlowRule(resource="fast", count=5)])
    assert eng._leases["fast"].native


def test_committer_flushes_on_cuda_from_its_thread(api):
    """Leased and unruled traffic reach the card through the committer's
    own thread, which launches the prefix kernel at the flush's width."""
    import threading
    import time

    from sentinel_tpu_torch.ops import prefix_cuda

    eng = api.get_engine()
    api.load_flow_rules([api.FlowRule(resource="fast", count=1000)])
    eng.warmup((1, 8))
    threads = []
    run = eng._run_entry_batch

    def recorded(batch):
        threads.append(threading.current_thread().name)
        return run(batch)

    eng._run_entry_batch = recorded
    before = prefix_cuda.launches
    for res in ("fast", "free") * 3:
        with api.entry(res):
            pass
    committer = eng.committer
    deadline = time.monotonic() + 30
    while committer.pending() != (0, 0) or committer.flushes == 0:
        assert time.monotonic() < deadline, "committer never flushed"
        time.sleep(0.01)
    with committer._flush_lock:  # the background flush has dispatched
        pass
    assert threads and set(threads) == {"sentinel-torch-stats-committer"}
    assert prefix_cuda.launches > before
    snap = eng.node_snapshot()
    assert snap["fast"]["passQps"] == 3 and snap["free"]["passQps"] == 3
    assert snap["fast"]["curThreadNum"] == 0


def test_close_drains_the_committer(api):
    eng = api.get_engine()
    api.load_flow_rules([api.FlowRule(resource="fast", count=1000)])
    committer = None
    for _ in range(50):
        with api.entry("fast"):
            pass
        committer = eng.committer
    eng.close()
    assert eng.committer is None
    assert committer.pending() == (0, 0)
    assert committer._thread is None
    totals = eng.state.telemetry.totals.sum() + eng.state.sec.counts.sum()
    assert int(totals) > 0


def test_device_path_launches_the_kernel_at_width_one(api):
    from sentinel_tpu_torch.ops import prefix_cuda

    eng = api.get_engine()
    api.load_degrade_rules([api.DegradeRule(resource="d", count=1,
                                            time_window=1)])
    with api.entry("d"):
        pass
    before, tiles = prefix_cuda.launches, prefix_cuda.tile_launches
    with api.entry("d"):
        pass
    assert prefix_cuda.launches > before
    assert prefix_cuda.tile_launches == tiles
    assert eng.fail_open_count == 0


# -- pipelined admission on the card ----------------------------------------


def test_pipeline_stages_in_pinned_buffers_released_after_harvest(
        api, monkeypatch):
    """Every staging buffer is pinned, and none goes back to the pool (or
    out again) before the harvest of the cycle whose copy may read it."""
    import threading

    from sentinel_tpu_torch.core.batch import BatchBufferPool

    eng = api.get_engine()
    api.load_degrade_rules([api.DegradeRule(resource="d", count=1e9,
                                            time_window=1)])
    eng.warmup((1, 8))
    pipe = eng.start_pipeline(max_batch=8, linger_s=0.0)
    assert pipe.pool.pinned
    out_now = set()   # buffers handed out and not yet released
    harvested = set()  # buffers whose cycle has harvested
    bufs_of = {}       # staged verdicts -> the buffers of their record
    errors = []
    acquire, release = BatchBufferPool.acquire, BatchBufferPool.release
    flush, harvest = pipe._flush_entries, eng.harvest_decisions

    def acquired(pool, kind, width):
        buf = acquire(pool, kind, width)
        if id(buf) in out_now or not buf.block.is_pinned():
            errors.append(("reacquired or unpinned", kind, width))
        out_now.add(id(buf))
        return buf

    def released(pool, kind, buf):
        if id(buf) not in harvested:
            errors.append(("released before its harvest", kind))
        harvested.discard(id(buf))
        out_now.discard(id(buf))
        release(pool, kind, buf)

    def flushed(entries, exit_bufs):
        flush(entries, exit_bufs)
        rec = pipe._inflight[-1]
        bufs_of[id(rec.dec)] = [id(b) for _, b in rec.bufs]

    def harvested_(dec):
        out = harvest(dec)
        harvested.update(bufs_of.pop(id(dec), ()))
        return out

    monkeypatch.setattr(BatchBufferPool, "acquire", acquired)
    monkeypatch.setattr(BatchBufferPool, "release", released)
    pipe._flush_entries, eng.harvest_decisions = flushed, harvested_

    def worker():
        for _ in range(12):
            with api.entry("d"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    eng.stop_pipeline()
    assert not errors, errors[:5]
    assert pipe.batched == 16 * 12 and pipe.batched > pipe.cycles
    assert pipe.max_inflight >= 2
    assert int(eng.state.cur_threads.sum()) == 0
    assert eng.fail_open_count == 0


def test_pipelined_verdicts_on_cuda_equal_cpu(cuda):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.utils import time_util

    from chip_smoke import run_stream, stream_ops, stream_rules

    ops = stream_ops(11)
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            time_util.freeze_time(1_700_000_000_000)
            eng = st.reset(capacity=512, device=dev)
            st.load_flow_rules(stream_rules())
            eng.start_pipeline(max_batch=8, linger_s=0.0005)
            verdicts = run_stream(ops)
            eng.stop_pipeline()
            runs[dev] = (verdicts, eng.node_snapshot())
            assert eng.fail_open_count == 0
            eng.close()
    finally:
        time_util.unfreeze_time()
    assert runs["cuda"][0] == runs["cpu"][0]
    assert {"pass", "FlowException"} <= set(runs["cuda"][0])
    for res, row in runs["cuda"][1].items():
        for k, v in row.items():
            assert v == pytest.approx(runs["cpu"][1][res][k], rel=1e-6), \
                (res, k)


def test_stop_with_cycles_in_flight_resolves_every_ticket(api):
    import time

    from chip_smoke import ticket_fields

    eng = api.get_engine()
    api.load_flow_rules([api.FlowRule(resource="sfl", count=1e9)])
    eng.warmup((1, 8))
    pipe = eng.start_pipeline(max_batch=8, linger_s=0.0)
    tickets = [pipe.submit_entry(ticket_fields(eng, "sfl"))
               for _ in range(64)]
    eng.stop_pipeline()
    for t in tickets:
        assert t.done.is_set() and t.reason in (0, -2)
    assert pipe.inflight_depth_now() == 0 and pipe._thread is None
    harvests = pipe.harvests
    time.sleep(0.05)
    assert pipe.harvests == harvests


@pytest.fixture
def frozen():
    from sentinel_tpu_torch.utils import time_util

    time_util.freeze_time(time_util.current_time_millis())
    yield time_util
    time_util.unfreeze_time()


def test_trace_pump_records_from_a_cuda_engine(api, frozen):
    from sentinel_tpu_torch.telemetry.trace_ring import DecisionTraceBuffer

    eng = api.get_engine()
    eng.traces.stop()
    eng.traces = DecisionTraceBuffer(eng, sample_every=1, capacity=16)
    api.load_flow_rules([api.FlowRule(resource="tb", count=2)])
    eng.start_pipeline(max_batch=8, linger_s=0.0)
    got = [api.entry_ok("tb") is not None for _ in range(5)]
    eng.stop_pipeline()
    assert got == [True, True, False, False, False]
    eng.traces.drain()
    snap = eng.traces.snapshot()
    assert snap["errors"] == 0 and snap["recorded"] == 3
    assert {t["resource"] for t in snap["traces"]} == {"tb"}
    assert snap["traces"][0]["reason"] == "FLOW"
    assert snap["traces"][0]["window"]["blockQps"] >= 1


def test_retune_resets_the_window_on_the_card(api, frozen):
    eng = api.get_engine()
    api.load_flow_rules([api.FlowRule(resource="geo", count=3)])
    for _ in range(3):
        assert api.entry_ok("geo")
    eng._flush_committer()
    assert int(eng.state.w1.counts.sum()) > 0
    eng.set_window_geometry(2000, 4)
    w1 = eng.state.w1
    assert w1.counts.device.type == "cuda" and w1.counts.shape[0] == 4
    assert int(w1.counts.sum()) == 0
    assert eng.state.occupied_next.device.type == "cuda"
    assert int(eng.state.occupied_stamp) == -1
    got = [api.entry_ok("geo") is not None for _ in range(7)]
    assert got == [True] * 5 + [False] * 2


# -- the once-per-second fold on the card ------------------------------------


def _fold_run(dev, rounds=12, width=64, flight=None):
    """Batches across second boundaries on a fresh engine; (timeseries
    view, state as numpy, host syncs of the steps, step dispatches)."""
    from sentinel_tpu_torch import convert
    from sentinel_tpu_torch.core.batch import (
        make_entry_batch_np, make_exit_batch_np)
    from sentinel_tpu_torch.core.config import (
        TELEMETRY_TIMESERIES_SECONDS, config)
    from sentinel_tpu_torch.core.engine import SentinelEngine
    from sentinel_tpu_torch.models import flow as F
    from sentinel_tpu_torch.utils.device import SYNCS

    if flight is not None:
        config.set(TELEMETRY_TIMESERIES_SECONDS, str(flight))
    try:
        now = [1_700_000_000_000]
        eng = SentinelEngine(capacity=256, device=dev, clock=lambda: now[0])
    finally:
        config.set(TELEMETRY_TIMESERIES_SECONDS, "")
    rows = [eng.registry.cluster_row(f"f{i}") for i in range(20)]
    eng.flow_rules.load_rules([F.FlowRule(f"f{i}", count=3)
                               for i in range(0, 20, 2)])
    rng = np.random.default_rng(3)
    eng.warmup((width,))
    SYNCS.count = 0
    for _ in range(rounds):
        now[0] += 310
        b = make_entry_batch_np(width)
        b["cluster_row"][:] = rng.choice(rows, size=width)
        reason = eng.harvest_decisions(eng.check_batch(b))[0]
        x = make_exit_batch_np(width)
        x["cluster_row"][:] = np.where(reason == 0, b["cluster_row"], -1)
        x["count"][:] = 1
        x["success"][:] = reason == 0
        x["rt_ms"][:] = rng.integers(1, 900, size=width)
        eng.complete_batch(x)
    syncs = SYNCS.count
    dispatches = {k: v["dispatches"]
                  for k, v in eng.step_timer.snapshot().items()}
    view = eng.timeseries_view(now_ms=now[0])
    state = convert.state_to_numpy(eng.state)
    eng.close()
    return view, state, syncs, dispatches


def test_flight_ring_and_spill_on_cuda_equal_cpu(cuda):
    from chip_smoke import compare_states

    cv, cuda_state, _, _ = _fold_run(cuda)
    pv, cpu_state, _, _ = _fold_run(torch.device("cpu"))
    assert len(cv["seconds"]) >= 2
    assert cv == pv
    assert "flight" in cuda_state
    compare_states(cuda_state, cpu_state)


def test_flight_ring_fold_adds_no_host_sync(cuda):
    _, with_ring, syncs_on, disp_on = _fold_run(cuda)
    _, without, syncs_off, disp_off = _fold_run(cuda, flight=0)
    assert "flight" in with_ring and "flight" not in without
    assert syncs_on == syncs_off
    assert disp_on == disp_off


def test_slot_surgeries_on_cuda_equal_cpu(cuda):
    """The reference's oracle at budget 8 on both devices: the state after
    every surgery (spill, zero, graft, ring columns zeroed) is equal."""
    import random

    import chip_smoke as cs
    from sentinel_tpu_torch import convert

    names = [f"oracle{i}" for i in range(16)]
    weights = [1.0 / (i + 1) ** 1.2 for i in range(16)]
    snaps = {}
    for dev in ("cuda", "cpu"):
        run = cs.SlotRun(dev, 8, [(names[i], 3) for i in (0, 5, 10)])
        eng, got = run.eng, []
        execute = eng.slots._execute

        def recorded(*a, _execute=execute, _eng=eng, _got=got, **k):
            _execute(*a, **k)
            with _eng._lock:
                _got.append(convert.state_to_numpy(_eng.state))

        eng.slots._execute = recorded
        rng = random.Random(1234)
        for _ in range(6):
            for _ in range(20):
                run.serve(rng.choices(names, weights=weights)[0])
            run.second()
        assert eng.slots.evictions_total > 0
        assert eng.slots.surgery_d2h_bytes_total > 0
        run.result([])
        snaps[dev] = got
    assert len(snaps["cuda"]) == len(snaps["cpu"]) > 0
    for a, b in zip(snaps["cuda"], snaps["cpu"]):
        cs.compare_states(a, b)


def test_telescope_adds_no_dispatch_or_sync_on_cuda(cuda):
    """Device-tensor batches reach the telescope by pinned copies behind
    an event: with the telescope on, the same steps and syncs as off, and
    every lane observed once the fold ran."""
    from sentinel_tpu_torch.core.batch import make_entry_batch_np, to_device
    from sentinel_tpu_torch.core.config import POPULATION_ENABLED, config
    from sentinel_tpu_torch.core.engine import SentinelEngine
    from sentinel_tpu_torch.models import flow as F
    from sentinel_tpu_torch.utils.device import SYNCS

    def run(enabled):
        config.set(POPULATION_ENABLED, "" if enabled else "false")
        try:
            now = [1_700_000_000_000]
            eng = SentinelEngine(capacity=256, device=cuda,
                                 clock=lambda: now[0])
            row = eng.registry.cluster_row("ab")
            eng.flow_rules.load_rules([F.FlowRule("ab", count=100)])
            b = make_entry_batch_np(8)
            b["cluster_row"][:4] = row
            batch = to_device(b, cuda)
            SYNCS.count = 0
            for _ in range(5):
                eng.check_batch(batch)
                now[0] += 1000
            syncs = SYNCS.count
            eng.timeseries_view(now_ms=now[0])
            disp = {k: v["dispatches"]
                    for k, v in eng.step_timer.snapshot().items()}
            observed = eng.population.observed_total
            eng.close()
            return disp, syncs, observed
        finally:
            config.set(POPULATION_ENABLED, "")

    off, on = run(False), run(True)
    assert off[2] == 0 and on[2] == 20
    assert on[0] == off[0] and on[1] == off[1]


# -- the boot surface on the card: config seeding, checkpoints, checkers --


def test_config_seeded_engine_on_cuda_equals_cpu(cuda):
    """Built under 2000 ms / 4 buckets / a 250 ms cap, the card's engine
    seeds what the CPU's does and decides the boot stream as it does."""
    import chip_smoke as cs

    ops = cs.boot_stream_ops()[:400]
    card, cpu = cs.boot_config_run(cuda, ops), cs.boot_config_run("cpu", ops)
    assert card["seeded"] == cpu["seeded"] == (2000, 4, 250)
    for part in ("first", "second"):
        assert card[part] == cpu[part]
        cs.compare_states(card[f"{part}_state"], cpu[f"{part}_state"])


def _served_engine(dev, clock):
    from sentinel_tpu_torch.core import context as ctx_mod
    from sentinel_tpu_torch.core.engine import SentinelEngine
    from sentinel_tpu_torch.models import flow as F

    # Contexts pooled on this thread hold an earlier engine's rows.
    ctx_mod.replace_context(None)
    ctx_mod.bump_generation()

    eng = SentinelEngine(capacity=512, device=dev, clock=clock)
    eng.flow_rules.load_rules([F.FlowRule(f"r{i}", count=3)
                               for i in range(0, 20, 2)])
    return eng


def _serve(eng, clock, n=120, seed=3):
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import context as ctx_mod

    rng = np.random.default_rng(seed)
    verdicts = []
    for _ in range(n):
        clock.now += int(rng.integers(0, 40))
        try:
            eng.entry(f"r{int(rng.integers(20))}",
                      count=int(rng.integers(1, 3))).exit()
            verdicts.append("pass")
        except st.BlockException as ex:
            verdicts.append(type(ex).__name__)
    eng._flush_committer()
    ctx_mod.replace_context(None)
    return verdicts


@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_crosses_devices_bit_equal(cuda, tmp_path, src, dst):
    import chip_smoke as cs
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core.checkpoint import _state_arrays

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(src, clock)
    _serve(eng, clock)
    path = str(tmp_path / "x.npz")
    st.save_checkpoint(eng, path)
    with eng._lock:
        want = {k: v.cpu().numpy() for k, v in _state_arrays(eng.state).items()}
    eng.close()
    clock2 = cs.Clock(clock.now)
    fresh = _served_engine(dst, clock2)
    st.restore_checkpoint(fresh, path)
    got = _state_arrays(fresh.state)
    for k, w in want.items():
        assert got[k].device.type == dst and tuple(got[k].shape) == w.shape
        if k == "cur_threads":
            assert int(got[k].abs().sum()) == 0
        else:
            np.testing.assert_array_equal(got[k].cpu().numpy(), w)
    # The next traffic decides the same as a CPU engine restored likewise.
    clock3 = cs.Clock(clock.now)
    ref = _served_engine("cpu", clock3)
    st.restore_checkpoint(ref, path)
    assert _serve(fresh, clock2, seed=5) == _serve(ref, clock3, seed=5)
    fresh.close()
    ref.close()


def test_checkpoint_timer_saves_while_another_thread_dispatches(cuda,
                                                                tmp_path):
    """The timer's thread copies the state on the engine's stream while a
    caller dispatches: every file loads, and the last one restores into a
    CPU engine with the card's persisted tensors as they were then."""
    import threading

    import chip_smoke as cs
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core.checkpoint import _load_npz

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(cuda, clock)
    paths, errors = [], []

    def save(engine, _path):
        path = str(tmp_path / f"t{len(paths)}.npz")
        try:
            st.save_checkpoint(engine, path)
        except Exception as ex:  # noqa: BLE001
            errors.append(ex)
            raise
        paths.append(path)

    timer = st.CheckpointTimer(eng, str(tmp_path / "t.npz"), period_s=0.05,
                               save=save).start()
    stop = threading.Event()

    def caller():
        while not stop.is_set():
            _serve(eng, clock, n=10)

    th = threading.Thread(target=caller)
    th.start()
    try:
        deadline = time.time() + 20
        while len(paths) < 5 and time.time() < deadline:
            time.sleep(0.05)
    finally:
        timer.stop()
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive() and not errors and len(paths) >= 5
    for path in paths:
        header, arrays = _load_npz(path)
        assert int(arrays["w1_counts"].sum()) > 0
    ref = _served_engine("cpu", cs.Clock(clock.now))
    st.restore_checkpoint(ref, paths[-1])
    eng.close()
    ref.close()


def test_torch_checker_on_cuda_equals_cpu(cuda):
    import chip_smoke as cs
    from sentinel_tpu_torch.core import spi

    runs = {}
    for name, dev in (("cuda", cuda), ("cpu", "cpu")):
        clock = cs.Clock(cs.NOW0)
        eng = _served_engine(dev, clock)
        spi.register_device_checker(cs.cap_big_acquires)
        spi.register_device_checker(cs.two_per_second, order=1)
        try:
            verdicts = _serve(eng, clock, n=200, seed=9)
        finally:
            spi.unregister_device_checker(cs.cap_big_acquires)
            spi.unregister_device_checker(cs.two_per_second)
        with eng._lock:
            runs[name] = (verdicts, cs.convert.state_to_numpy(eng.state))
        eng.close()
    (vc, sc), (vp, sp) = runs["cuda"], runs["cpu"]
    assert vc == vp and "BlockException" in vc
    cs.compare_states(sc, sp)


def test_no_checker_leaves_host_syncs_per_step_unchanged(cuda):
    """The splice adds no host sync: the same SYNCS per check_batch with
    no checker and with one registered."""
    import chip_smoke as cs
    from sentinel_tpu_torch.core import spi
    from sentinel_tpu_torch.core.batch import make_entry_batch_np, to_device
    from sentinel_tpu_torch.utils.device import SYNCS

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(cuda, clock)
    b = make_entry_batch_np(2048)
    b["cluster_row"][:] = [eng.registry.cluster_row(f"r{i % 20}")
                           for i in range(2048)]
    b["count"][:] = 1
    batch = to_device(b, cuda)

    def syncs():
        clock.now += 50
        before = SYNCS.count
        eng.check_batch(batch)
        torch.cuda.synchronize()
        return SYNCS.count - before

    syncs()
    plain = syncs()
    spi.register_device_checker(cs.cap_big_acquires)
    try:
        assert syncs() == plain
    finally:
        spi.unregister_device_checker(cs.cap_big_acquires)
    assert syncs() == plain
    eng.close()


def test_checker_returning_a_cpu_tensor_raises_on_cuda(cuda):
    """A verdict on another device is refused, never moved: the dispatch
    fails (the state drops cold) and a width-1 entry fails open, counted."""
    import chip_smoke as cs
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.core import spi
    from sentinel_tpu_torch.core.batch import make_entry_batch_np

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(cuda, clock)

    def on_the_host(state, rules, batch, now_ms, candidate):
        return candidate.cpu()

    spi.register_device_checker(on_the_host)
    try:
        with pytest.raises(st.DeviceDispatchError, match="on_the_host"):
            eng.check_batch(make_entry_batch_np(8))
        assert eng.state is None
        eng.entry("r0").exit()
        assert eng.fail_open_count == 1
    finally:
        spi.unregister_device_checker(on_the_host)
        eng.close()


# -- staged rollout ----------------------------------------------------------


def _rollout_run(dev, stage):
    """The smoke's rollout stream at a small size: the candidate staged
    (then its stage set), 6 rounds at width 512 with exits."""
    import chip_smoke as cs
    from sentinel_tpu_torch.core.batch import to_device

    cs.CAPACITY, cs.N_RESOURCES = 4096, 1000
    eng, clock, cluster, dn, origin_a = cs.make_engine(dev, tight=False)
    eng.rollout.load_candidate("v", cs.rollout_candidate())
    if stage == "canary":
        eng.rollout.set_stage("v", "canary", canary_bps=2500)
    rng = np.random.default_rng(5)
    decs = []
    for _ in range(6):
        clock.now += cs.ROLLOUT_STEP_MS
        b = cs.rollout_buf(rng, 512, cluster, dn, origin_a)
        dec = eng.check_batch(to_device(b, dev))
        decs.append(cs.decisions_np(dec))
        eng.complete_batch(to_device(
            cs.rollout_exit_buf(rng, b, decs[-1]["reason"]), dev))
    counts = eng.shadow_counts()
    with eng._lock:
        state = cs.convert.state_to_numpy(eng.state)
    eng.close()
    return decs, counts, state


@pytest.mark.parametrize("stage", ["shadow", "canary"])
def test_rollout_on_cuda_equals_cpu(cuda, stage, monkeypatch):
    import chip_smoke as cs

    monkeypatch.setattr(cs, "CAPACITY", cs.CAPACITY)
    monkeypatch.setattr(cs, "N_RESOURCES", cs.N_RESOURCES)
    card, cpu = _rollout_run(cuda, stage), _rollout_run("cpu", stage)
    for x, y in zip(card[0], cpu[0]):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)
    np.testing.assert_array_equal(card[1], cpu[1])
    assert "shadow" in card[2] and card[1][1].sum() > 0
    cs.compare_states(card[2], cpu[2])


def test_canary_hash_on_cuda_equals_the_host(cuda):
    from sentinel_tpu_torch.rollout import canary

    edges = [-2**31, -2**31 + 1, -3, -1, 0, 1, 255, 2**16, 2**31 - 2,
             2**31 - 1]
    o = np.array([a for a in edges for _ in edges], np.int32)
    c = np.array([b for _ in edges for b in edges], np.int32)
    for salt in (0, 1, 0x7FFFFFFF, 0x5BD1E995 & 0x7FFFFFFF):
        for bps in (0, 1, 2500, 9999, 10_000):
            got = canary.device_in_canary(
                torch.from_numpy(o).to(cuda), torch.from_numpy(c).to(cuda),
                salt, bps).cpu().numpy()
            want = [canary.in_canary(int(a), int(b), salt, bps)
                    for a, b in zip(o, c)]
            np.testing.assert_array_equal(got, want)


def _syncs_and_launches(eng, clock, batch):
    from sentinel_tpu_torch.ops import prefix_cuda
    from sentinel_tpu_torch.utils.device import SYNCS

    clock.now += 50
    eng.check_batch(batch)  # compile and fold outside the count
    torch.cuda.synchronize()
    clock.now += 50
    s0, l0, t0 = SYNCS.count, prefix_cuda.launches, prefix_cuda.tile_launches
    eng.check_batch(batch)
    torch.cuda.synchronize()
    assert prefix_cuda.tile_launches == t0
    return SYNCS.count - s0, prefix_cuda.launches - l0


def test_candidate_adds_launches_and_leaves_syncs_once_gone(cuda):
    """No candidate: the step's syncs and kernel launches are what they
    were before one was staged and after it ended; with one, the shadow's
    flow and param sweeps launch the block sort beside the live ones."""
    import chip_smoke as cs
    from sentinel_tpu_torch.core.batch import make_entry_batch_np, to_device

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(cuda, clock)
    b = make_entry_batch_np(2048)
    b["cluster_row"][:] = [eng.registry.cluster_row(f"r{i % 20}")
                           for i in range(2048)]
    b["count"][:] = 1
    batch = to_device(b, cuda)
    plain = _syncs_and_launches(eng, clock, batch)
    eng.rollout.load_candidate("v", {"flow": [{"resource": "r0",
                                               "count": 1}],
                                     "paramFlow": [{"resource": "r2",
                                                    "paramIdx": 0,
                                                    "count": 1}]})
    shadowed = _syncs_and_launches(eng, clock, batch)
    eng.rollout.abort("v")
    assert _syncs_and_launches(eng, clock, batch) == plain
    assert shadowed[0] > plain[0]
    # Live: the two flow sweeps (no live param rule). The candidate adds
    # its own two flow sweeps and its param rule's two sweeps.
    assert plain[1] == 2 and shadowed[1] == 6
    eng.close()


# -- the cluster token path ---------------------------------------------------


@pytest.mark.parametrize("n", [1, 8, 64, 256, 1024, 4096, 5000])
def test_acquire_kernel_bit_equal_to_plain(cuda, n):
    """The acquire kernel against its plain form on the card (the smoke's
    seeded lanes: every status, unknown and out-of-range slots), all three
    outputs bit for bit, and one launch counted under its width."""
    import chip_smoke as cs
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    t = cs.acquire_case(np.random.default_rng(n), n, cuda)
    args = cs.acquire_args(t)
    before = CA.launches_by_width.get(n, 0)
    ok, cw, passed = CA.acquire_scan_cuda(*args)
    torch.cuda.synchronize()
    assert CA.launches_by_width[n] == before + 1
    want = CA.acquire_scan_plain(*args)
    assert torch.equal(ok, want[0]) and torch.equal(cw, want[1])
    assert torch.equal(passed.view(torch.int32), want[2].view(torch.int32))
    if n >= 64:
        known = t["known"]
        assert bool(ok.any()) and bool(cw.any())
        assert bool((known & ~ok & ~cw).any()) and bool((~known).any())


def test_acquire_kernel_one_long_run(cuda):
    """Every lane on one slot: the whole batch is one dependent chain."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    n = 3000
    args = (torch.zeros(n, dtype=torch.int32, device=cuda),
            torch.ones(n, device=cuda), torch.zeros(n, device=cuda),
            torch.full((n,), 1000.0, device=cuda),
            torch.full((n,), 0.7, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda),
            torch.ones(n, dtype=torch.bool, device=cuda),
            torch.zeros(n, device=cuda), 8, 0.5)
    got = CA.acquire_scan_cuda(*args)
    want = CA.acquire_scan_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,num_slots", [(4096, 3000), (5000, 10000)])
def test_acquire_kernel_many_slots(cuda, n, num_slots):
    """More slots than the block's 1024 threads (each thread walks several
    slots' runs, the scan takes several chunks), and more than fit in
    shared memory (the cursors in the scratch): bit-equal to the plain
    form, with unknown and out-of-range lanes mixed in."""
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    rng = np.random.default_rng(num_slots)
    slots = rng.integers(-1, num_slots + 8, n).astype(np.int32)
    slots[: n // 4] = rng.integers(0, 16, n // 4)  # a few long runs too
    thr = rng.integers(1, 6, n).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(cuda)

    args = (dev(slots), dev(rng.integers(1, 3, n).astype(np.float32)),
            dev(np.floor(rng.random(n) * thr).astype(np.float32)), dev(thr),
            dev(np.float32(1000.0) / rng.choice(
                [1000, 700, 7000], n).astype(np.float32)),
            dev(slots >= 0), dev(rng.random(n) < 0.3),
            dev(rng.integers(0, 3, n).astype(np.float32)), num_slots, 0.8)
    got = CA.acquire_scan_cuda(*args)
    want = CA.acquire_scan_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    assert bool(got[0].any()) and bool(got[1].any())


def test_acquire_wrapper_refuses_bad_inputs(cuda):
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    n = 16

    def args(**over):
        a = dict(slots=torch.zeros(n, dtype=torch.int32, device=cuda),
                 counts=torch.ones(n, device=cuda),
                 base=torch.zeros(n, device=cuda),
                 thr=torch.ones(n, device=cuda),
                 qps_scale=torch.ones(n, device=cuda),
                 known=torch.ones(n, dtype=torch.bool, device=cuda),
                 prioritized=torch.zeros(n, dtype=torch.bool, device=cuda),
                 waiting=torch.zeros(n, device=cuda))
        a.update(over)
        return list(a.values()) + [8, 1.0]

    with pytest.raises(ValueError, match="CUDA"):
        CA.acquire_scan_cuda(*args(base=torch.zeros(n)))
    with pytest.raises(TypeError):
        CA.acquire_scan_cuda(*args(counts=torch.ones(n, dtype=torch.float64,
                                                     device=cuda)))
    with pytest.raises(TypeError):
        CA.acquire_scan_cuda(*args(slots=torch.zeros(n, dtype=torch.int64,
                                                     device=cuda)))
    with pytest.raises(ValueError, match="contiguous"):
        CA.acquire_scan_cuda(*args(thr=torch.ones(2 * n, device=cuda)[::2]))
    with pytest.raises(ValueError, match="length"):
        CA.acquire_scan_cuda(*args(waiting=torch.zeros(n + 1, device=cuda)))


def test_failed_build_or_launch_raises_and_drops_the_service_state(
        cuda, monkeypatch):
    """No fallback to the plain form: a build that fails, or a launch the
    C function reports as failed, raises; the service drops its window
    state cold and serves again once the kernel works."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.models.flow import FlowRule
    from sentinel_tpu_torch.ops import cluster_acquire as CA

    svc = DefaultTokenService(device=cuda)
    svc.rules.load_rules("default", [FlowRule(
        resource="r", count=5, cluster_mode=True,
        cluster_config={"flowId": 1, "thresholdType": 1})])
    assert svc.request_token(1, 1, now_ms=1_700_000_000_000).status == 0

    def no_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(CA, "_lib", None)
    monkeypatch.setattr(CA, "build", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        svc.request_token(1, 1, now_ms=1_700_000_000_000)
    assert svc._state is None and svc._compiled_version == -1

    class Refused:
        @staticmethod
        def ca_acquire(*a):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(CA, "_lib", Refused())
    with pytest.raises(RuntimeError, match="cudaError 9"):
        svc.request_token(1, 1, now_ms=1_700_000_000_000)
    assert svc._state is None
    monkeypatch.undo()
    r = svc.request_token(1, 1, now_ms=1_700_000_000_000)
    assert (r.status, r.remaining) == (0, 4)


def test_server_and_client_on_cuda_agree_with_cpu(cuda):
    """A port server whose service runs on the card and one on the CPU,
    each answering a port client over loopback, one seeded stream on the
    port's frozen clock: the same verdict sequence."""
    from sentinel_tpu_torch.cluster.client import ClusterTokenClient
    from sentinel_tpu_torch.cluster.server import ClusterTokenServer
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.models.flow import FlowRule
    from sentinel_tpu_torch.utils import time_util

    rules = [FlowRule(resource=f"w{i}", count=3 + i % 4, cluster_mode=True,
                      cluster_config={"flowId": 500 + i,
                                      "thresholdType": i % 2})
             for i in range(16)]

    def run(dev):
        rng = np.random.default_rng(8)
        svc = DefaultTokenService(device=dev)
        svc.rules.load_rules("default", rules)
        server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
        client = ClusterTokenClient("127.0.0.1", server.bound_port,
                                    request_timeout_s=10.0).start()
        deadline = time.monotonic() + 10
        while not client.is_connected() and time.monotonic() < deadline:
            time.sleep(0.01)
        out = []
        try:
            for _ in range(12):
                reqs = [(500 + int(rng.integers(0, 18)),
                         int(rng.integers(1, 3)), bool(rng.random() < 0.3))
                        for _ in range(int(rng.integers(1, 70)))]
                out += [tuple(r[:3]) for r in
                        client.request_tokens_pipelined(reqs)]
                out.append(tuple(client.request_param_token(
                    500 + int(rng.integers(0, 4)), 1, ["k", 1])[:3]))
                time_util.advance_time(int(rng.integers(0, 400)))
            return out
        finally:
            client.stop()
            server.stop()

    time_util.freeze_time(1_700_000_000_000)
    try:
        card = run(cuda)
        time_util.freeze_time(1_700_000_000_000)
        cpu = run("cpu")
    finally:
        time_util.unfreeze_time()
    assert card == cpu
    assert {s for s, _, _ in card} >= {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# The pod
# ---------------------------------------------------------------------------


def test_pod_on_cuda_equals_cpu(cuda):
    """Four shards at the smoke's cut size (capacity 8,192, 2,000
    resources, 256 lanes a shard, 6 rounds with exits): every decision and
    every state leaf equal on the card and the CPU."""
    import chip_smoke as cs

    runs = {}
    for key, dev in (("card", cuda), ("cpu", "cpu")):
        rows, pack, one, stream = cs.pod_cut(dev)
        runs[key] = cs.pod_drive(dev, rows, pack, one, stream,
                                 cs.POD_CUT["shards"])
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert sum(int((d["reason"] > 0).sum()) for d in runs["card"][0]) > 0
    cs.pod_states_equal(runs["card"][1], runs["cpu"][1], "pod")


def test_dist_pod_over_nccl_equals_gloo_and_one_process(cuda, tmp_path):
    """World size 1 (a FileStore, no network): the distributed driver on
    the card over NCCL, the same driver on the CPU over a gloo group, and
    the one-process driver on the card at D = 1 give equal decisions and
    state over the cut stream's first shard."""
    import torch.distributed as dist

    import chip_smoke as cs
    from sentinel_tpu_torch.parallel import cluster as PPC

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        gloo = dist.new_group([0], backend="gloo")
        out = {}
        for name, dev, group in (("nccl", cuda, None), ("gloo", "cpu", gloo),
                                 ("one", cuda, None)):
            rows, pack, one, _ = cs.pod_cut(dev)
            stream = cs.pod_stream(rows, 1, 256, 6, 21)
            if name == "one":
                entry, exit_ = PPC.make_pod_steps(dev)
                state = PPC.make_pod_state(1, one)
            else:
                entry, exit_ = PPC.make_dist_pod_steps(group, device=dev)
                state = one
            decs, now = [], cs.NOW0
            for k, ebuf in enumerate(stream):
                now += 50
                state, dec = entry(state, pack, cs.to_device(ebuf, dev), now)
                decs.append(cs.decisions_np(dec))
                state = exit_(state, pack, cs.to_device(cs.pod_exit_buf(
                    ebuf, decs[-1]["reason"], k), dev), now + 10)
            out[name] = (decs, state if name != "one"
                         else PPC.shard(state, 0))
        for name in ("gloo", "one"):
            for a, b in zip(out["nccl"][0], out[name][0]):
                for f in a:
                    np.testing.assert_array_equal(a[f], b[f], err_msg=name)
            cs.pod_states_equal(out["nccl"][1], out[name][1], name)
    finally:
        dist.destroy_process_group()


# -- the control plane that rides the fold ------------------------------------


def _control_fold_run(cuda, hooks):
    """Eight seconds of width-2048 steps on the card, one fold a second:
    per-step syncs and launches, and the step timer's dispatches. With
    ``hooks``: objectives on the ruled resources, enabled idle targets,
    and wire observations for the waterfall to seal."""
    import chip_smoke as cs
    from sentinel_tpu_torch.adaptive.controller import AdaptiveTarget
    from sentinel_tpu_torch.core.batch import make_entry_batch_np, to_device
    from sentinel_tpu_torch.ops import prefix_cuda
    from sentinel_tpu_torch.slo.objectives import BurnWindow, SloObjective
    from sentinel_tpu_torch.utils.device import SYNCS

    clock = cs.Clock(cs.NOW0)
    eng = _served_engine(cuda, clock)
    if hooks:
        eng.slo.load_objectives([SloObjective(
            resource=f"r{i}", objective=0.99, min_events=1,
            windows=(BurnWindow(10, 2, 2.0, "page"),))
            for i in range(0, 20, 2)])
        eng.adaptive.load_targets([AdaptiveTarget(
            resource=f"r{i}", max_block_rate=0.99, min_entries=8)
            for i in range(0, 20, 2)])
        eng.adaptive.enable()
    b = make_entry_batch_np(2048)
    b["cluster_row"][:] = [eng.registry.cluster_row(f"r{i % 20}")
                           for i in range(2048)]
    b["count"][:] = 1
    batch = to_device(b, cuda)
    steps = []
    for second in range(8):
        for k in range(4):
            clock.now = cs.NOW0 + second * 1000 + k * 250
            torch.cuda.synchronize()
            s0, l0 = SYNCS.count, prefix_cuda.launches
            eng.harvest_decisions(eng.check_batch(batch))
            steps.append((SYNCS.count - s0, prefix_cuda.launches - l0))
            if hooks:
                eng.waterfall.observe_wire([0.1] * 8)
        clock.now = cs.NOW0 + (second + 1) * 1000
        eng.slo_refresh(now_ms=clock.now)
    disp = {k: v["dispatches"] for k, v in eng.step_timer.snapshot().items()}
    sealed = eng.waterfall.snapshot()["sealedSeconds"]
    evaluated = eng.slo.status()["evaluatedThroughMs"]
    ticked = eng.adaptive.status()["senses"]
    eng.close()
    return steps, disp, sealed, evaluated, ticked


def test_control_hooks_add_no_sync_or_launch_to_a_step(cuda):
    """The SLO evaluation, the waterfall's seal and the adaptive loop's
    tick ride the fold as host work: with them loaded, every step has the
    syncs and launches it has without, and the engine dispatches the same
    steps (the references' A/B guards, ``tests/test_slo.py:641``,
    ``test_waterfall.py:340``, ``test_adaptive.py:693``)."""
    plain = _control_fold_run(cuda, hooks=False)
    hooked = _control_fold_run(cuda, hooks=True)
    assert hooked[0] == plain[0]
    assert hooked[1] == plain[1]
    assert hooked[2] > 0 and hooked[3] > 0 and hooked[4]
    assert all(launches == 2 for _, launches in plain[0])
