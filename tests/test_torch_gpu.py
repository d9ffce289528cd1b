"""Card-only tests of the port (marker ``gpu``): the segmented-prefix CUDA
kernels (block sort and tile walk) against the plain version and each
other, the fused step on ``cuda`` against the same step on ``cpu``, and the
``st.entry`` path on the card: the native lease ring, the stats committer
flushing from its thread and drained by ``close()``, and the device path
launching the kernel at width 1; and pipelined admission on the card: pinned
staging buffers released only after their cycle's harvest, the same
verdicts as on the CPU, a clean stop with cycles in flight, the trace pump
reading verdicts from a CUDA engine, and a retune resetting the window on
the card.

Whether a card exists is decided inside the fixture, never at import, so
every pytest worker collects the same tests; without a card they skip.
On the H100 run them with::

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest
"""

from __future__ import annotations

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
