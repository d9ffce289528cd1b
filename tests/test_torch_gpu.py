"""Card-only tests of the port (marker ``gpu``): the segmented-prefix CUDA
kernels (block sort and tile walk) against the plain version and each
other, and the fused step on ``cuda`` against the same step on ``cpu``.

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
