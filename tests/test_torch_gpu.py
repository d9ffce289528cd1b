"""Card-only tests of the port (marker ``gpu``): the segmented-prefix CUDA
kernel against its plain version, and the fused step on ``cuda`` against
the same step on ``cpu``.

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


@pytest.mark.parametrize("n,k,m", [(1, 1, 1), (8, 3, 2), (127, 1, 2),
                                   (129, 3, 1), (1000, 3, 2), (2048, 3, 2),
                                   (8192, 1, 2), (300, 2, 2)])
def test_kernel_bit_equal_to_plain(cuda, n, k, m):
    from sentinel_tpu_torch.ops import prefix_cuda
    from sentinel_tpu_torch.ops.segment import segmented_prefix_plain

    rng = np.random.default_rng(n * 10 + k)
    ids = rng.integers(-1, max(2, n // 8), size=(k, n)).astype(np.int32)
    vals = rng.integers(0, 257, size=(k, n, m)).astype(np.float32)
    ids_t = torch.from_numpy(ids).to(cuda)
    vals_t = torch.from_numpy(vals).to(cuda)
    before = prefix_cuda.launches
    prefix, first = prefix_cuda.segmented_prefix_cuda(ids_t, vals_t)
    torch.cuda.synchronize()
    assert prefix_cuda.launches == before + 1
    for kk in range(k):
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
