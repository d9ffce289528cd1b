"""The port's within-batch scans (``sentinel_tpu_torch/ops/segment.py``)
against the JAX package's, bit for bit, on the CPU.

The port's plain segmented prefix (sort + float64 cumsum + cummax) is held
against ``sentinel_tpu.ops.segment``'s ``segmented_prefix``,
``_sorted_prefix_multi`` and ``segmented_prefix_dense_multi``, and against
the Pallas kernel body itself (``sentinel_tpu/ops/pallas_prefix.py``) run in
interpret mode. That module does not import under the installed jax
(``jax.experimental.enable_x64`` is gone); the fixture below installs the
surviving spelling ``jax.enable_x64`` under the old name with
``monkeypatch`` for the duration of one test and drops the module again
afterwards, so nothing outside these tests sees the alias.

Cases: ids with negatives, ``n = 0``, ``n`` off the 512-row Pallas block,
values at the 256 edge and segment sums reaching 2^24 - 1, and the id
patterns a radix sort gets wrong: repeats of INT32_MIN, INT32_MAX, -1, -7,
0 and large keys of both signs (``full_int32``), distinct keys spread over
the whole int32 range (``all_distinct``) and one key for every row
(``all_equal``, INT32_MIN).
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.experimental
import jax.numpy as jnp

from sentinel_tpu.ops import segment as JSEG
from sentinel_tpu_torch.ops import segment as PSEG

_PALLAS_MOD = "sentinel_tpu.ops.pallas_prefix"
_ORIG_ENABLE_X64 = getattr(jax.experimental, "enable_x64", None)


@pytest.fixture
def pallas_prefix(monkeypatch):
    """Import the Pallas module under a test-local ``enable_x64`` alias."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    monkeypatch.delitem(sys.modules, _PALLAS_MOD, raising=False)
    mod = importlib.import_module(_PALLAS_MOD)
    yield mod
    sys.modules.pop(_PALLAS_MOD, None)
    import sentinel_tpu.ops as ops_pkg

    if getattr(ops_pkg, "pallas_prefix", None) is mod:
        delattr(ops_pkg, "pallas_prefix")


def _case(n, bins, seed, m=2, neg=0.1, lo=0, hi=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, max(bins, 1), size=n).astype(np.int32)
    ids[rng.random(n) < neg] = -1
    vals = rng.integers(lo, hi, size=(n, m)).astype(np.float32)
    return ids, vals


def _edge_2p24(n, m=2):
    """One segment whose exclusive prefix reaches 2^24 - 1 at its last
    row (the float32 exactness edge); every other row has value 0, so the
    JAX sort form's global cumsum stays exact too."""
    ids = np.full(n, 5, np.int32)
    vals = np.zeros((n, m), np.float32)
    vals[0] = 2**24 - 1 - (n - 2)
    vals[1:n - 1] = 1
    return ids, vals


CASES = [
    ("random", 512, 8, 0), ("wide_bins", 1024, 32768, 1),
    ("off_block", 1000, 64, 2), ("small", 7, 3, 3),
    ("all_negative", 64, 0, 4), ("full_int32", 4096, 0, 5),
    ("all_distinct", 4096, 0, 6), ("all_equal", 4096, 0, 7),
]

_I32 = np.iinfo(np.int32)


def _radix_ids(name, n, rng):
    """Id patterns across the whole int32 range (see the module note)."""
    if name == "full_int32":
        pool = np.concatenate([
            [_I32.min, _I32.max, -1, -7, 0],
            rng.integers(2**30, _I32.max, size=8),
            rng.integers(_I32.min + 1, -2**30, size=8)])
        return rng.choice(pool, size=n).astype(np.int32)
    if name == "all_distinct":
        step = (2**32 - 1) // max(n, 1)
        return (rng.permutation(n).astype(np.int64) * step
                + _I32.min).astype(np.int32)
    return np.full(n, _I32.min, np.int32)  # all_equal


def _make(name, n, bins, seed, m=2):
    if name == "all_negative":
        ids, vals = _case(n, 1, seed, m=m, neg=1.0)
    elif name in ("full_int32", "all_distinct", "all_equal"):
        ids, vals = _case(n, 1, seed, m=m)
        ids = _radix_ids(name, n, np.random.default_rng(seed))
    else:
        ids, vals = _case(n, bins, seed, m=m)
    return ids, vals


def _port(ids, vals):
    return PSEG.segmented_prefix_plain(torch.from_numpy(ids),
                                       torch.from_numpy(vals))


@pytest.mark.parametrize("name,n,bins,seed", CASES)
def test_plain_matches_jax_sorted_prefix_multi(name, n, bins, seed):
    ids, vals = _make(name, n, bins, seed)
    want_p, want_f = JSEG._sorted_prefix_multi(jnp.asarray(ids),
                                               jnp.asarray(vals))
    got_p, got_f = _port(ids, vals)
    assert got_p.dtype == torch.float32 and got_f.dtype == torch.bool
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("name,n,bins,seed", CASES)
def test_plain_matches_jax_segmented_prefix_1d(name, n, bins, seed):
    ids, vals = _make(name, n, bins, seed, m=1)
    want_p, want_f = JSEG.segmented_prefix(jnp.asarray(ids),
                                           jnp.asarray(vals[:, 0]))
    got_p, got_f = PSEG.segmented_prefix(torch.from_numpy(ids),
                                         torch.from_numpy(vals[:, 0]))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("n", [0, 1, 300, 1000])
def test_dense_multi_matches_jax_contract(n):
    """The K-pair entry point (the flow sweep's three row spaces, one
    squeezed 1-D pair), including the n == 0 path."""
    rng = np.random.default_rng(n)
    pairs = []
    for k, m in enumerate((2, 2, 1)):
        ids = rng.integers(-1, 6 + k, size=n).astype(np.int32)
        vals = rng.integers(0, 4, size=(n, m)).astype(np.float32)
        pairs.append((ids, vals[:, 0] if m == 1 else vals))
    want = JSEG.segmented_prefix_dense_multi(
        [(jnp.asarray(i), jnp.asarray(v)) for i, v in pairs])
    got = PSEG.segmented_prefix_dense_multi(
        [(torch.from_numpy(i), torch.from_numpy(v)) for i, v in pairs])
    for (wp, wf), (gp, gf) in zip(want, got):
        assert tuple(gp.shape) == np.asarray(wp).shape
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


@pytest.mark.parametrize("edge", ["256", "2^24-1"])
def test_value_edges_exact(edge):
    if edge == "256":
        ids, vals = _case(2048, 3, 9, lo=250, hi=257)
    else:
        ids, vals = _edge_2p24(300)
    want_p, want_f = JSEG._sorted_prefix_multi(jnp.asarray(ids),
                                               jnp.asarray(vals))
    got_p, got_f = _port(ids, vals)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    if edge == "2^24-1":
        assert float(got_p[-1, 0]) == 2**24 - 1


@pytest.mark.parametrize("name,n,bins,seed", [
    ("random", 512, 8, 10), ("off_block", 1000, 64, 11),
    ("edge_256", 512, 2, 12), ("edge_2p24", 600, 1, 13)])
def test_plain_matches_pallas_kernel_interpret(pallas_prefix, name, n, bins,
                                              seed):
    """Bit-equal to the TPU kernel's own body (Pallas interpret mode)."""
    if name == "edge_256":
        ids, vals = _case(n, bins, seed, lo=250, hi=257)
    elif name == "edge_2p24":
        ids, vals = _edge_2p24(n)
    else:
        ids, vals = _case(n, bins, seed)
    want_p, want_f = pallas_prefix.prefix_pallas(
        jnp.asarray(ids), jnp.asarray(vals), interpret=True)
    got_p, got_f = _port(ids, vals)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_pallas_alias_is_local_to_the_fixture(pallas_prefix):
    assert _PALLAS_MOD in sys.modules
    assert jax.experimental.enable_x64 is jax.enable_x64


def test_pallas_alias_does_not_outlive_the_fixture():
    assert getattr(jax.experimental, "enable_x64", None) is _ORIG_ENABLE_X64


@pytest.mark.parametrize("n,bins,m", [(0, 16, 2), (100, 16, 1), (777, 64, 3)])
def test_bincount_matches_jax(n, bins, m):
    rng = np.random.default_rng(n + m)
    ids = rng.integers(-2, bins + 3, size=n).astype(np.int32)
    vals = rng.integers(-3, 200, size=(n, m)).astype(np.int32)
    want = np.asarray(JSEG.bincount_matmul(jnp.asarray(ids),
                                           jnp.asarray(vals), bins))
    got = PSEG.bincount_matmul(torch.from_numpy(ids), torch.from_numpy(vals),
                               bins)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    got1 = PSEG.bincount_matmul(torch.from_numpy(ids),
                                torch.from_numpy(vals[:, 0]), bins)
    np.testing.assert_array_equal(got1.numpy(), want[0].astype(np.int32))


@pytest.mark.parametrize("n,segs", [(0, 4), (1, 4), (64, 8), (513, 100)])
def test_first_in_segment_matches_jax(n, segs):
    rng = np.random.default_rng(n)
    ids = rng.integers(-2, segs + 2, size=n).astype(np.int32)
    want = np.asarray(JSEG.first_in_segment(jnp.asarray(ids), segs))
    got = PSEG.first_in_segment(torch.from_numpy(ids), segs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prep_prefix_pair_matches_jax():
    ids, vals = _case(100, 8, 21)
    w = JSEG.prep_prefix_pair(jnp.asarray(ids), jnp.asarray(vals), 512)
    g = PSEG.prep_prefix_pair(torch.from_numpy(ids), torch.from_numpy(vals),
                              512)
    assert w[:2] == g[:2]
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    np.testing.assert_array_equal(g[3].numpy(), np.asarray(w[3]))


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    """A CPU tensor takes the plain version: the CUDA wrapper is never
    called (it would raise on CPU tensors)."""
    from sentinel_tpu_torch.ops import prefix_cuda

    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for CPU tensors")

    monkeypatch.setattr(prefix_cuda, "segmented_prefix_cuda", boom)
    ids, vals = _case(64, 4, 30)
    PSEG.segmented_prefix_dense(torch.from_numpy(ids), torch.from_numpy(vals))


def test_build_key_covers_every_source(tmp_path, monkeypatch):
    """The library's cache key hashes every file the build reads, so an
    edit to a header alone rebuilds."""
    import shutil

    from sentinel_tpu_torch.ops import prefix_cuda

    csrc = tmp_path / "csrc"
    shutil.copytree(prefix_cuda.CSRC, csrc)
    monkeypatch.setattr(prefix_cuda, "CSRC", csrc)
    names = [p.name for p in prefix_cuda.sources()]
    assert "segmented_prefix.cu" in names
    assert "segmented_prefix_tiles.cuh" in names
    before = prefix_cuda.library_path()
    header = csrc / "segmented_prefix_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert prefix_cuda.library_path() != before


def test_kernel_wrapper_rejects_cpu_tensors():
    from sentinel_tpu_torch.ops import prefix_cuda

    with pytest.raises(ValueError):
        prefix_cuda.segmented_prefix_cuda(
            torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 4, 2), dtype=torch.float32))
