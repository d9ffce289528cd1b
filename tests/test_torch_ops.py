"""The port's step building blocks against the JAX package and the serial
oracle, on the CPU: window rotation (``ops/window.py``) against
``tests/oracle.py:OracleLeapArray`` and the JAX window functions, the
survivor fixpoint (``ops/fixpoint.py``) including a non-converging
mixed-count case pinned to the last EVEN iterate, the uint32 CMS
positions, and the telemetry bucket helpers — all bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sentinel_tpu.models import param_flow as JP
from sentinel_tpu.ops import fixpoint as JFX
from sentinel_tpu.ops import window as JW
from sentinel_tpu.telemetry import attribution as JT
from tests.oracle import OracleLeapArray

from sentinel_tpu_torch.models import param_flow as PP
from sentinel_tpu_torch.ops import fixpoint as PFX
from sentinel_tpu_torch.ops import window as PW
from sentinel_tpu_torch.telemetry import attribution as PT

NOW0 = 1_700_000_000_000


@pytest.mark.parametrize("interval,buckets", [(1000, 2), (60_000, 60)])
def test_window_against_oracle_leap_array(interval, buckets):
    """Random adds and reads over an advancing clock with gaps longer than
    the window: totals equal the scalar LeapArray's ``values()``."""
    rows, events = 6, 6
    spec = PW.WindowSpec(interval, buckets)
    win = PW.make_window(rows, spec, "cpu")
    oracles = [OracleLeapArray(interval, buckets, events) for _ in range(rows)]
    rng = np.random.default_rng(buckets)
    now = NOW0
    for _ in range(60):
        now += int(rng.choice([1, 7, spec.bucket_ms // 3, spec.bucket_ms,
                               interval + 11]))
        win = PW.rotate(win, now, spec)
        n = 5
        r = rng.integers(-1, rows, size=n).astype(np.int32)
        e = rng.integers(0, events, size=n).astype(np.int32)
        v = rng.integers(1, 9, size=n).astype(np.int32)
        win = PW.add_events(win, now, torch.from_numpy(r), torch.from_numpy(e),
                            torch.from_numpy(v), spec)
        for ri, ei, vi in zip(r, e, v):
            if ri >= 0:
                oracles[ri].add(now, int(ei), int(vi))
        got = PW.row_totals(win, torch.arange(-1, rows, dtype=torch.int32))
        assert got.dtype == torch.int64
        assert got[0].tolist() == [0] * events  # row -1 reads zeros
        for row in range(rows):
            want = [oracles[row].total(now, c) for c in range(events)]
            assert got[row + 1].tolist() == want


def test_window_functions_match_jax():
    spec = PW.WindowSpec(1000, 2)
    jspec = JW.WindowSpec(1000, 2)
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 50, size=(2, 6, 16)).astype(np.int32)
    min_rt = rng.integers(1, 900, size=(2, 16)).astype(np.int32)
    starts = np.array([NOW0 - 500, NOW0 - 1000], np.int64)
    jw = JW.Window(jnp.asarray(counts), jnp.asarray(min_rt),
                   jnp.asarray(starts))
    mk = lambda: PW.Window(torch.from_numpy(counts.copy()),
                           torch.from_numpy(min_rt.copy()),
                           torch.from_numpy(starts.copy()))
    rows = rng.integers(-2, 18, size=40).astype(np.int32)
    rt = rng.integers(0, 300, size=40).astype(np.int32)
    for now in (NOW0 + 3, NOW0 + 499, NOW0 + 777, NOW0 + 5000):
        jn = jnp.int64(now)
        np.testing.assert_array_equal(
            PW.expected_starts(now, spec, "cpu").numpy(),
            np.asarray(JW.expected_starts(jn, jspec)))
        assert PW.current_index(now, spec) == int(JW.current_index(jn, jspec))
        jr, pr = JW.rotate(jw, jn, jspec), PW.rotate(mk(), now, spec)
        for a, b in zip(jr, pr):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jc, pc = JW.rotate_current(jw, jn, jspec), PW.rotate_current(
            mk(), now, spec)
        for a, b in zip(jc, pc):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(
            PW.staleness_mask(mk(), now, spec).numpy(),
            np.asarray(JW.staleness_mask(jw, jn, jspec)))
        ja = JW.add_min_rt(jr, jn, jnp.asarray(rows), jnp.asarray(rt), jspec)
        pa = PW.add_min_rt(pr, now, torch.from_numpy(rows),
                           torch.from_numpy(rt), spec)
        np.testing.assert_array_equal(pa.min_rt.numpy(), np.asarray(ja.min_rt))
        # JW.row_min_rt itself does not trace under the installed jax (its
        # fill value is an array); hold the port against numpy instead.
        jmin = np.asarray(ja.min_rt)
        want = np.array([jmin[:, r].min() if 0 <= r < 16 else PW.MIN_RT_EMPTY
                         for r in rows], np.int32)
        np.testing.assert_array_equal(
            PW.row_min_rt(pa, torch.from_numpy(rows)).numpy(), want)
        np.testing.assert_array_equal(PW.all_totals(pa).numpy(),
                                      np.asarray(JW.all_totals(ja)))


def test_row_window_matches_jax():
    rng = np.random.default_rng(4)
    bms = np.array([1000, 250, 0, 60_000, 10], np.int64)
    jrw = JW.make_row_window(5, 1, 3, jnp.asarray(bms))
    prw = PW.make_row_window(5, 1, 3, bms, "cpu")
    now = NOW0
    for _ in range(25):
        now += int(rng.integers(1, 700))
        jn = jnp.int64(now)
        jrw, prw = JW.row_rotate(jrw, jn), PW.row_rotate(prw, now)
        rows = rng.integers(-1, 6, size=12).astype(np.int32)
        ch = rng.integers(0, 3, size=12).astype(np.int32)
        v = rng.integers(0, 5, size=12).astype(np.int32)
        jrw = JW.row_window_add(jrw, jn, jnp.asarray(rows), jnp.asarray(ch),
                                jnp.asarray(v))
        prw = PW.row_window_add(prw, now, torch.from_numpy(rows),
                                torch.from_numpy(ch), torch.from_numpy(v))
        for a, b in zip(jrw, prw):
            assert b.dtype == torch.from_numpy(np.asarray(a)).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        q = torch.arange(-1, 6, dtype=torch.int32)
        np.testing.assert_array_equal(
            PW.row_window_totals(prw, q).numpy(),
            np.asarray(JW.row_window_totals(jrw, jnp.asarray(q.numpy()))))


# ---------------------------------------------------------------------------
# survivor fixpoint
# ---------------------------------------------------------------------------


def _capacity_sweep(lib, counts, cap_tokens):
    """blocked_for: serial greedy prefix admission against one bucket —
    entry i is blocked when the tokens of earlier survivors plus its own
    exceed ``cap_tokens``."""
    if lib is jnp:
        c = jnp.asarray(counts)

        def blocked_for(s):
            contrib = jnp.where(s, c, 0)
            return jnp.cumsum(contrib) - contrib + c > cap_tokens
        return blocked_for
    c = torch.from_numpy(counts)

    def blocked_for(s):
        contrib = torch.where(s, c, 0)
        return torch.cumsum(contrib, 0) - contrib + c > cap_tokens
    return blocked_for


def _chain_sweep(lib, n):
    """A domino chain: entry i is blocked iff entry i-1 survives. The
    serial answer alternates pass/block; the map needs ~n iterations, so
    n = 30 does not converge within the cap of 12."""
    if lib is jnp:
        def blocked_for(s):
            return jnp.concatenate([jnp.zeros((1,), bool), s[:-1]])
        return blocked_for

    def blocked_for(s):
        return torch.cat([torch.zeros((1,), dtype=torch.bool), s[:-1]])
    return blocked_for


@pytest.mark.parametrize("kind,n", [("uniform", 16), ("mixed", 16),
                                    ("chain", 30), ("chain", 9),
                                    ("empty", 0)])
def test_survivor_fixpoint_matches_jax(kind, n):
    rng = np.random.default_rng(n)
    cand = rng.random(n) < 0.9
    if kind == "uniform":
        counts = np.full(n, 2, np.int32)
    else:
        counts = rng.integers(1, 5, size=n).astype(np.int32)
    if kind == "chain":
        cand[:] = True
        jbf, pbf = _chain_sweep(jnp, n), _chain_sweep(torch, n)
    else:
        jbf = _capacity_sweep(jnp, counts, 9)
        pbf = _capacity_sweep(torch, counts, 9)
    want = np.asarray(jax.jit(
        lambda c: JFX.survivor_fixpoint(c, jbf, jnp.asarray(counts)))(
            jnp.asarray(cand)))
    got = PFX.survivor_fixpoint(torch.from_numpy(cand), pbf,
                                torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_non_converging_fixpoint_returns_last_even_iterate():
    n = 30
    cand = torch.ones(n, dtype=torch.bool)
    counts = torch.from_numpy(np.arange(n, dtype=np.int32) % 3 + 1)
    bf = _chain_sweep(torch, n)
    iterates = [cand]
    for _ in range(12):
        iterates.append(cand & ~bf(iterates[-1]))
    assert not torch.equal(iterates[-1], iterates[-2])  # no convergence
    got = PFX.survivor_fixpoint(cand, bf, counts)
    assert torch.equal(got, iterates[12])  # S_12: the last even iterate
    # The caller's final sweep then ships an ODD iterate: a subset of the
    # serial (alternating) admitted set — it can only under-admit.
    final = cand & ~bf(got)
    serial = torch.arange(n) % 2 == 0
    assert not bool((final & ~serial).any())


def test_counts_uniform_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(20):
        n = int(rng.integers(1, 12))
        cand = rng.random(n) < 0.6
        counts = rng.integers(1, 3, size=n).astype(np.int32)
        want = bool(JFX._counts_uniform(jnp.asarray(cand),
                                        jnp.asarray(counts)))
        got = bool(PFX._counts_uniform(torch.from_numpy(cand),
                                       torch.from_numpy(counts)))
        assert got == want


# ---------------------------------------------------------------------------
# uint32 hashing and telemetry buckets
# ---------------------------------------------------------------------------


def test_cms_positions_bit_equal_on_random_uint32():
    rng = np.random.default_rng(9)
    h = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(JP._cms_positions(jnp.asarray(h)))
    got = PP._cms_positions(torch.from_numpy(h.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    slots = (torch.from_numpy(h.astype(np.int64)) % PP.DEFAULT_SLOTS).numpy()
    np.testing.assert_array_equal(
        slots, np.asarray(jnp.asarray(h) % jnp.uint32(JP.DEFAULT_SLOTS)))


def test_attribution_helpers_match_jax():
    rt = np.array([-5, 0, 1, 2, 3, 4, 5, 100, 4096, 4097, 10**6], np.int32)
    np.testing.assert_array_equal(
        PT.rt_bucket_index(torch.from_numpy(rt)).numpy(),
        np.asarray(JT.rt_bucket_index(jnp.asarray(rt))))
    slots = np.array([-1, 0, 3, 7, 8, 9, 200], np.int32)
    np.testing.assert_array_equal(
        PT.slot_bin_index(torch.from_numpy(slots)).numpy(),
        np.asarray(JT.slot_bin_index(jnp.asarray(slots))))
    np.testing.assert_array_equal(PT.REASON_CHANNEL_TABLE,
                                  JT.REASON_CHANNEL_TABLE)
    assert PT.ATTR_REASON_VALUES == JT.ATTR_REASON_VALUES
    assert (PT.NUM_SLOT_BINS, PT.NUM_RT_BUCKETS) == (JT.NUM_SLOT_BINS,
                                                     JT.NUM_RT_BUCKETS)
    assert PT.RT_BUCKET_EDGES_MS == JT.RT_BUCKET_EDGES_MS


def test_copied_constants_match_jax():
    from sentinel_tpu.core import constants as JC
    from sentinel_tpu.utils.param_hash import hash_param as jhash
    from sentinel_tpu_torch.core import constants as PC
    from sentinel_tpu_torch.utils.param_hash import hash_param as phash

    for name in dir(JC):
        if name.isupper():
            assert getattr(PC, name) == getattr(JC, name), name
    for enum_name in ("MetricEvent", "EntryType", "ResourceType",
                      "BlockReason"):
        assert ({m.name: int(m) for m in getattr(PC, enum_name)}
                == {m.name: int(m) for m in getattr(JC, enum_name)})
    for v in (1, 1.0, "1", True, b"x", (1, 2), -7, "ü"):
        assert phash(v) == jhash(v)
