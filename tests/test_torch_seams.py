"""The engine's runtime seams, ``set_window_geometry`` (with
``set_occupy_timeout``) and ``set_clock``, on the port against the JAX
package.

One JAX engine and one port engine (``device="cpu"``) for the module,
through ``tests/test_torch_api.py``'s harness: every operation's verdict
must be equal, and so must the readers and the device state at each
check. The scenarios are the seams' uses in ``tests/test_flow.py``,
``tests/test_lease.py``, ``tests/test_occupy.py`` and
``tests/test_step_fuzz.py``. Every retune makes the JAX reference compile
its step again (~5 s on the CPU), so the tests do not restore the
default geometry after themselves: each one sets the geometry it starts
from, and the file's order keeps those retunes few.
"""

from __future__ import annotations

import numpy as np
import pytest

from sentinel_tpu.core import constants as JC

from sentinel_tpu_torch.core.batch import make_entry_batch_np
from sentinel_tpu_torch.utils import time_util as ptu

from tests.oracle import OracleLeapArray
from tests.test_torch_api import Pair, _assert_close
from tests.test_torch_support import jax_entry

DEFAULT_GEOMETRY = (1000, 2)


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
    for s in engines.sides:
        s.eng.set_occupy_timeout(
            min(JC.DEFAULT_OCCUPY_TIMEOUT_MS, s.eng._spec1.interval_ms))
    yield engines
    for s in engines.sides:
        s.eng.set_clock(None)
    if request.session.testsfailed > failed:
        engines.broken = True


def geometry(pair, interval_ms=None, sample_count=None):
    for s in pair.sides:
        s.eng.set_window_geometry(interval_ms, sample_count)
    specs = {tuple(s.eng._spec1) for s in pair.sides}
    assert len(specs) == 1, specs


def both(pair, fn):
    out = [fn(s) for s in pair.sides]
    assert out[0] == out[1], out
    return out[1]


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


# ---------------------------------------------------------------------------
# set_window_geometry (tests/test_flow.py, test_lease.py, test_occupy.py,
# test_step_fuzz.py) and set_clock, in an order that keeps retunes few
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [(1000, 3), (0, None), (-1000, 2),
                                 (1000, 0), (999, 2)])
def test_invalid_geometry_rejected(pair, bad):
    assert both(pair, lambda s: tuple(s.eng._spec1)) == DEFAULT_GEOMETRY

    def go(s):
        with pytest.raises(ValueError):
            s.eng.set_window_geometry(*bad)
        return tuple(s.eng._spec1)

    assert both(pair, go) == DEFAULT_GEOMETRY


def test_set_clock_drops_state_keeps_rules_rebuilds_leases(pair):
    geometry(pair, *DEFAULT_GEOMETRY)
    pair.rules(flow=[dict(resource="c", count=3)],
               degrade=[dict(resource="cd", count=1, time_window=5)])
    for _ in range(4):
        pair.entry("c")
    pair.advance(2_000)
    for s in pair.sides:
        s.eng.seal_metrics()  # the process clock's seconds are sealed
    # An injected clock a day EARLIER than the process clock.
    start = ptu.current_time_millis() - 86_400_000
    clocks = {s.name: Clock(start) for s in pair.sides}
    for s in pair.sides:
        lease = s.eng._leases["c"]
        s.eng.set_clock(clocks[s.name])
        assert s.eng._state is None  # statistics restart cold
        assert s.eng._leases["c"] is not lease  # the mirror rebuilt cold
        assert [r.resource for r in s.eng.flow_rules.get_rules()] == ["c"]
        assert s.eng.now_ms() == start
    assert [pair.entry("c") for _ in range(4)] == \
        ["pass"] * 3 + ["FlowException"]
    assert pair.entry("cd") == "pass"
    for s in pair.sides:
        s.eng._flush_committer()
        clocks[s.name].now += 2_000
    # An earlier timebase must not wedge the metric log.
    sealed = [[vars(n) for n in s.eng.seal_metrics()] for s in pair.sides]
    _assert_close(sealed[1], sealed[0], "seal_metrics")
    c = [n for n in sealed[1] if n["resource"] == "c"]
    assert c and c[0]["pass_qps"] == 3 and c[0]["block_qps"] == 1
    assert c[0]["timestamp"] == start // 1000 * 1000
    pair.check(seal=False)
    for s in pair.sides:
        s.eng.set_clock(None)  # back to the process clock, cold again
        assert s.eng._state is None and s.eng._clock is None
    assert [pair.entry("c") for _ in range(4)] == \
        ["pass"] * 3 + ["FlowException"]
    pair.check()


def test_retune_resets_instant_window_and_keeps_quota_rate(pair):
    geometry(pair, *DEFAULT_GEOMETRY)
    pair.rules(flow=[dict(resource="geo", count=3)])
    assert [pair.entry("geo") for _ in range(5)] == \
        ["pass"] * 3 + ["FlowException"] * 2
    geometry(pair, 2000, 4)
    assert both(pair, lambda s: s.eng._spec1.bucket_ms) == 500
    # Stats reset, and passQps is normalized per second: the i-th burst
    # entry sees i * 0.5 QPS, so five pass.
    assert [pair.entry("geo") for _ in range(7)] == \
        ["pass"] * 5 + ["FlowException"] * 2
    pair.check()


def test_retune_drops_pre_retune_queued_usage(pair):
    pair.rules(flow=[dict(resource="retq", count=4)])
    for _ in range(3):
        assert pair.entry("retq") == "pass"
    assert pair.p.eng.committer.pending()[0] == 3  # queued, not flushed
    # Any other geometry: the queued passes land in the OLD window first.
    other = (2000, 4) if tuple(pair.p.eng._spec1) != (2000, 4) \
        else DEFAULT_GEOMETRY
    geometry(pair, *other)
    now = ptu.current_time_millis()
    assert both(pair, lambda s: s.eng._leases["retq"].usage(now)) == 0.0
    assert both(pair, lambda s: s.eng.node_snapshot()["retq"]["passQps"]) \
        == 0.0
    pair.check()


def test_retune_with_compiled_leased_engine(pair):
    geometry(pair, *DEFAULT_GEOMETRY)
    pair.rules(flow=[dict(resource="ret", count=5)])
    for _ in range(3):
        assert pair.entry("ret") == "pass"
    for s in pair.sides:
        s.eng._flush_committer()  # the device state exists
    geometry(pair, 2000, 4)
    assert both(pair, lambda s: s.eng._leases["ret"].buckets) == 4
    assert [pair.entry("ret") for _ in range(12)] == \
        ["pass"] * 9 + ["FlowException"] * 3
    geometry(pair, 1000, 2)  # shrink: no stale tail buckets survive
    assert both(pair, lambda s: s.eng._leases["ret"].buckets) == 2
    assert [pair.entry("ret") for _ in range(7)] == \
        ["pass"] * 5 + ["FlowException"] * 2
    pair.check()


def test_occupy_timeout_clamps_to_a_shrunk_window(pair):
    geometry(pair, *DEFAULT_GEOMETRY)
    for s in pair.sides:
        s.eng.set_occupy_timeout(123)
    geometry(pair, 100, 2)
    assert both(pair, lambda s: s.eng._occupy_timeout_ms) == 100

    def go(s):
        with pytest.raises(ValueError):
            s.eng.set_occupy_timeout(101)
        return s.eng._occupy_timeout_ms

    assert both(pair, go) == 100
    # One pass fills a 100 ms window to 10 QPS: prioritized entries then
    # borrow the next bucket within the clamped cap, or block.
    pair.rules(flow=[dict(resource="occ", count=20)])
    got = [pair.entry("occ", prioritized=True) for _ in range(4)]
    assert got[:2] == ["pass", "pass"] and set(got[2:]) - {"pass"}
    pair.check()


def test_retune_keeps_minute_window_and_gauges(pair):
    """Retunes from whatever geometry the previous test left."""
    pair.rules(flow=[dict(resource="geo2", count=100)])
    for _ in range(4):
        assert pair.entry("geo2") == "pass"
    pair.advance(2_000)  # the second is sealed into the minute window
    sealed = [[vars(n) for n in s.eng.seal_metrics()] for s in pair.sides]
    _assert_close(sealed[1], sealed[0], "seal_metrics")
    assert any(n["resource"] == "geo2" for n in sealed[1])
    geometry(pair, 500, 1)
    snap = both(pair, lambda s: s.eng.node_snapshot()["geo2"])
    assert snap["passQps"] == 0.0 and snap["curThreadNum"] == 0
    assert pair.entry("geo2") == "pass"
    pair.check()


@pytest.mark.parametrize("seed,interval_ms,buckets", [
    (21, 2000, 4), (87, 500, 5)])
def test_fuzz_qps_under_retuned_geometry(pair, seed, interval_ms, buckets):
    """``tests/test_step_fuzz.py``: QPS admission through check_batch
    under a retuned geometry, held against the serial LeapArray oracle at
    the same geometry on both engines."""
    geometry(pair, interval_ms, buckets)
    rng = np.random.default_rng(seed)
    resources = [f"g{i}" for i in range(5)]
    thr = {r: int(rng.integers(1, 12)) for r in resources}
    pair.rules(flow=[dict(resource=r, count=thr[r]) for r in resources])
    oracles = {r: OracleLeapArray(interval_ms, buckets, 1)
               for r in resources}
    rows = {s.name: {r: s.eng.registry.cluster_row(r) for r in resources}
            for s in pair.sides}
    now = ptu.current_time_millis()
    for step in range(40):
        now += int(rng.integers(0, int(interval_ms * 1.2)))
        n = int(rng.integers(3, 9))
        meta = [resources[int(rng.integers(0, len(resources)))]
                for _ in range(n)]
        got = {}
        for s in pair.sides:
            s.tu.freeze_time(now)
            buf = make_entry_batch_np(8)
            for i, r in enumerate(meta):
                buf["cluster_row"][i] = rows[s.name][r]
                buf["count"][i] = 1
            dec = s.eng.check_batch(
                jax_entry(buf) if s.name == "jax" else buf, now_ms=now)
            got[s.name] = np.asarray(dec.reason)[:n].tolist()
        want = []
        for r in meta:
            o = oracles[r]
            used = o.total(now, 0) * (1000.0 / interval_ms)
            if used + 1 <= thr[r]:
                want.append(int(JC.BlockReason.PASS))
                o.add(now, 0, 1)
            else:
                want.append(int(JC.BlockReason.FLOW))
        assert got["jax"] == got["port"] == want, (step, meta)
    pair.check(seal=False)
