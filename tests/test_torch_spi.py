"""SPI device checkers (``sentinel_tpu_torch/core/spi.py`` and the splice in
``ops/step.py:entry_step``) on the port against the JAX package.

Each checker is written twice, once per package: the JAX one on
``jax.numpy`` arrays, the port's on torch tensors (the same expression
where the two APIs agree). An engine pair (``tests/test_torch_property.py
:Twin``: a JAX engine and a port engine on ``device="cpu"``, equal
injected clocks) runs the reference's scenarios (``tests/test_spi.py:91``
and ``:112``) through ``entry`` and the splice's attribution through
``check_batch``: reasons (``CUSTOM``), ``rule_slot`` (the checker's index
in ``order``), ``blockQps`` token-weighted and the state must be equal.
Then the port's own paths: the lease and the unruled pass standing down
while a checker is registered and coming back after, a checker on a
committer flush and on a slot-mode dispatch, a verdict of the wrong shape
or type refused, a checker that raises failing open, and no host sync
added by the splice. Every JAX (un)registration re-jits its step, so the
tests keep them few.
"""

from __future__ import annotations

import pytest
import torch

from sentinel_tpu.core import spi as jspi
from sentinel_tpu.ops import window as JW

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core import spi as pspi
from sentinel_tpu_torch.core.batch import make_entry_batch_np
from sentinel_tpu_torch.ops import window as PW
from sentinel_tpu_torch.utils.device import SYNCS

from tests.test_torch_property import Twin, pair_verdict
from tests.test_torch_support import (assert_decisions_equal, jax_entry,
                                      jax_to_np, port_np, assert_tree_equal)


def cap_big_acquires(_window_module):
    def cap_big_acquires(state, rules, batch, now_ms, candidate):
        return candidate & (batch.count > 3)

    return cap_big_acquires


def two_per_second(window_module):
    """At most 2 PASS per second per cluster row, from the rotated w1."""

    def two_per_second(state, rules, batch, now_ms, candidate):
        totals = window_module.row_totals(state.w1, batch.cluster_row)
        return candidate & (totals[:, C.MetricEvent.PASS] >= 2)

    return two_per_second


class Registered:
    """One checker per package, registered in each package's SPI for the
    ``with`` block."""

    def __init__(self, factory, order=0):
        self.j, self.p = factory(JW), factory(PW)
        self.order = order

    def __enter__(self):
        jspi.register_device_checker(self.j, order=self.order)
        pspi.register_device_checker(self.p, order=self.order)
        return self

    def __exit__(self, *exc):
        jspi.unregister_device_checker(self.j)
        pspi.unregister_device_checker(self.p)
        return False


@pytest.fixture(scope="module")
def twin():
    mp = pytest.MonkeyPatch()
    for spi in (jspi, pspi):
        spi.reset_spi_for_tests()
    pair = Twin(mp, {}, lease=True, capacity=512)
    yield pair
    pair.close()
    mp.undo()
    for spi in (jspi, pspi):
        spi.reset_spi_for_tests()


@pytest.fixture
def pair(twin):
    twin.advance(10_000)  # every window rolls over between tests
    for _, _, eng, _ in twin.sides:
        eng._flush_committer()
    yield twin
    for _, _, eng, _ in twin.sides:
        eng._flush_committer()


def counted_device_entries(twin):
    """Count each engine's width-1 device dispatches of ``entry()``."""
    counts = {}
    for name, _, eng, _ in twin.sides:
        counts[name] = 0
        submit = eng._submit_entry

        def wrapped(*a, _submit=submit, _name=name, **k):
            counts[_name] += 1
            return _submit(*a, **k)

        eng._submit_entry = wrapped
    return counts


def test_checker_blocks_custom_token_weighted_then_unregisters(pair):
    """tests/test_spi.py:91: a count cap blocks inside the fused step with
    the base BlockException (reason CUSTOM), token-weighted in blockQps;
    unregistered, the same entry passes."""
    with Registered(cap_big_acquires):
        assert pair.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, "r", count=3)) == "pass"
        assert pair.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, "r", count=4)) == "BlockException"
        snap = pair.both(lambda st, eng, clock: eng.node_snapshot()["r"])
        assert snap["blockQps"] == 4 and snap["passQps"] == 3
        pair.check_state()
    assert pair.both(lambda st, eng, clock: pair_verdict(
        st, eng, clock, "r", count=4)) == "pass"


def test_checker_reads_the_rotated_window(pair):
    """tests/test_spi.py:112: a 2-per-second limit from w1 alone."""
    with Registered(two_per_second):
        got = [pair.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, "w2")) for _ in range(5)]
        assert got == ["pass"] * 2 + ["BlockException"] * 3
        pair.advance(1000)  # the window rotates: two more pass
        got = [pair.both(lambda st, eng, clock: pair_verdict(
            st, eng, clock, "w2")) for _ in range(3)]
        assert got == ["pass"] * 2 + ["BlockException"]
        pair.check_state()


def test_splice_order_attribution_and_flow_after_it(pair):
    """Through ``check_batch``: checkers run in ``order``, ``rule_slot`` is
    the blocking checker's index, lanes a checker blocks reach flow
    decided (a count-2 QPS rule on the same row still admits two), and
    lanes other slots decided are not candidates."""
    pair.load(flow=[dict(resource="b0", count=2)])
    rows = pair.both(lambda st, eng, clock: [
        eng.registry.cluster_row(f"b{i}") for i in range(3)])
    buf = make_entry_batch_np(8)
    buf["cluster_row"][:] = [rows[0], rows[0], rows[0], rows[1], rows[1],
                             rows[1], rows[2], rows[0]]
    buf["count"][:] = [5, 1, 1, 1, 1, 1, 4, 1]
    with Registered(two_per_second, order=5), \
            Registered(cap_big_acquires, order=-1):
        assert pspi.device_checkers()[0].__name__ == "cap_big_acquires"
        decs = []
        for _ in range(2):
            jdec = pair.j.check_batch(jax_entry(buf))
            pdec = pair.p.check_batch(buf)
            assert_decisions_equal(jdec, pdec)
            decs.append(pdec)
            pair.check_state()
    reason, slot = decs[0].reason.numpy(), decs[0].rule_slot.numpy()
    custom = int(C.BlockReason.CUSTOM)
    assert reason[0] == custom and slot[0] == 0  # the cap, spliced first
    assert reason[6] == custom and slot[6] == 0
    assert (reason[[1, 2, 7]] == [0, 0, int(C.BlockReason.FLOW)]).all()
    # The second batch: the rows already passed twice this second.
    reason2, slot2 = decs[1].reason.numpy(), decs[1].rule_slot.numpy()
    assert reason2[3] == custom and slot2[3] == 1
    with pair.j._lock, pair.p._lock:
        assert_tree_equal(jax_to_np(pair.j._state), port_np(pair.p.state))


def test_fast_paths_stand_down_while_registered_and_come_back(pair):
    """Leased and unruled entries go to the device while a checker is
    registered (on both engines); after unregistering, the lease table
    built before the registration serves again at once, and one rebuilt
    while registered (empty) serves again at the next rule rebuild."""
    pair.load(flow=[dict(resource="lz", count=100)])
    for _, _, eng, _ in pair.sides:
        assert "lz" in eng._leases
    counts = counted_device_entries(pair)

    def served(*names):
        for res in names:
            assert pair.both(lambda st, eng, clock: pair_verdict(
                st, eng, clock, res)) == "pass"
        return dict(counts)

    try:
        with Registered(cap_big_acquires):
            assert served("lz", "unruled") == {"jax": 2, "port": 2}
        assert served("lz", "unruled") == {"jax": 2, "port": 2}  # at once
        with Registered(cap_big_acquires):
            # A rule push while registered builds no lease.
            pair.load(flow=[dict(resource="lz", count=100)])
            assert pair.both(lambda st, eng, clock: dict(eng._leases)) == {}
        assert served("lz") == {"jax": 3, "port": 3}  # until a rebuild
        pair.both(lambda st, eng, clock: eng.reset_slot_floor()["flow"])
        assert served("lz", "unruled") == {"jax": 3, "port": 3}
    finally:
        for _, _, eng, _ in pair.sides:
            del eng._submit_entry
    for _, _, eng, _ in pair.sides:
        eng._flush_committer()
    pair.check_state()


def test_checker_runs_on_committer_flushes_and_the_pipeline(pair):
    """Every entry dispatch carries the checkers: a committer flush (its
    lanes arrive pre-passed, so the checker sees no candidate) and a
    pipeline cycle (the checker blocks there as on the width-1 path)."""
    eng = pair.p
    pair.load(flow=[dict(resource="lf", count=100)])
    assert eng.committer is None or eng.committer.pending() == (0, 0)
    for _ in range(3):
        pair_verdict(pst, eng, pair.pclock, "lf")
    assert eng.committer.pending()[0] == 3
    seen = []

    def watch(state, rules, batch, now_ms, candidate):
        seen.append((int(batch.count.sum()), int(candidate.sum())))
        return candidate & (batch.count > 3)

    pspi.register_device_checker(watch)
    try:
        eng._flush_committer()
        assert seen and seen[0] == (3, 0)
        eng.start_pipeline(max_batch=8, linger_s=0.0)
        try:
            assert pair_verdict(pst, eng, pair.pclock, "lf", count=4) == \
                "BlockException"
            assert pair_verdict(pst, eng, pair.pclock, "lf") == "pass"
        finally:
            eng.stop_pipeline()
    finally:
        pspi.unregister_device_checker(watch)
    assert eng.pipeline_stats()["cycles"] >= 2
    assert eng.fail_open_count == 0


def test_checker_on_slot_mode_dispatch(monkeypatch):
    """A slot-mode engine's device path (``_slot_submit``) carries the
    checker, and the leased-hot fast path stands down, on both engines."""
    for spi in (jspi, pspi):
        spi.reset_spi_for_tests()
    twin = Twin(monkeypatch, {}, slot_budget=8)
    try:
        twin.load(flow=[dict(resource="h", count=100)])
        with Registered(cap_big_acquires):
            got = [twin.both(lambda st, eng, clock: pair_verdict(
                st, eng, clock, res, count=n))
                for res, n in (("h", 4), ("h", 1), ("t", 5), ("t", 2))]
            assert got == ["BlockException", "pass"] * 2
            twin.check_state()
            assert twin.both(lambda st, eng, clock:
                             eng.slots.checkpoint_dict()["hot"].keys() ==
                             {"h", "t"})
    finally:
        twin.close()


def _port_engine():
    pctx.replace_context(None)
    pctx.bump_generation()  # retire a context pooled by an earlier engine
    return pst.SentinelEngine(64, device="cpu")


@pytest.mark.parametrize("bad", [
    lambda cand: cand[:-1],                 # wrong shape
    lambda cand: cand.to(torch.int32),      # not bool
    lambda cand: cand.numpy(),              # not a tensor
], ids=["shape", "dtype", "numpy"])
def test_malformed_verdict_raises_and_the_entry_fails_open(bad):
    eng = _port_engine()

    def malformed(state, rules, batch, now_ms, candidate):
        return bad(candidate)

    pspi.register_device_checker(malformed)
    try:
        with pytest.raises(pst.DeviceDispatchError, match="malformed"):
            eng.check_batch(make_entry_batch_np(8))
        assert eng.state is None  # dropped cold, rules kept
        before = eng.fail_open_count
        h = eng.entry("x")  # the width-1 path fails open, counted
        h.exit()
        assert eng.fail_open_count == before + 1
    finally:
        pspi.unregister_device_checker(malformed)
        eng.close()
    assert eng.fail_open_count == before + 1


def test_raising_checker_fails_open_counted():
    eng = _port_engine()

    def boom(state, rules, batch, now_ms, candidate):
        raise RuntimeError("checker bug")

    pspi.register_device_checker(boom)
    try:
        h = eng.entry("y")
        h.exit()
        assert eng.fail_open_count == 1
    finally:
        pspi.unregister_device_checker(boom)
    h = eng.entry("y")  # recovered cold, guarded again
    h.exit()
    assert eng.fail_open_count == 1
    eng.close()


def test_splice_adds_no_host_sync():
    eng = _port_engine()
    buf = make_entry_batch_np(8)
    buf["cluster_row"][:] = eng.registry.cluster_row("s")
    buf["count"][:] = 1
    eng.check_batch(buf)

    def syncs():
        before = SYNCS.count
        eng.check_batch(buf)
        return SYNCS.count - before

    plain = syncs()
    with_checker = cap_big_acquires(PW)
    pspi.register_device_checker(with_checker)
    try:
        assert syncs() == plain
    finally:
        pspi.unregister_device_checker(with_checker)
    assert syncs() == plain
    eng.close()
