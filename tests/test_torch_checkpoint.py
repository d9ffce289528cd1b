"""The engine-level checkpoint (``sentinel_tpu_torch/core/checkpoint.py``)
on the port against the JAX package.

Interchange: an engine pair (``tests/test_torch_property.py:Twin``: a JAX
engine and a port engine on ``device="cpu"``, equal injected clocks, the
lease off) serves one scripted stream; each side saves, and the two files
must hold the same header and the same twelve arrays, dtype for dtype.
The port's file then restores into the JAX engine and the JAX file into
a fresh port engine, in fixed-capacity and in slot mode: the grafted
state must be equal, and so must the next stream's verdicts and state.
(The JAX side restores with ``force=True`` into its quiesced engine: a
fresh JAX engine would compile its step again.) Then the C11 case: a
JAX checkpoint taken under a 2000 ms / 4-bucket window restores into a
port engine built under the same keys, and a port engine of another
geometry refuses it.

The reference's engine-level scenarios (``tests/test_checkpoint.py``,
``tests/test_checkpoint_scenarios.py:37``, ``:75``,
``tests/test_slots.py:390``) run on the port with the reference's own
assertions; the JAX package's tests hold the reference to the same ones.
Exact everywhere.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from sentinel_tpu.core import checkpoint as jckpt

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import checkpoint as pckpt
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.config import config as pconfig
from sentinel_tpu_torch.resilience.faults import FaultInjected, FaultInjector
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_property import (INTERVAL, OCCUPY, SAMPLES,
                                       STREAM_RULES, Clock, run_stream,
                                       stream_ops, twins)  # noqa: F401

NOW0 = 1_700_000_000_000


def assert_files_equal(jpath, ppath):
    jh, ja = jckpt._load_npz(jpath)
    ph, pa = pckpt._load_npz(ppath)
    assert ph == jh
    assert set(pa) == set(ja)
    for k in ja:
        assert pa[k].dtype == ja[k].dtype and pa[k].shape == ja[k].shape, k
        np.testing.assert_array_equal(pa[k], ja[k], err_msg=k)
    return ph, pa


def restore_across(twin, fresh_port, tmp_path):
    """Both sides save; the files must be equal; the port's file restores
    into the JAX engine (forced: it is quiesced) and the JAX file into
    ``fresh_port``, which takes the port engine's place in ``twin``."""
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(twin.j, jpath)
    pst.save_checkpoint(twin.p, ppath)
    header, arrays = assert_files_equal(jpath, ppath)
    fresh_clock = Clock(twin.pclock.now)
    fresh = fresh_port(fresh_clock)
    pctx.replace_context(None)
    pst.restore_checkpoint(fresh, jpath)
    jckpt.restore_checkpoint(twin.j, ppath, force=True)
    twin.p.close()
    twin.p, twin.pclock = fresh, fresh_clock
    twin.sides = (twin.sides[0], ("port", pst, fresh, fresh_clock))
    # The grafted tensors are the file's, on the engine's device, with the
    # schema's dtypes and shapes; the gauges restart at zero.
    got = pckpt._state_arrays(fresh.state)
    for k, want in arrays.items():
        t = got[k]
        assert t.device == fresh.device and t.dtype == torch.from_numpy(
            want).dtype and tuple(t.shape) == want.shape, k
        if k != "cur_threads":
            np.testing.assert_array_equal(t.numpy(), want, err_msg=k)
    assert int(fresh.state.cur_threads.abs().sum()) == 0
    twin.check_state()
    return header


def test_checkpoints_interchange_in_fixed_capacity_mode(twins, tmp_path):
    twin = twins({})
    twin.load(**STREAM_RULES)
    ops = stream_ops(3, 80, 20)
    run_stream(twin, ops)
    header = restore_across(twin, lambda clock: _port_engine(
        twin, clock), tmp_path)
    assert header["llm_streams"] == [] and "slots" not in header
    run_stream(twin, ops)
    twin.check_state()


def _port_engine(twin, clock, slot_budget=0, keys=()):
    """A fresh port engine like ``twin``'s: the lease off, the same rules,
    built under ``keys`` (config key -> value)."""
    try:
        for key, value in dict(keys).items():
            pconfig.set(key, str(value))
        eng = pst.SentinelEngine(twin.p.capacity, device="cpu", clock=clock,
                                 slot_budget=slot_budget)
    finally:
        pconfig.reset_for_tests()
    eng.lease_enabled = False
    eng._rebuild_leases()
    for mgr in ("flow_rules", "degrade_rules", "param_rules"):
        getattr(eng, mgr).load_rules(getattr(twin.p, mgr).get_rules())
    return eng


def test_checkpoints_interchange_in_slot_mode(twins, tmp_path):
    """Budget 8 (six usable slots) against seven names: the assignment and
    its generations travel in the header, and ruled names restore at
    their checkpointed slots before the rules compile."""
    twin = twins({}, slot_budget=8)
    twin.load(flow=[dict(resource="s0", count=3), dict(resource="s3",
                                                       count=2)])
    names = [f"s{i}" for i in range(7)]
    rng = np.random.default_rng(4)
    ops = [(names[int(rng.integers(7))], 1, False, False,
            int(rng.integers(0, 60)), 0) for _ in range(60)]
    run_stream(twin, ops)
    header = restore_across(twin, lambda clock: _port_engine(
        twin, clock, slot_budget=8), tmp_path)
    assert len(header["slots"]["hot"]) >= 2
    assert twin.both(lambda st, eng, clock: eng.slots.checkpoint_dict()) \
        == header["slots"]
    run_stream(twin, ops)
    twin.check_state()


def test_jax_checkpoint_under_a_config_window_restores_into_the_port(
        twins, tmp_path):
    """C11: the geometry the header records is the config-seeded one; a
    port engine built under the same keys restores it bit for bit and then
    decides as the JAX engine does; one of another geometry refuses it."""
    keys = {INTERVAL: 2000, SAMPLES: 4, OCCUPY: 250}
    twin = twins(keys)
    twin.load(**STREAM_RULES)
    ops = stream_ops(8, 80, 20)
    run_stream(twin, ops)
    path = str(tmp_path / "c11.npz")
    jckpt.save_checkpoint(twin.j, path)
    header, _ = jckpt._load_npz(path)
    assert (header["w1_interval_ms"], header["w1_sample_count"]) == (2000, 4)
    other = twins({})
    with pytest.raises(ValueError, match="geometry"):
        pst.restore_checkpoint(other.p, path)
    assert other.p.registry.rows_in_use() == 2  # nothing changed
    restore_across(twin, lambda clock: _port_engine(twin, clock, keys=keys),
                   tmp_path)
    assert twin.geometry() == (2000, 4, 250)
    run_stream(twin, ops)
    twin.check_state()


# ---------------------------------------------------------------------------
# The reference's scenarios on the port (module API, frozen clock)
# ---------------------------------------------------------------------------


@pytest.fixture
def engine():
    ptu.freeze_time(NOW0)
    pctx.replace_context(None)
    eng = pst.reset(capacity=512, device="cpu")
    yield eng
    pctx.replace_context(None)
    pst.get_engine().close()
    ptu.unfreeze_time()


def _restart():
    """The "crash": a cold default engine with the same rules loaded."""
    pctx.replace_context(None)
    return pst.reset(capacity=512, device="cpu")


def test_stats_survive_restart(engine, tmp_path):
    """tests/test_checkpoint.py:15."""
    pst.load_flow_rules([pst.FlowRule(resource="warm", count=3)])
    for _ in range(5):
        pst.entry_ok("warm")
    before = engine.node_snapshot()["warm"]
    assert before["passQps"] == 3 and before["blockQps"] == 2
    ckpt = str(tmp_path / "stats.npz")
    pst.save_checkpoint(engine, ckpt)
    fresh = _restart()
    pst.load_flow_rules([pst.FlowRule(resource="warm", count=3)])
    pst.restore_checkpoint(fresh, ckpt)
    after = fresh.node_snapshot()["warm"]
    assert before.pop("curThreadNum") == 3
    assert after.pop("curThreadNum") == 0
    assert after == before
    assert not pst.entry_ok("warm")  # quota still spent this second


def test_windows_expire_after_stale_restore(engine, tmp_path):
    """tests/test_checkpoint.py:42."""
    pst.load_flow_rules([pst.FlowRule(resource="stale", count=2)])
    pst.entry_ok("stale")
    pst.entry_ok("stale")
    ckpt = str(tmp_path / "stale.npz")
    pst.save_checkpoint(engine, ckpt)
    fresh = _restart()
    pst.load_flow_rules([pst.FlowRule(resource="stale", count=2)])
    pst.restore_checkpoint(fresh, ckpt)
    ptu.advance_time(5_000)
    assert pst.entry_ok("stale")


def test_registry_rows_and_tree_survive(engine, tmp_path):
    """tests/test_checkpoint.py:55."""
    pst.context_enter("ctxA", origin="appZ")
    pst.entry("treeres").exit()
    pst.exit_context()
    row = engine.registry.cluster_row("treeres")
    ckpt = str(tmp_path / "reg.npz")
    pst.save_checkpoint(engine, ckpt)
    fresh = _restart()
    pst.restore_checkpoint(fresh, ckpt)
    assert fresh.registry.get_cluster_row("treeres") == row
    assert fresh.registry.origin_id("appZ") == engine.registry.origin_id(
        "appZ")
    names = set()

    def walk(n):
        names.add(n["resource"])
        for c in n["children"]:
            walk(c)

    walk(fresh.tree_dict())
    assert "treeres" in names


def test_capacity_and_mode_mismatches_rejected(engine, tmp_path):
    """tests/test_checkpoint.py:79, and the slot-mode refusal of
    tests/test_slots.py:390 (fixed-capacity file into a slot engine)."""
    ckpt = str(tmp_path / "cap.npz")
    pst.save_checkpoint(engine, ckpt)
    other = pst.SentinelEngine(capacity=1024, device="cpu")
    slotted = pst.SentinelEngine(device="cpu", slot_budget=512)
    try:
        with pytest.raises(ValueError, match="capacity"):
            pst.restore_checkpoint(other, ckpt)
        with pytest.raises(ValueError, match="slot"):
            pst.restore_checkpoint(slotted, ckpt)
    finally:
        other.close()
        slotted.close()


def test_checkpoint_timer_writes_periodically(engine, tmp_path):
    """tests/test_checkpoint.py:87, plus stop, restart after stop, and a
    failing save logged, never raised."""
    ckpt = str(tmp_path / "timer.npz")
    timer = pst.CheckpointTimer(engine, ckpt, period_s=0.05).start()
    try:
        deadline = time.time() + 5
        while not os.path.exists(ckpt) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.exists(ckpt)
        assert timer.start() is timer  # a live thread: start is a no-op
    finally:
        timer.stop()
    assert timer._thread is None
    os.unlink(ckpt)
    timer.start()  # again after a stop
    try:
        deadline = time.time() + 5
        while not os.path.exists(ckpt) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.exists(ckpt)
    finally:
        timer.stop()
    calls = []

    def failing(eng, path):
        calls.append(path)
        raise OSError("disk full")

    bad = pst.CheckpointTimer(engine, ckpt, period_s=0.02,
                              save=failing).start()
    try:
        deadline = time.time() + 5
        while len(calls) < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert len(calls) >= 2 and bad._thread.is_alive()
    finally:
        bad.stop()
    fresh = _restart()
    pst.restore_checkpoint(fresh, ckpt)


def test_restore_into_served_engine_refused(engine, tmp_path):
    """tests/test_checkpoint.py:105."""
    ckpt = str(tmp_path / "live.npz")
    pst.save_checkpoint(engine, ckpt)
    pst.entry_ok("livetraffic")
    with pytest.raises(RuntimeError, match="fresh engine"):
        pst.restore_checkpoint(engine, ckpt)
    pst.restore_checkpoint(engine, ckpt, force=True)


def test_registry_roundtrip_with_hostile_names(engine):
    """tests/test_checkpoint.py:117."""
    pst.context_enter("ctx\x00weird", origin="app\x00x")
    h = pst.entry_ok("res\x00name")
    if h:
        h.exit()
    pst.exit_context()
    reg = engine.registry
    restored = type(reg).from_dict(json.loads(json.dumps(reg.to_dict())))
    assert restored._default == reg._default
    assert restored._origin == reg._origin
    assert restored.get_cluster_row("res\x00name") == \
        reg.get_cluster_row("res\x00name")


def test_corrupted_checkpoint_rejected_with_clear_error(engine, tmp_path):
    """tests/test_checkpoint.py:136."""
    ckpt = str(tmp_path / "chop.npz")
    pst.load_flow_rules([pst.FlowRule(resource="chop", count=3)])
    pst.entry_ok("chop")
    pst.save_checkpoint(engine, ckpt)
    raw = open(ckpt, "rb").read()
    fresh = _restart()
    for cut in (len(raw) // 2, len(raw) - 7, 10, 1, 0):
        with open(ckpt, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(ValueError, match="corrupted or truncated"):
            pst.restore_checkpoint(fresh, ckpt)
    with pytest.raises(FileNotFoundError):
        pst.restore_checkpoint(fresh, str(tmp_path / "never-written.npz"))
    with open(ckpt, "wb") as f:
        f.write(raw)
    pst.restore_checkpoint(fresh, ckpt)


def test_incompatible_schema_and_llm_streams_refused_before_any_change(
        engine, tmp_path):
    """A header whose ``llm_streams`` is not empty names the unported
    ledger, and a missing or mistyped array is refused; the engine is
    unchanged after each refusal."""
    pst.load_flow_rules([pst.FlowRule(resource="x", count=3)])
    pst.entry_ok("x")
    ckpt = str(tmp_path / "x.npz")
    pst.save_checkpoint(engine, ckpt)
    header, arrays = pckpt._load_npz(ckpt)
    fresh = _restart()
    rows = fresh.registry.to_dict()
    cases = [(dict(header, llm_streams=[{"streamId": "s1"}]), arrays,
              "llm/"),
             (header, {k: v for k, v in arrays.items() if k != "sec_stamp"},
              "missing sec_stamp"),
             (header, dict(arrays, w1_starts=arrays["w1_starts"].astype(
                 np.int32)), "w1_starts is int32"),
             (dict(header, version=2), arrays, "version")]
    for i, (h, a, match) in enumerate(cases):
        path = str(tmp_path / f"bad{i}.npz")
        pckpt._atomic_savez(path, h, a)
        with pytest.raises(ValueError, match=match):
            pst.restore_checkpoint(fresh, path)
        assert fresh.registry.to_dict() == rows and fresh.state is None


def test_torn_write_seam_in_both_modes(engine, tmp_path):
    """checkpoint.torn.write: error mode aborts before the rename (the good
    file survives); garbage mode publishes a torn file, which restore
    refuses as one ValueError. No temp file is left either way."""
    pst.entry_ok("torn")
    path = str(tmp_path / "torn.npz")
    pst.save_checkpoint(engine, path)
    good = open(path, "rb").read()
    with FaultInjector(seed=1) as inj:
        inj.arm("checkpoint.torn.write", "error", times=1)
        with pytest.raises(FaultInjected):
            pst.save_checkpoint(engine, path)
        assert open(path, "rb").read() == good
        inj.arm("checkpoint.torn.write", "garbage", times=1)
        pst.save_checkpoint(engine, path)
    fresh = _restart()
    with pytest.raises(ValueError, match="corrupted or truncated"):
        pst.restore_checkpoint(fresh, path)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".ckpt.tmp")]


def test_atomic_save_leaves_no_tmp_residue(engine, tmp_path):
    """tests/test_checkpoint.py:289."""
    for name in ("a.npz", "b.npz"):
        pst.save_checkpoint(engine, str(tmp_path / name))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".ckpt.tmp")]


def test_restore_after_rule_load_seeds_lease_mirror(engine, tmp_path):
    """tests/test_checkpoint.py:328: a rule load allocates no rows, and
    after restore the lease mirror equals the restored window."""
    pst.load_flow_rules([pst.FlowRule(resource="mir", count=10)])
    for _ in range(4):
        assert pst.entry_ok("mir")
    engine._flush_committer()
    ckpt = str(tmp_path / "mir.npz")
    pst.save_checkpoint(engine, ckpt)
    fresh = _restart()
    pst.load_flow_rules([pst.FlowRule(resource="mir", count=10)])
    pst.restore_checkpoint(fresh, ckpt)
    now = ptu.current_time_millis()
    assert fresh._leases["mir"].usage(now) == pytest.approx(4.0)
    assert sum(1 for _ in range(8) if pst.entry_ok("mir")) == 6


def test_leased_traffic_checkpoint_crash_restore(engine, tmp_path):
    """tests/test_checkpoint_scenarios.py:37."""
    pst.load_flow_rules([pst.FlowRule(resource="lw", count=10)])
    assert "lw" in engine._leases
    for _ in range(6):
        h = pst.entry_ok("lw")
        assert h
        h.exit()
    engine._flush_committer()
    snap = engine.node_snapshot()["lw"]
    assert snap["passQps"] == 6 and snap["successQps"] == 6
    ckpt = str(tmp_path / "lease.npz")
    pst.save_checkpoint(engine, ckpt)
    fresh = _restart()
    pst.load_flow_rules([pst.FlowRule(resource="lw", count=10)])
    pst.restore_checkpoint(fresh, ckpt)
    snap2 = fresh.node_snapshot()["lw"]
    assert snap2["passQps"] == 6 and snap2["successQps"] == 6
    assert fresh._leases["lw"].usage(
        ptu.current_time_millis()) == pytest.approx(6.0)
    got = [bool(pst.entry_ok("lw")) for _ in range(6)]
    assert got == [True] * 4 + [False] * 2
    fresh._flush_committer()
    assert fresh.node_snapshot()["lw"]["passQps"] == 10
    assert fresh._leases["lw"].usage(
        ptu.current_time_millis()) == pytest.approx(10.0)


def test_restore_resets_thread_gauge(engine, tmp_path):
    """tests/test_checkpoint_scenarios.py:75."""
    rule = dict(resource="tg", count=2, grade=C.FLOW_GRADE_THREAD)
    pst.load_flow_rules([pst.FlowRule(**rule)])
    h1 = pst.entry("tg")
    h2 = pst.entry("tg")
    assert not pst.entry_ok("tg")
    ckpt = str(tmp_path / "threads.npz")
    pst.save_checkpoint(engine, ckpt)
    del h1, h2
    fresh = _restart()
    pst.load_flow_rules([pst.FlowRule(**rule)])
    pst.restore_checkpoint(fresh, ckpt)
    assert fresh.node_snapshot()["tg"]["blockQps"] == 1
    h = pst.entry_ok("tg")
    assert h
    h.exit()


def test_checkpoint_round_trip_restores_slot_assignment(tmp_path):
    """tests/test_slots.py:390 on the port, with ``timeseries_view`` as
    the fold (the port's stand-in for ``slo_refresh``)."""
    pctx.replace_context(None)
    pctx.bump_generation()  # retire a context pooled by an earlier engine
    path = str(tmp_path / "slots.npz")
    clock = Clock(NOW0)

    def serve(eng, res):
        try:
            eng.entry(res).exit()
            return "P"
        except pst.BlockException:
            return "B"

    eng = pst.SentinelEngine(device="cpu", clock=clock, slot_budget=8)
    try:
        for _ in range(2):
            for res in ("ck-a", "ck-b", "ck-c"):
                serve(eng, res)
            clock.now += 1000
            eng.timeseries_view(now_ms=clock.now)
        pst.save_checkpoint(eng, path)
        saved = eng.slots.checkpoint_dict()
    finally:
        eng.close()
        pctx.replace_context(None)
    assert len(saved["hot"]) == 3
    twin = pst.SentinelEngine(device="cpu", clock=clock, slot_budget=8)
    fixed = pst.SentinelEngine(capacity=8, device="cpu", clock=clock)
    try:
        pst.restore_checkpoint(twin, path)
        assert twin.slots.checkpoint_dict() == saved
        assert serve(twin, "ck-a") == "P"
        assert twin.slots.checkpoint_dict()["hot"]["ck-a"] == \
            saved["hot"]["ck-a"]
        with pytest.raises(ValueError, match="slot"):
            pst.restore_checkpoint(fixed, path)
    finally:
        twin.close()
        fixed.close()
        pctx.replace_context(None)
