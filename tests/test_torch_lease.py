"""The port's token lease (``sentinel_tpu_torch/core/lease.py`` and the C
ring ``csrc/lease_ext.c``) against the JAX package's ``core/lease.py``.

Both packages' leases get the same seeded admit / add / seed / snapshot
sequences and must give equal verdicts and equal ring and mirror state;
the warm-up and param mirrors compute in numpy float32 in both, so their
state is compared exactly. The port's C ring is held against the port's
Python ring call by call, and ``build_lease_table`` eligibility is held
against the JAX package's over the rule shapes of ``tests/test_lease.py``.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import sentinel_tpu as jst
from sentinel_tpu.core import constants as JC
from sentinel_tpu.core import lease as JL
from sentinel_tpu.core.engine import SentinelEngine as JEngine

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import lease as PL
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.native import load_lease_ext
from sentinel_tpu_torch.utils.param_hash import hash_param

NOW0 = 1_700_000_000_000
VALUES = ("a", "b", "c", 7, "vip")


def _mirror_state(lease):
    """Ring + warm-up + param mirror state, as plain comparable values."""
    out = {"ring": lease.snapshot()}
    for i, w in enumerate(getattr(lease, "warm", ())):
        out[f"warm{i}"] = (np.float32(w.stored).tobytes(), w.last_filled_ms)
    param = getattr(lease, "param", None)
    if param is not None:
        out["param"] = sorted(
            (h, np.float32(t).tobytes(), f) for h, (t, f) in
            param.buckets.items())
    return out


def _drive(leases, seed, steps=400, bucket_ms=500, with_params=False):
    """Apply one seeded op sequence to every lease in ``leases``; every
    op's result must agree across them. Returns the verdict list."""
    rng = random.Random(seed)
    now = NOW0
    verdicts = []
    for step in range(steps):
        now += rng.choice([0, 1, 7, 33, bucket_ms, 1000, 2500])
        count = rng.randint(1, 3)
        params = ()
        if with_params and rng.random() < 0.85:
            params = (hash_param(rng.choice(VALUES)),)
        op = rng.random()
        if op < 0.7:
            got = [lease.admit(count, now, params) for lease in leases]
        elif op < 0.85:
            for lease in leases:
                lease.add(count, now, params)
            got = [None] * len(leases)
        elif op < 0.95:
            got = [lease.usage(now) for lease in leases]
        else:
            starts = [now - now % bucket_ms - b * bucket_ms
                      for b in range(leases[0].buckets)]
            counts = [rng.randint(0, 4) for _ in starts]
            for lease in leases:
                lease.seed(starts, counts)
            got = [None] * len(leases)
        assert all(g == got[0] for g in got), (seed, step, got)
        states = [_mirror_state(lease) for lease in leases]
        assert all(s == states[0] for s in states), (seed, step)
        verdicts.append(got[0])
    return verdicts


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_local_lease_matches_jax(seed):
    rng = random.Random(seed)
    thresholds = [float(rng.randint(2, 12)) for _ in range(rng.randint(1, 3))]
    jax_lease = JL.LocalLease(thresholds, 1000, 2)
    native = PL.LocalLease(thresholds, 1000, 2)
    python = PL.LocalLease(thresholds, 1000, 2, use_native=False)
    assert native.native and not python.native
    verdicts = _drive([jax_lease, native, python], seed)
    assert {0, int(JC.BlockReason.FLOW)} <= set(verdicts)


def _wide_pair(count, warm_specs, param_kw):
    jparam = pparam = None
    if param_kw is not None:
        items = param_kw.pop("items", [])
        jparam = jst.ParamFlowRule(
            "w", items=[jst.ParamFlowItem(o, c) for o, c in items],
            **param_kw)
        pparam = pst.ParamFlowRule(
            "w", items=[pst.ParamFlowItem(o, c) for o, c in items],
            **param_kw)
    defaults = [float(count)] if count else []
    return (JL.WideLease(defaults, warm_specs, jparam, 1000, 2),
            PL.WideLease(defaults, warm_specs, pparam, 1000, 2))


@pytest.mark.parametrize("case", [
    "warm", "param", "warm_param_default", "param_items_burst"])
def test_wide_lease_matches_jax(case):
    """Warm-up and param mirrors: same float32 arithmetic, same verdicts,
    the same stored tokens and per-value buckets bit for bit."""
    if case == "warm":
        pair = _wide_pair(0, [(30.0, 4)], None)
    elif case == "param":
        pair = _wide_pair(0, [], dict(param_idx=0, count=3))
    elif case == "warm_param_default":
        pair = _wide_pair(9, [(20.0, 3)], dict(param_idx=0, count=2))
    else:
        pair = _wide_pair(0, [], dict(
            param_idx=0, count=2, burst_count=1, duration_in_sec=2,
            items=[("vip", 5.0), (7, 1.0)]))
    verdicts = _drive(list(pair), seed=sum(map(ord, case)), steps=600,
                      with_params=True)
    assert len(set(verdicts) - {None}) > 1


def test_param_mirror_eviction_matches_jax(monkeypatch):
    """Past the key cap both mirrors evict the same keys (stale first,
    then the oldest-stamped quarter)."""
    monkeypatch.setattr(JL, "_PARAM_MAX_KEYS", 8)
    monkeypatch.setattr(PL, "_PARAM_MAX_KEYS", 8)
    rule = dict(param_idx=0, count=2)
    leases = [JL.WideLease([], [], jst.ParamFlowRule("e", **rule), 1000, 2),
              PL.WideLease([], [], pst.ParamFlowRule("e", **rule), 1000, 2)]
    rng = random.Random(5)
    now = NOW0
    for step in range(300):
        now += rng.choice([0, 10, 400, 3000])
        params = (hash_param(rng.randint(0, 30)),)
        got = [lease.admit(1, now, params) for lease in leases]
        assert got[0] == got[1], step
        assert _mirror_state(leases[0]) == _mirror_state(leases[1]), step
        assert len(leases[1].param.buckets) <= 8


def test_warmup_mirror_threshold_matches_jax_at_integer_boundary():
    """The warm-up mirror keeps the reference's two float32 roundings
    (no fused multiply-add): a cold bucket of count 30 over 5 s reads
    the same effective threshold in both packages, bit for bit."""
    for count, period in ((30.0, 5), (90.0, 10), (7.0, 3)):
        jm, pm = JL._WarmUpMirror(count, period), PL._WarmUpMirror(count, period)
        now = NOW0
        for prev in (0, 3, 11, 40, 0, 0, 200):
            now += 1000
            jm.sync(now, prev)
            pm.sync(now, prev)
            assert np.float32(jm.effective_threshold()).tobytes() == \
                np.float32(pm.effective_threshold()).tobytes()
            assert np.float32(jm.stored).tobytes() == \
                np.float32(pm.stored).tobytes()


def test_native_ring_matches_python_ring_differentially():
    """The port's C ring and its Python ring make IDENTICAL decisions on
    identical traffic: randomized acquire / add / rotation sequences over
    several geometries, compared call by call."""
    assert load_lease_ext() is not None
    rng = random.Random(7)
    for trial in range(20):
        buckets = rng.choice([1, 2, 4, 5])
        interval = buckets * rng.choice([100, 250, 500])
        thresholds = [float(rng.randint(1, 30))
                      for _ in range(rng.randint(1, 3))]
        native = PL.LocalLease(thresholds, interval, buckets)
        oracle = PL.LocalLease(thresholds, interval, buckets, use_native=False)
        assert native.native
        now = NOW0
        for step in range(300):
            now += rng.choice([0, 1, 7, interval // buckets, interval,
                               3 * interval])
            op = rng.random()
            count = rng.randint(1, 3)
            if op < 0.75:
                assert native.try_acquire(count, now) == \
                    oracle.try_acquire(count, now), (trial, step)
            elif op < 0.9:
                native.add(count, now)
                oracle.add(count, now)
            else:
                assert native.usage(now) == oracle.usage(now), (trial, step)
        assert native.snapshot() == oracle.snapshot()


def test_native_ring_seed_and_snapshot_round_trip():
    lease = PL.LocalLease([100.0], 1000, 2)
    assert lease.native
    lease.seed([NOW0, NOW0 - 500], [5, 7])
    assert lease.snapshot() == ([NOW0, NOW0 - 500], [5, 7])
    # Geometry-mismatched seeds drop, like the Python ring.
    lease.seed([0], [1])
    assert lease.snapshot() == ([NOW0, NOW0 - 500], [5, 7])


def test_native_ring_build_is_keyed_by_source(tmp_path, monkeypatch):
    """The extension's file name hashes its source, so an edit rebuilds."""
    import shutil

    from sentinel_tpu_torch import native

    before = native.library_path()
    src = tmp_path / "lease_ext.c"
    shutil.copy(native.SOURCE, src)
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.library_path() == before
    src.write_text(src.read_text() + "\n/* edited */\n")
    assert native.library_path() != before


# -- build_lease_table eligibility (tests/test_lease.py:24-85) -------------

W = JC.CONTROL_BEHAVIOR_WARM_UP
RL = JC.CONTROL_BEHAVIOR_RATE_LIMITER
WRL = JC.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER

SHAPES = {
    "ineligible_shapes": [
        ("flow", dict(resource="wrl", count=5, control_behavior=WRL)),
        ("flow", dict(resource="rlim", count=5, control_behavior=RL)),
        ("flow", dict(resource="thr", count=5, grade=JC.FLOW_GRADE_THREAD)),
        ("flow", dict(resource="orig", count=5, limit_app="appA")),
        ("flow", dict(resource="clus", count=5, cluster_mode=True,
                      cluster_config={"flowId": 1})),
        ("flow", dict(resource="rel", count=5,
                      strategy=JC.FLOW_STRATEGY_RELATE, ref_resource="ref")),
        ("flow", dict(resource="ref", count=5)),
        ("flow", dict(resource="ok", count=5)),
        ("flow", dict(resource="warm", count=5, control_behavior=W)),
    ],
    "degrade_and_authority": [
        ("flow", dict(resource="d", count=5)),
        ("flow", dict(resource="p", count=5)),
        ("flow", dict(resource="a", count=5)),
        ("degrade", dict(resource="d", count=1, time_window=5)),
        ("authority", dict(resource="a", limit_app="x")),
    ],
    "single_param": [
        ("flow", dict(resource="p", count=5)),
        ("param", dict(resource="p", param_idx=0, count=5)),
        ("param", dict(resource="solo", param_idx=1, count=2)),
    ],
    "two_param_rules": [
        ("param", dict(resource="p", param_idx=0, count=5)),
        ("param", dict(resource="p", param_idx=1, count=9)),
    ],
    "param_thread_grade": [
        ("param", dict(resource="p", param_idx=0, count=5,
                       grade=JC.PARAM_FLOW_GRADE_THREAD)),
    ],
    "param_pacing": [
        ("param", dict(resource="p", param_idx=0, count=5,
                       control_behavior=RL)),
    ],
    "param_cluster": [
        ("param", dict(resource="p", param_idx=0, count=5, cluster_mode=True,
                       cluster_config={"flowId": 9})),
    ],
    "system_rule": [
        ("flow", dict(resource="s", count=5)),
        ("system", dict(qps=1e6)),
    ],
    "relate_target_unruled": [
        ("flow", dict(resource="write_db", count=3,
                      strategy=JC.FLOW_STRATEGY_RELATE,
                      ref_resource="read_db")),
    ],
    "mixed_on_one_resource": [
        ("flow", dict(resource="mix", count=100)),
        ("flow", dict(resource="mix", count=50, control_behavior=RL)),
    ],
    "multiple_defaults_and_warm_param": [
        ("flow", dict(resource="two", count=10)),
        ("flow", dict(resource="two", count=4)),
        ("flow", dict(resource="wz", count=10, control_behavior=W,
                      warm_up_period_sec=5)),
        ("param", dict(resource="wz", param_idx=0, count=3)),
    ],
}

_LOADERS = {"flow": ("flow_rules", "FlowRule"),
            "degrade": ("degrade_rules", "DegradeRule"),
            "authority": ("authority_rules", "AuthorityRule"),
            "system": ("system_rules", "SystemRule"),
            "param": ("param_rules", "ParamFlowRule")}


def _load(eng, pkg, rules):
    by_family = {}
    for family, kw in rules:
        by_family.setdefault(family, []).append(
            getattr(pkg, _LOADERS[family][1])(**kw))
    for family, objs in by_family.items():
        getattr(eng, _LOADERS[family][0]).load_rules(objs)


def _lease_view(eng):
    return {
        "leases": {res: (type(lease).__name__, list(lease.thresholds),
                         len(getattr(lease, "warm", ())),
                         getattr(lease, "param", None) is not None)
                   for res, lease in eng._leases.items()},
        "guarded": set(eng._guarded_resources),
        "unruled": eng._unruled_fastpath,
    }


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_build_lease_table_matches_jax(shape):
    jeng = JEngine(capacity=256)
    peng = PEngine(capacity=256, device="cpu")
    try:
        _load(jeng, jst, SHAPES[shape])
        _load(peng, pst, SHAPES[shape])
        assert _lease_view(peng) == _lease_view(jeng)
        # Taking the last family away again restores the same table.
        families = {f for f, _ in SHAPES[shape]}
        for family in sorted(families):
            getattr(jeng, _LOADERS[family][0]).load_rules([])
            getattr(peng, _LOADERS[family][0]).load_rules([])
            assert _lease_view(peng) == _lease_view(jeng), family
    finally:
        jeng.close()
        peng.close()


def test_lease_disabled_by_config(monkeypatch):
    from sentinel_tpu_torch.core.config import config

    monkeypatch.setenv("CSP_SENTINEL_LEASE_ENABLED", "false")
    config.reset_for_tests()
    try:
        eng = PEngine(capacity=64, device="cpu")
        eng.flow_rules.load_rules([pst.FlowRule(resource="fast", count=5)])
        assert not eng._leases and not eng._unruled_fastpath
    finally:
        monkeypatch.delenv("CSP_SENTINEL_LEASE_ENABLED")
        config.reset_for_tests()


def test_committer_counts_failed_flushes(tmp_path):
    """A committer flush that raises is logged and counted, whether the
    background thread or ``close()``'s final drain ran it; its commits are
    lost, as in the reference, and the thread carries on."""
    import time

    from sentinel_tpu_torch.core.config import LOG_DIR, config
    from sentinel_tpu_torch.core.context import (bump_generation,
                                                 replace_context)
    from sentinel_tpu_torch.core.engine import DeviceDispatchError
    from sentinel_tpu_torch.log.record_log import record_log

    replace_context(None)  # no call context of an earlier engine
    bump_generation()
    config.set(LOG_DIR, str(tmp_path))
    record_log.close()
    eng = PEngine(capacity=64, device="cpu")
    try:
        eng.flow_rules.load_rules([pst.FlowRule(resource="fast", count=5)])
        assert "fast" in eng._leases

        def broken(batch):
            raise DeviceDispatchError("entry dispatch failed: injected")

        eng._run_entry_batch = broken
        eng.entry("fast").exit()
        committer = eng.committer
        deadline = time.monotonic() + 10.0
        while committer.failures == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert committer.failures == 1
        assert committer.pending() == (0, 0)
        eng.entry("fast").exit()  # flushed by the thread or by close()
        eng.close()
        assert committer.failures == 2
        assert committer.pending() == (0, 0)
        assert eng.fail_open_count == 0
        log = (tmp_path / "sentinel-record.log").read_text()
        assert "injected" in log
    finally:
        eng.close()
        record_log.close()
        config.reset_for_tests()


# -- reference caveats: where the mirrors and the device step part -------


def test_reference_caveat_param_mirror_rounds_the_refill_twice():
    """The JAX device step refills a param bucket with one fused
    multiply-add at every width; both packages' host mirrors round it
    twice. At count 1/3, burst 8, after 5 idle windows a request of 5
    finds 4.9999995 tokens on the device (blocked) and 5.0 in the mirror
    (admitted). The port keeps both sides as the reference has them."""
    from sentinel_tpu.core.batch import EntryBatch, make_entry_batch_np

    import jax.numpy as jnp

    rule = dict(param_idx=0, count=1 / 3, burst_count=8)
    mirrors = [JL._ParamLeaseMirror(jst.ParamFlowRule("p", **rule)),
               PL._ParamLeaseMirror(pst.ParamFlowRule("p", **rule))]
    key = (hash_param("k"),)
    got = [[m.check_commit(5, t, key) for t in (NOW0, NOW0 + 5000)]
           for m in mirrors]
    assert got == [[True, True], [True, True]]

    now = [NOW0]
    eng = JEngine(capacity=64, clock=lambda: now[0])
    try:
        eng.lease_enabled = False
        eng._rebuild_leases()
        eng.param_rules.load_rules([jst.ParamFlowRule("p", **rule)])
        reg = eng.registry
        ent = reg.entrance_row("c")
        buf = make_entry_batch_np(1)
        buf["cluster_row"][0] = reg.cluster_row("p")
        buf["dn_row"][0] = reg.default_row("c", "p", ent)
        buf["count"][0] = 5
        buf["param_hash"][0, 0] = key[0]
        buf["param_present"][0, 0] = True
        reasons = []
        for dt in (0, 5000):
            now[0] += dt
            dec = eng.check_batch(
                EntryBatch(**{k: jnp.asarray(v) for k, v in buf.items()}))
            reasons.append(int(np.asarray(dec.reason)[0]))
    finally:
        eng.close()
    assert reasons == [0, int(JC.BlockReason.PARAM_FLOW)]


def test_reference_caveat_warm_up_mirror_matches_only_width_one():
    """The warm-up mirror rounds ``warning_qps`` twice, as the JAX step
    does at width 1 only; at widths 8 and above the step contracts it
    (``tests/test_torch_models.py``). A cold bucket of count 30 over 4 s
    reads 9.999999 in both packages' mirrors, where a wide device step
    reads 10.0 and admits one request more."""
    for mod in (JL, PL):
        m = mod._WarmUpMirror(30.0, 4)
        m.sync(NOW0, 0)
        assert m.effective_threshold() == np.float32(9.999999)
