"""Each rule family's device check and feed in the port
(``sentinel_tpu_torch/models``) against its JAX function, on random
batches and random device state, on the CPU.

Rules compile with the JAX package (``tests/test_torch_support.py``
Scenario) and load into the port through ``convert.py``; the port's own
compilers are held against the JAX ones on the same rule lists. Verdicts
must be bit-identical; returned state equal (floats within the harness's
FLOAT_RTOL). The JAX side runs jitted, as the engine runs it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sentinel_tpu.models import authority as JA
from sentinel_tpu.models import degrade as JD
from sentinel_tpu.models import flow as JF
from sentinel_tpu.models import param_flow as JP
from sentinel_tpu.models import system as JY
from sentinel_tpu.ops import step as JS
from sentinel_tpu.ops import window as JW

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.batch import to_device
from sentinel_tpu_torch.core.registry import NodeRegistry as PRegistry
from sentinel_tpu_torch.models import authority as PA
from sentinel_tpu_torch.models import degrade as PD
from sentinel_tpu_torch.models import flow as PF
from sentinel_tpu_torch.models import param_flow as PP
from sentinel_tpu_torch.models import system as PY
from sentinel_tpu_torch.ops import window as PW

from tests.test_torch_support import (
    NOW0, Scenario, assert_tree_equal, jax_entry, jax_exit, jax_to_np,
    port_np)

WIDTH = 64


@pytest.fixture(scope="module")
def scenario():
    sc = Scenario()
    jrules, jstate = sc.jax_rules()
    prules = convert.rules_from_numpy(jax_to_np(jrules), "cpu")
    return sc, jrules, jstate, prules


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_window(rng, rows, spec, now, hi=6):
    counts = rng.integers(0, hi, size=(spec.buckets, 6, rows)).astype(np.int32)
    min_rt = rng.integers(1, 300, size=(spec.buckets, rows)).astype(np.int32)
    min_rt[rng.random(min_rt.shape) < 0.3] = PW.MIN_RT_EMPTY
    starts = PW.expected_starts(now, PW.WindowSpec(*spec), "cpu").numpy()
    j = JW.Window(jnp.asarray(counts), jnp.asarray(min_rt),
                  jnp.asarray(starts))
    p = PW.Window(_t(counts), _t(min_rt), _t(starts))
    return j, p


def test_port_compilers_match_jax(scenario):
    sc = scenario[0]
    reg = PRegistry(sc.capacity)
    # Same allocation order as the scenario's JAX registry.
    reg.entrance_row("sentinel_default_context")
    reg.entrance_row("chainCtx")
    for i in range(sc.n_res):
        reg.cluster_row(f"res{i}")
    ent = reg.entrance_row("sentinel_default_context")
    for i in range(sc.n_res):
        reg.default_row("sentinel_default_context", f"res{i}", ent)
    for o in ("", "appA", "appB", "appC"):
        reg.origin_id(o)
    for i in range(sc.n_res):
        for o in ("appA", "appB", "appC"):
            reg.origin_row(f"res{i}", o)
    reg.context_id("sentinel_default_context")
    reg.context_id("chainCtx")
    assert reg.to_dict() == sc.reg.to_dict()

    def rules(mod, objs):
        return [mod(**vars(r)) for r in objs]

    pf, pnamed = PF.compile_flow_rules(rules(PF.FlowRule, sc.flow), reg,
                                       sc.capacity, device="cpu")
    jf, jnamed = JF.compile_flow_rules(sc.flow, sc.reg, sc.capacity)
    assert pnamed == jnamed
    assert_tree_equal(jax_to_np(jf), port_np(pf))
    pd, pdi = PD.compile_degrade_rules(rules(PD.DegradeRule, sc.degrade),
                                       reg, sc.capacity, device="cpu")
    jd, jdi = JD.compile_degrade_rules(sc.degrade, sc.reg, sc.capacity)
    assert_tree_equal(jax_to_np(jd), port_np(pd))
    np.testing.assert_array_equal(pdi, jdi)
    assert_tree_equal(jax_to_np(JD.make_degrade_state(jd, jdi)),
                      port_np(PD.make_degrade_state(pd, pdi)))
    items = lambda r: [PP.ParamFlowItem(i.object, i.count) for i in r.items]
    pp_rules = [PP.ParamFlowRule(**{**vars(r), "items": items(r)})
                for r in sc.param]
    pp = PP.compile_param_rules(pp_rules, reg, sc.capacity, device="cpu")
    jp = JP.compile_param_rules(sc.param, sc.reg, sc.capacity)
    assert_tree_equal(jax_to_np(jp), port_np(pp))
    assert_tree_equal(jax_to_np(JP.make_param_state(jp.num_rules)),
                      port_np(PP.make_param_state(pp.num_rules,
                                                  device="cpu")))
    pa = PA.compile_authority_rules(rules(PA.AuthorityRule, sc.authority),
                                    reg, sc.capacity, device="cpu")
    ja = JA.compile_authority_rules(sc.authority, sc.reg, sc.capacity)
    assert_tree_equal(jax_to_np(ja), port_np(pa))
    for sys_rules in ([], sc.system,
                      [JY.SystemRule(max_thread=9, avg_rt=30),
                       JY.SystemRule(qps=5, highest_cpu_usage=0.5)]):
        ps = PY.compile_system_rules(rules(PY.SystemRule, sys_rules),
                                     device="cpu")
        js = JY.compile_system_rules(sys_rules)
        assert_tree_equal(jax_to_np(js), port_np(ps))
    assert_tree_equal(jax_to_np(JF.make_flow_state(jf.num_rules, NOW0)),
                      port_np(PF.make_flow_state(pf.num_rules, NOW0,
                                                 device="cpu")))


def test_authority_matches_jax(scenario):
    sc, jrules, _, prules = scenario
    rng = np.random.default_rng(1)
    fn = jax.jit(JA.check_authority)
    for _ in range(3):
        buf = sc.entry_batch(rng, WIDTH, fill=WIDTH - 5)
        cand = rng.random(WIDTH) < 0.8
        jv = fn(jrules.authority, jax_entry(buf), jnp.asarray(cand))
        pv = PA.check_authority(prules.authority, to_device(buf, "cpu"),
                                _t(cand))
        assert_tree_equal(_np(jv), port_np(pv))


@pytest.mark.parametrize("mixed", [False, True])
def test_system_matches_jax(scenario, mixed):
    sc = scenario[0]
    rng = np.random.default_rng(2 + mixed)
    rules = [JY.SystemRule(qps=60, max_thread=40, avg_rt=80,
                           highest_system_load=0.5, highest_cpu_usage=0.7)]
    jrt = JY.compile_system_rules(rules)
    prt = convert.tree_from_numpy(PY.SystemRuleTensors, jax_to_np(jrt),
                         torch.device("cpu"))
    fn = jax.jit(JY.check_system, static_argnames=("spec1",))
    now = NOW0 + 250
    for k in range(4):
        now += int(rng.integers(100, 900))
        jw1, pw1 = _random_window(rng, sc.capacity, JS.SPEC_1S, now, hi=3)
        jw60, pw60 = _random_window(rng, sc.capacity, JS.SPEC_60S, now, hi=40)
        sec = rng.integers(0, 30, size=(6, sc.capacity)).astype(np.int32)
        threads = rng.integers(0, 4, size=sc.capacity).astype(np.int32)
        signals = np.array([[-1, -1], [0.9, 0.2], [0.1, 0.9], [0.2, 0.1]][k],
                           np.float32)
        buf = sc.entry_batch(rng, WIDTH, mixed=mixed)
        cand = rng.random(WIDTH) < 0.9
        jb = fn(jrt, jnp.asarray(signals), jw1, jw60, jnp.asarray(sec),
                jnp.asarray(threads), jax_entry(buf), jnp.asarray(cand),
                jnp.int64(now))
        pb = PY.check_system(prt, _t(signals), pw1, pw60, _t(sec),
                             _t(threads), to_device(buf, "cpu"), _t(cand),
                             now)
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


def test_degrade_check_and_feed_match_jax(scenario):
    sc, jrules, jstate, prules = scenario
    rng = np.random.default_rng(4)
    jcheck = jax.jit(JD.check_degrade)
    jfeed = jax.jit(JD.feed_degrade)
    jds = jstate.degrade
    pds = convert.tree_from_numpy(PD.DegradeState, jax_to_np(jds), torch.device("cpu"))
    dr = jrules.degrade.num_rules
    now = NOW0
    for step in range(8):
        now += int(rng.integers(50, 900))
        if step % 3 == 0:
            # Scramble the breakers: some OPEN with due / future retries,
            # some HALF_OPEN.
            st = rng.integers(0, 3, size=dr).astype(np.int32)
            nr = (now + rng.integers(-500, 500, size=dr)).astype(np.int64)
            jds = jds._replace(state=jnp.asarray(st),
                               next_retry_ms=jnp.asarray(nr))
            pds = pds._replace(state=_t(st), next_retry_ms=_t(nr))
        buf = sc.entry_batch(rng, WIDTH, fill=WIDTH - 2)
        cand = rng.random(WIDTH) < 0.85
        jv = jcheck(jrules.degrade, jds, jax_entry(buf), jnp.int64(now),
                    jnp.asarray(cand))
        pv = PD.check_degrade(prules.degrade, pds, to_device(buf, "cpu"),
                              now, _t(cand))
        assert_tree_equal(jax_to_np(jv), port_np(pv))
        jds, pds = jv.state, pv.state
        xbuf = sc.exit_batch(rng, buf, np.where(cand, 0, 1), WIDTH)
        xbuf["rt_ms"][:] = rng.integers(1, 90, size=WIDTH)
        now += int(rng.integers(1, 60))
        jds = jfeed(jrules.degrade, jds, jax_exit(xbuf), jnp.int64(now))
        pds = PD.feed_degrade(prules.degrade, pds, to_device(xbuf, "cpu"), now)
        assert_tree_equal(jax_to_np(jds), port_np(pds))


def test_param_flow_check_and_feed_match_jax(scenario):
    sc, jrules, jstate, prules = scenario
    rng = np.random.default_rng(5)
    jcheck = jax.jit(JP.check_param_flow)
    jfeed = jax.jit(JP.feed_param_exit)
    jps = jstate.param
    pps = convert.tree_from_numpy(PP.ParamFlowState, jax_to_np(jps),
                         torch.device("cpu"))
    now = NOW0
    for step in range(8):
        now += int(rng.integers(100, 1300))
        buf = sc.entry_batch(rng, WIDTH, mixed=(step % 3 == 1))
        # Concentrate traffic on the param-ruled resources (res32..res41).
        pick = rng.integers(32, 42, size=WIDTH)
        buf["cluster_row"][:] = sc.cluster[pick]
        buf["dn_row"][:] = sc.dn[pick]
        cand = rng.random(WIDTH) < 0.9
        jv = jcheck(jrules.param, jps, jax_entry(buf), jnp.int64(now),
                    jnp.asarray(cand))
        pv = PP.check_param_flow(prules.param, pps, to_device(buf, "cpu"),
                                 now, _t(cand))
        assert_tree_equal(jax_to_np(jv), port_np(pv))
        jps, pps = jv.state, pv.state
        admitted = np.where(cand & ~np.asarray(jv.blocked), 0, 1)
        xbuf = sc.exit_batch(rng, buf, admitted, WIDTH)
        jps = jfeed(jrules.param, jps, jax_exit(xbuf))
        pps = PP.feed_param_exit(prules.param, pps, to_device(xbuf, "cpu"))
        assert_tree_equal(jax_to_np(jps), port_np(pps))


@pytest.mark.parametrize("mixed", [False, True])
def test_flow_check_matches_jax(scenario, mixed):
    sc, jrules, jstate, prules = scenario
    rng = np.random.default_rng(6 + mixed)
    fn = jax.jit(lambda rt, fs, w1, ct, b, now, ab, occ: JF.check_flow(
        rt, fs, w1, ct, b, now, ab, occupied_next=occ))
    fr = jrules.flow.num_rules
    now = NOW0 + 123
    for step in range(5):
        now += int(rng.integers(200, 1500))
        jw1, pw1 = _random_window(rng, sc.capacity, JS.SPEC_1S, now, hi=3)
        threads = rng.integers(0, 3, size=sc.capacity).astype(np.int32)
        occ = rng.integers(0, 2, size=sc.capacity).astype(np.int32)
        tokens = rng.uniform(0, 200, size=fr).astype(np.float32)
        filled = (now - rng.integers(0, 3000, size=fr)).astype(np.int64)
        latest = (now * 1000 + rng.integers(-400_000, 300_000,
                                            size=fr)).astype(np.int64)
        jfs = JF.FlowState(jnp.asarray(tokens), jnp.asarray(filled),
                           jnp.asarray(latest))
        pfs = PF.FlowState(_t(tokens), _t(filled), _t(latest))
        buf = sc.entry_batch(rng, WIDTH, mixed=mixed, prioritized=0.4)
        pick = rng.integers(0, 20, size=WIDTH)  # the flow-ruled resources
        buf["cluster_row"][:] = sc.cluster[pick]
        buf["dn_row"][:] = sc.dn[pick]
        blocked = rng.random(WIDTH) < 0.1
        jv = fn(jrules.flow, jfs, jw1, jnp.asarray(threads), jax_entry(buf),
                jnp.int64(now), jnp.asarray(blocked), jnp.asarray(occ))
        pv = PF.check_flow(prules.flow, pfs, pw1, _t(threads),
                           to_device(buf, "cpu"), now, _t(blocked),
                           occupied_next=_t(occ))
        assert_tree_equal(jax_to_np(jv), port_np(pv))


def test_warmup_threshold_rounds_like_xla():
    """A cold warm-up bucket (count 30, warm-up 5 s) has ``warning_qps``
    10.0 exactly in real arithmetic; rounding the multiply-add twice gives
    9.999999 and admits one request fewer than the reference, which
    computes it as one fused multiply-add."""
    from sentinel_tpu.core.registry import NodeRegistry as JRegistry

    reg = JRegistry(16)
    row = reg.cluster_row("w")
    rules = [JF.FlowRule("w", count=30, control_behavior=3,
                         warm_up_period_sec=5)]
    jrt, _ = JF.compile_flow_rules(rules, reg, 16)
    prt = convert.tree_from_numpy(PF.FlowRuleTensors, jax_to_np(jrt), "cpu")
    slope = np.float32(np.asarray(jrt.slope)[0])
    twice = np.float32(1) / (np.float32(np.float32(75) * slope)
                             + np.float32(1) / np.float32(30))
    once = np.float32(1) / np.float32(np.float64(75) * np.float64(slope)
                                      + np.float64(np.float32(1 / 30)))
    assert (twice, once) == (np.float32(9.999999), np.float32(10.0))

    now = NOW0 + 200  # inside one second: no token sync is due
    fr = jrt.num_rules
    tokens = np.zeros(fr, np.float32)
    tokens[0] = 150.0  # max_token: fully cold
    filled = np.full(fr, NOW0, np.int64)
    jfs = JF.FlowState(jnp.asarray(tokens), jnp.asarray(filled),
                       jnp.zeros(fr, jnp.int64))
    pfs = PF.FlowState(_t(tokens), _t(filled), torch.zeros(fr,
                                                           dtype=torch.int64))
    counts = np.zeros((2, 6, 16), np.int32)
    counts[PW.current_index(now, PW.WindowSpec(1000, 2)), 0, row] = 4
    starts = PW.expected_starts(now, PW.WindowSpec(1000, 2), "cpu").numpy()
    min_rt = np.full((2, 16), PW.MIN_RT_EMPTY, np.int32)
    jw1 = JW.Window(jnp.asarray(counts), jnp.asarray(min_rt),
                    jnp.asarray(starts))
    pw1 = PW.Window(_t(counts), _t(min_rt), _t(starts))
    from sentinel_tpu.core.batch import make_entry_batch_np
    buf = make_entry_batch_np(8)
    buf["cluster_row"][:7] = row
    buf["count"][:7] = 1
    threads = np.zeros(16, np.int32)
    blocked = np.zeros(8, bool)
    jv = jax.jit(JF.check_flow)(jrt, jfs, jw1, jnp.asarray(threads),
                                jax_entry(buf), jnp.int64(now),
                                jnp.asarray(blocked))
    pv = PF.check_flow(prt, pfs, pw1, _t(threads), to_device(buf, "cpu"),
                       now, _t(blocked))
    assert_tree_equal(jax_to_np(jv), port_np(pv))
    # 4 passed + 6 admitted = 10 <= 10.0: the seventh is the one blocked.
    assert pv.blocked.tolist() == [False] * 6 + [True, False]


@pytest.mark.parametrize("width", [1, 8, 64, 512, 2048])
def test_warmup_threshold_rounding_follows_the_reference_width(width):
    """The reference's fused step contracts the warm-up ``warning_qps``
    multiply-add at width 8 and above but rounds it twice at width 1: a
    cold bucket of count 30 over 4 s admits its tenth request at 33 ms
    spacing at width 8 (threshold 10.0) and blocks it at width 1
    (9.999999). The port's step gives the same verdicts at every ladder
    width the engine dispatches (1, 8, 64, 512, 2048)."""
    from sentinel_tpu.core.batch import make_entry_batch_np
    from sentinel_tpu.core.registry import NodeRegistry as JRegistry

    from sentinel_tpu_torch.ops import step as PS

    reg = JRegistry(64)
    ent = reg.entrance_row("c")
    cr, dn = reg.cluster_row("w"), reg.default_row("c", "w", ent)
    rules = [JF.FlowRule("w", count=30, control_behavior=1,
                         warm_up_period_sec=4)]
    ft, _ = JF.compile_flow_rules(rules, reg, 64)
    dt, di = JD.compile_degrade_rules([], reg, 64, min_slots=0)
    jrules = JS.RulePack(
        flow=ft, degrade=dt,
        authority=JA.compile_authority_rules([], reg, 64, min_slots=0),
        system=JY.compile_system_rules([]),
        param=JP.compile_param_rules([], reg, 64, min_slots=0))
    jstate = JS.make_state(64, ft.num_rules, NOW0,
                           degrade=JD.make_degrade_state(dt, di),
                           param=JP.make_param_state(8))
    prules = convert.rules_from_numpy(jax_to_np(jrules), "cpu")
    pstate = convert.state_from_numpy(jax_to_np(jstate), "cpu")
    step = jax.jit(JS.entry_step)
    jgot, pgot = [], []
    now = NOW0
    for i in range(11):
        now += 33 if i else 0
        buf = make_entry_batch_np(width)
        buf["cluster_row"][0], buf["dn_row"][0], buf["count"][0] = cr, dn, 1
        jstate, jdec = step(jstate, jrules, jax_entry(buf), jnp.int64(now))
        pstate, pdec = PS.entry_step(pstate, prules, to_device(buf, "cpu"),
                                     now)
        jgot.append(int(np.asarray(jdec.reason)[0]))
        pgot.append(int(pdec.reason[0]))
    assert pgot == jgot
    assert jgot[9] == (1 if width == 1 else 0)
