"""Shared parity harness for the PyTorch port's tests (``test_torch_*``),
plus the tests of the state carry-over itself (``sentinel_tpu_torch/
convert.py``).

Both packages get the same numpy inputs: the rule scenario below compiles
with the JAX package, its ``RulePack`` and ``SentinelState`` are flattened
to numpy and loaded into the port through ``convert.py``, and every batch
is one ``make_entry_batch_np`` / ``make_exit_batch_np`` dict fed to both.
JAX runs on the CPU (tests/conftest.py); the port runs with
``device="cpu"``, i.e. its plain CPU forms.

Comparison rules: integer and bool tensors must be equal, float tensors
agree within ``FLOAT_RTOL`` (the warm-up token level and the param decay
are float32 state where XLA may contract a multiply-add into one fused
operation and torch does not: one rounding apart). Dtypes must match,
except that the JAX package's uint32 hashes are int64 in the port.
"""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from sentinel_tpu.core import constants as JC
from sentinel_tpu.core.batch import EntryBatch as JEntryBatch
from sentinel_tpu.core.batch import ExitBatch as JExitBatch
from sentinel_tpu.core.batch import make_entry_batch_np, make_exit_batch_np
from sentinel_tpu.core.registry import NodeRegistry as JRegistry
from sentinel_tpu.models import authority as JA
from sentinel_tpu.models import degrade as JD
from sentinel_tpu.models import flow as JF
from sentinel_tpu.models import param_flow as JP
from sentinel_tpu.models import system as JY
from sentinel_tpu.ops import step as JS
from sentinel_tpu.utils.param_hash import hash_param

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.batch import to_device

FLOAT_RTOL = 1e-6
NOW0 = 1_700_000_000_000
CTX = JC.CONTEXT_DEFAULT_NAME
ORIGINS = ("", "appA", "appB", "appC")


# ---------------------------------------------------------------------------
# pytree <-> numpy
# ---------------------------------------------------------------------------


def jax_to_np(tree):
    """A JAX NamedTuple pytree -> nested dict of numpy arrays (``None``
    fields dropped)."""
    out = {}
    for name, v in tree._asdict().items():
        if v is None:
            continue
        if isinstance(v, tuple) and hasattr(v, "_asdict"):
            out[name] = jax_to_np(v)
        else:
            out[name] = np.asarray(v)
    return out


def _port_dtype(dt: np.dtype) -> np.dtype:
    return np.dtype(np.int64) if dt == np.uint32 else dt


def assert_tree_equal(want, got, path="", rtol=FLOAT_RTOL):
    """``want`` (from JAX) and ``got`` (from the port): same keys, dtypes
    (uint32 -> int64), shapes; ints/bools equal; floats within rtol."""
    assert set(want) == set(got), (path, set(want) ^ set(got))
    for k in want:
        w, g = want[k], got[k]
        p = f"{path}.{k}"
        if isinstance(w, dict):
            assert_tree_equal(w, g, p, rtol)
            continue
        assert _port_dtype(w.dtype) == g.dtype, (p, w.dtype, g.dtype)
        assert w.shape == g.shape, (p, w.shape, g.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=p)
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=p)


def port_np(tree):
    return convert.state_to_numpy(tree)


def assert_decisions_equal(jdec, pdec):
    for f in ("reason", "wait_us", "rule_slot"):
        w = np.asarray(getattr(jdec, f))
        g = getattr(pdec, f).cpu().numpy()
        assert w.dtype == g.dtype, (f, w.dtype, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f)


def jax_entry(buf):
    return JEntryBatch(**{k: jnp.asarray(v) for k, v in buf.items()})


def jax_exit(buf):
    return JExitBatch(**{k: jnp.asarray(v) for k, v in buf.items()})


# ---------------------------------------------------------------------------
# The rule scenario: ~100 resources, all five families
# ---------------------------------------------------------------------------


class Scenario:
    """A registry, rules of every family and row tables, built with the
    JAX package's host code (the port's registry is a copy of it)."""

    def __init__(self, capacity=512, n_res=100, system_qps=400.0):
        self.capacity = capacity
        self.n_res = n_res
        reg = self.reg = JRegistry(capacity)
        ent = reg.entrance_row(CTX)
        reg.entrance_row("chainCtx")
        self.cluster = np.array([reg.cluster_row(f"res{i}")
                                 for i in range(n_res)], np.int32)
        self.dn = np.array([reg.default_row(CTX, f"res{i}", ent)
                            for i in range(n_res)], np.int32)
        self.origin_ids = [reg.origin_id(o) for o in ORIGINS]
        self.origin_rows = {
            (i, o): reg.origin_row(f"res{i}", o)
            for i in range(n_res) for o in ORIGINS if o}
        self.ctx_id = reg.context_id(CTX)
        self.chain_ctx_id = reg.context_id("chainCtx")
        self.flow = self._flow_rules()
        self.degrade = [
            JD.DegradeRule(resource=f"res{i}", count=[40, 0.3, 3][i % 3],
                           grade=i % 3, time_window=1, min_request_amount=3,
                           stat_interval_ms=1000)
            for i in range(20, 32)]
        self.param = [
            JP.ParamFlowRule("res32", param_idx=0, count=3),
            ] + [
            JP.ParamFlowRule(f"res{i}", param_idx=i % 2, count=2 + i % 3,
                             grade=[1, 0, 1][i % 3],
                             control_behavior=[0, 0, 2][i % 3],
                             max_queueing_time_ms=[0, 0, 400][i % 3],
                             items=[JP.ParamFlowItem(7, 6.0)])
            for i in range(33, 42)]
        self.authority = [
            JA.AuthorityRule(resource=f"res{i}", limit_app="appA,appB",
                             strategy=i % 2)
            for i in range(42, 48)]
        self.system = [JY.SystemRule(qps=system_qps)]

    def _flow_rules(self):
        r = []
        for i in range(0, 20):
            kind = i % 10
            res = f"res{i}"
            if kind == 0:
                r.append(JF.FlowRule(res, count=6))
            elif kind == 1:
                r.append(JF.FlowRule(res, count=3, grade=JC.FLOW_GRADE_THREAD))
            elif kind == 2:
                r.append(JF.FlowRule(
                    res, count=20,
                    control_behavior=JC.CONTROL_BEHAVIOR_RATE_LIMITER,
                    max_queueing_time_ms=300))
            elif kind == 3:
                r.append(JF.FlowRule(
                    res, count=30, control_behavior=JC.CONTROL_BEHAVIOR_WARM_UP,
                    warm_up_period_sec=5))
            elif kind == 4:
                r.append(JF.FlowRule(
                    res, count=25,
                    control_behavior=JC.CONTROL_BEHAVIOR_WARM_UP_RATE_LIMITER,
                    warm_up_period_sec=4, max_queueing_time_ms=200))
            elif kind == 5:
                r.append(JF.FlowRule(res, count=2, limit_app="appA"))
                r.append(JF.FlowRule(res, count=4, limit_app="other"))
            elif kind == 6:
                r.append(JF.FlowRule(res, count=5,
                                     strategy=JC.FLOW_STRATEGY_RELATE,
                                     ref_resource="res50"))
            elif kind == 7:
                r.append(JF.FlowRule(res, count=3,
                                     strategy=JC.FLOW_STRATEGY_CHAIN,
                                     ref_resource=CTX))
            elif kind == 8:
                r.append(JF.FlowRule(res, count=8))
                r.append(JF.FlowRule(res, count=3, grade=JC.FLOW_GRADE_THREAD))
            else:
                r.append(JF.FlowRule(res, count=4))
        return r

    def jax_rules(self):
        ft, _ = JF.compile_flow_rules(self.flow, self.reg, self.capacity)
        dt, di = JD.compile_degrade_rules(self.degrade, self.reg,
                                          self.capacity)
        pt = JP.compile_param_rules(self.param, self.reg, self.capacity)
        at = JA.compile_authority_rules(self.authority, self.reg,
                                        self.capacity)
        rules = JS.RulePack(flow=ft, degrade=dt, authority=at,
                            system=JY.compile_system_rules(self.system),
                            param=pt)
        state = JS.make_state(self.capacity, ft.num_rules, NOW0,
                              degrade=JD.make_degrade_state(dt, di),
                              param=JP.make_param_state(pt.num_rules))
        return rules, state

    def named_origins(self):
        return JF.named_origin_map(self.flow, self.reg)

    def entry_batch(self, rng, n, fill=None, mixed=False, prioritized=0.1):
        """Random entries over the scenario's resources; ``fill`` live
        lanes (the rest padding)."""
        buf = make_entry_batch_np(n)
        live = n if fill is None else fill
        pick = rng.integers(0, self.n_res, size=live)
        origin = rng.integers(0, len(ORIGINS), size=live)
        named = self.named_origins()
        buf["cluster_row"][:live] = self.cluster[pick]
        buf["dn_row"][:live] = self.dn[pick]
        for j in range(live):
            o = ORIGINS[origin[j]]
            buf["origin_row"][j] = self.origin_rows.get((pick[j], o), -1)
            oid = self.origin_ids[origin[j]]
            buf["origin_id"][j] = oid
            buf["origin_named"][j] = oid in named.get(f"res{pick[j]}", ())
        ctx = np.where(rng.random(live) < 0.2, self.chain_ctx_id, self.ctx_id)
        buf["context_id"][:live] = ctx
        buf["count"][:live] = (rng.integers(1, 4, size=live) if mixed
                               else 1)
        buf["prioritized"][:live] = rng.random(live) < prioritized
        buf["entry_in"][:live] = rng.random(live) < 0.7
        buf["param_hash"][:live, 0] = rng.choice(
            np.array([hash_param(v) for v in (1, 2, 3, 7, "x")], np.uint32),
            size=live)
        buf["param_hash"][:live, 1] = rng.integers(1, 1 << 32, size=live,
                                                   dtype=np.uint64)
        buf["param_present"][:live, :2] = rng.random((live, 2)) < 0.9
        return buf

    def exit_batch(self, rng, ebuf, reason, n):
        """Completions for the admitted lanes of an entry batch."""
        buf = make_exit_batch_np(n)
        ok = (ebuf["cluster_row"] >= 0) & ((reason == 0) | (reason == 6))
        for f in ("cluster_row", "dn_row", "origin_row", "entry_in", "count",
                  "param_hash", "param_present"):
            buf[f][:] = ebuf[f]
        buf["cluster_row"][~ok] = -1
        buf["rt_ms"][:] = rng.integers(1, 120, size=n)
        buf["error"][:] = rng.random(n) < 0.3
        buf["success"][:] = ok
        return buf


# ---------------------------------------------------------------------------
# Tests of the carry-over itself
# ---------------------------------------------------------------------------


def test_convert_round_trip_keeps_values_and_dtypes():
    sc = Scenario()
    jrules, jstate = sc.jax_rules()
    prules = convert.rules_from_numpy(jax_to_np(jrules), "cpu")
    pstate = convert.state_from_numpy(jax_to_np(jstate), "cpu")
    assert_tree_equal(jax_to_np(jrules), port_np(prules))
    assert_tree_equal(jax_to_np(jstate), port_np(pstate))
    again = convert.state_from_numpy(convert.state_to_numpy(pstate), "cpu")
    assert_tree_equal(jax_to_np(jstate), port_np(again))


def test_convert_round_trip_keeps_pod_trees():
    """The reference's ``[D, ...]`` and ``[S, P, ...]`` pod trees (a
    candidate's shadow and the flight ring included) load into the port
    and come back with every leaf, shape and dtype."""
    from sentinel_tpu.parallel import cluster as JPC
    from sentinel_tpu.parallel import namespaces as JNS

    rows, pack, one = pod_world()
    one = one._replace(shadow=JS.make_shadow_state(POD_CAPACITY, pack,
                                                   one.degrade))
    for pod in (JPC.make_pod_state(3, one), JNS.make_dcn_pod_state(2, 3, one)):
        want = jax_to_np(pod)
        got = convert.state_from_numpy(want, "cpu")
        assert got.shadow is not None and got.flight is not None
        assert_tree_equal(want, port_np(got), rtol=0.0)
        again = convert.state_from_numpy(convert.state_to_numpy(got), "cpu")
        assert_tree_equal(want, port_np(again), rtol=0.0)


def test_to_device_matches_staging_dicts():
    sc = Scenario()
    rng = np.random.default_rng(5)
    ebuf = sc.entry_batch(rng, 16)
    eb = to_device(ebuf, "cpu")
    assert eb.param_hash.dtype == torch.int64
    np.testing.assert_array_equal(eb.param_hash.numpy(),
                                  ebuf["param_hash"].astype(np.int64))
    for f, a in ebuf.items():
        if f != "param_hash":
            assert getattr(eb, f).numpy().dtype == a.dtype, f
    xb = to_device(make_exit_batch_np(4), "cpu")
    assert type(xb).__name__ == "ExitBatch" and xb.size == 4


# ---------------------------------------------------------------------------
# The pod: the live JAX reference (a vmap with named axes) and its twin
# ---------------------------------------------------------------------------

POD_CAPACITY = 128


def pod_world(thr=10.0, local_thr=3.0, param_thr=6.0, param_local_thr=2.0,
              brk_count=3, scope=None, flight_seconds=8):
    """One rule pack whose shapes every pod scenario shares (so the
    reference compiles once per step kind): a cluster-mode flow rule on
    ``shared`` (``scope`` its cluster_config scope), a local one on
    ``local``, a cluster-mode and a local param rule on ``pshared`` /
    ``plocal``, an exception-count breaker on ``brk``; ``free`` has no
    rule. Returns (rows by name, JAX pack, one JAX shard state)."""
    reg = JRegistry(POD_CAPACITY)
    names = ("shared", "local", "pshared", "plocal", "brk", "free")
    rows = {n: reg.cluster_row(n) for n in names}
    cfg = None if scope is None else {"scope": scope}
    flow = [JF.FlowRule(resource="shared", count=thr, cluster_mode=True,
                        cluster_config=cfg),
            JF.FlowRule(resource="local", count=local_thr)]
    param = [JP.ParamFlowRule("pshared", param_idx=0, count=param_thr,
                              cluster_mode=True),
             JP.ParamFlowRule("plocal", param_idx=0, count=param_local_thr)]
    degrade = [JD.DegradeRule(
        resource="brk", grade=JC.DEGRADE_GRADE_EXCEPTION_COUNT,
        count=brk_count, time_window=5, min_request_amount=1)]
    ft, _ = JF.compile_flow_rules(flow, reg, POD_CAPACITY)
    dt, di = JD.compile_degrade_rules(degrade, reg, POD_CAPACITY)
    pt = JP.compile_param_rules(param, reg, POD_CAPACITY)
    pack = JS.RulePack(
        flow=ft, degrade=dt,
        authority=JA.compile_authority_rules([], reg, POD_CAPACITY),
        system=JY.compile_system_rules([]), param=pt)
    one = JS.make_state(POD_CAPACITY, ft.num_rules, NOW0,
                        degrade=JD.make_degrade_state(dt, di),
                        param=JP.make_param_state(pt.num_rules),
                        flight_seconds=flight_seconds)
    return rows, pack, one


def pod_entry_buf(n_shards, per_shard, lanes, count=1, param=None,
                  prioritized=False):
    """A ``[n_shards * per_shard]`` entry buffer; ``lanes`` maps lane
    index -> cluster row (the rest padding). ``param`` puts one hashed
    value at param index 0 of every live lane."""
    buf = make_entry_batch_np(n_shards * per_shard)
    for i, row in lanes.items():
        buf["cluster_row"][i] = row
    live = buf["cluster_row"] >= 0
    buf["count"][live] = count
    buf["prioritized"][live] = prioritized
    if param is not None:
        buf["param_hash"][live, 0] = param
        buf["param_present"][live, 0] = True
    return buf


def every_lane(n_shards, per_shard, row, per_live=None):
    """lane -> row for the first ``per_live`` lanes of every shard."""
    per_live = per_shard if per_live is None else per_live
    return {d * per_shard + j: row
            for d in range(n_shards) for j in range(per_live)}


def pod_exit_buf(ebuf, reason, error=None):
    """Completions of the admitted lanes of an entry buffer."""
    buf = make_exit_batch_np(ebuf["cluster_row"].shape[0])
    ok = (ebuf["cluster_row"] >= 0) & (reason == 0)
    for f in ("cluster_row", "dn_row", "origin_row", "entry_in", "count",
              "param_hash", "param_present"):
        buf[f][:] = ebuf[f]
    buf["cluster_row"][~ok] = -1
    err = np.zeros(ok.shape, bool) if error is None else error
    buf["success"][:] = ok & ~err
    buf["error"][:] = ok & err
    buf["rt_ms"][:] = 5
    return buf


_JAX_POD = {}


def jax_pod_steps(kind="pod", cluster_param=True, global_scope=True,
                  shadow_rules=None):
    """The reference's per-shard pod bodies under ``jax.vmap`` with named
    axes (its ``shard_map`` is refused by jax 0.9.0): ``kind="pod"``
    vmaps ``parallel/cluster.py:_pod_entry`` / ``_pod_exit`` over
    ``"pod"`` (state ``[D, 1, ...]``, batch ``[D, B]``); ``kind="dcn"``
    nests ``namespaces._dcn_entry`` / ``_dcn_exit`` over ``"dcn"`` then
    ``"ici"`` (state ``[S, P, 1, 1, ...]``, batch ``[S, P, B]``). Jitted
    once per configuration for the process."""
    import functools

    import jax

    from sentinel_tpu.parallel import cluster as JPC
    from sentinel_tpu.parallel import namespaces as JNS

    key = (kind, cluster_param, global_scope, id(shadow_rules))
    if key in _JAX_POD:
        return _JAX_POD[key][0]
    axes = (0, None, 0, None)
    if kind == "pod":
        ent = jax.vmap(functools.partial(
            JPC._pod_entry, axis=JPC.AXIS, cluster_param=cluster_param,
            shadow_rules=shadow_rules), in_axes=axes, axis_name=JPC.AXIS)
        ext = jax.vmap(functools.partial(
            JPC._pod_exit, axis=JPC.AXIS, shadow_rules=shadow_rules),
            in_axes=axes, axis_name=JPC.AXIS)
    else:
        ent = functools.partial(JNS._dcn_entry, cluster_param=cluster_param,
                                global_scope=global_scope,
                                extra_checkers=())
        ent = jax.vmap(jax.vmap(ent, in_axes=axes, axis_name=JNS.ICI_AXIS),
                       in_axes=axes, axis_name=JNS.DCN_AXIS)
        ext = jax.vmap(jax.vmap(JNS._dcn_exit, in_axes=axes,
                                axis_name=JNS.ICI_AXIS),
                       in_axes=axes, axis_name=JNS.DCN_AXIS)
    steps = (jax.jit(ent), jax.jit(ext))
    _JAX_POD[key] = (steps, shadow_rules)  # keeps the id's owner alive
    return steps


def squeeze_np(d, lead: int):
    """A nested numpy dict of a vmapped reference state: drop the
    singleton axes that follow the ``lead`` shard axes."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = squeeze_np(v, lead)
        else:
            out[k] = v.reshape(v.shape[:lead] + v.shape[2 * lead:])
    return out


class PodTwin:
    """The reference pod and the port's one-process pod, stepped together
    on the same numpy batches; every step compares the decisions and every
    state leaf (float leaves too) bit for bit."""

    def __init__(self, pack, one, shape, cluster_param=True,
                 global_scope=True, shadow_rules=None, pshadow_rules=None):
        import jax
        import jax.numpy as jnp

        from sentinel_tpu_torch.parallel import cluster as PPC
        from sentinel_tpu_torch.parallel import namespaces as PNS

        self.shape = tuple(shape)          # (D,) or (S, P)
        self.lead = len(self.shape)
        kind = "pod" if self.lead == 1 else "dcn"
        self.jentry, self.jexit = jax_pod_steps(
            kind, cluster_param, global_scope, shadow_rules)
        ones = (1,) * self.lead
        self.jpack = pack
        self.jstate = jax.tree.map(
            lambda x: jnp.broadcast_to(x, self.shape + ones + x.shape), one)
        self.prules = convert.rules_from_numpy(jax_to_np(pack), "cpu")
        self.pstate = convert.state_from_numpy(self.jax_np(), "cpu")
        if kind == "pod":
            self.pentry, self.pexit = PPC.make_pod_steps(
                "cpu", cluster_param=cluster_param,
                shadow_rules=pshadow_rules)
        else:
            self.pentry, self.pexit = PNS.make_dcn_pod_steps(
                "cpu", cluster_param=cluster_param,
                global_scope=global_scope)

    def jax_np(self):
        return squeeze_np(jax_to_np(self.jstate), self.lead)

    def _jbatch(self, buf, cls):
        import jax.numpy as jnp

        return cls(**{k: jnp.asarray(v.reshape(self.shape + (-1,)
                                               + v.shape[1:]))
                      for k, v in buf.items()})

    def check_state(self):
        assert_tree_equal(self.jax_np(), port_np(self.pstate), rtol=0.0)

    def entry(self, buf, now):
        import jax.numpy as jnp

        self.jstate, jdec = self.jentry(self.jstate, self.jpack,
                                        self._jbatch(buf, JEntryBatch),
                                        jnp.int64(now))
        self.pstate, pdec = self.pentry(self.pstate, self.prules,
                                        to_device(buf, "cpu"), now)
        for f in ("reason", "wait_us", "rule_slot"):
            w = np.asarray(getattr(jdec, f)).reshape(-1)
            g = getattr(pdec, f).numpy()
            assert w.dtype == g.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        self.check_state()
        return np.asarray(jdec.reason).reshape(-1), \
            np.asarray(jdec.wait_us).reshape(-1)

    def exit(self, buf, now):
        import jax.numpy as jnp

        self.jstate = self.jexit(self.jstate, self.jpack,
                                 self._jbatch(buf, JExitBatch),
                                 jnp.int64(now))
        self.pstate = self.pexit(self.pstate, self.prules,
                                 to_device(buf, "cpu"), now)
        self.check_state()
