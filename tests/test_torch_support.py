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
