"""The slice as a whole: the port's fused ``entry_step`` / ``exit_step``
(``sentinel_tpu_torch/ops/step.py``) against ``sentinel_tpu.ops.step`` on
the CPU.

Setup: capacity 512, 100 resources with rules of all five families
(``tests/test_torch_support.py`` Scenario). The JAX ``RulePack`` and
initial ``SentinelState`` load into the port through ``convert.py``; then
both packages run the same multi-step entry + exit sequence at widths 8,
64 and 512 — an advancing clock that crosses 500 ms bucket and 1 s
boundaries, mixed acquire counts every fourth step (the fixpoint loop),
prioritized entries (occupy-next-window), padding lanes, and a width-0
batch. After every step: identical ``Decisions``, equal integer state,
equal dtypes, float state within ``FLOAT_RTOL``.

Each JAX width compiles once per module (jitted like the engine's step).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sentinel_tpu.core.batch import make_entry_batch_np, make_exit_batch_np
from sentinel_tpu.ops import step as JS

from sentinel_tpu_torch import convert
from sentinel_tpu_torch.core.batch import to_device
from sentinel_tpu_torch.ops import step as PS

from tests.test_torch_support import (
    NOW0, Scenario, assert_decisions_equal, assert_tree_equal, jax_entry,
    jax_exit, jax_to_np, port_np)

STEPS = 10


@pytest.fixture(scope="module")
def jitted():
    return jax.jit(JS.entry_step), jax.jit(JS.exit_step)


def _fresh(system_qps):
    sc = Scenario(system_qps=system_qps)
    jrules, jstate = sc.jax_rules()
    prules = convert.rules_from_numpy(jax_to_np(jrules), "cpu")
    pstate = convert.state_from_numpy(jax_to_np(jstate), "cpu")
    return sc, jrules, jstate, prules, pstate


@pytest.mark.parametrize("width,seed", [(8, 0), (64, 1), (512, 2)])
def test_step_sequence_matches_jax(jitted, width, seed):
    jent, jex = jitted
    sc, jrules, jstate, prules, pstate = _fresh(system_qps=400.0)
    rng = np.random.default_rng(seed)
    now = NOW0 + 123
    reasons_seen = set()
    waits = 0
    for step in range(STEPS):
        ebuf = sc.entry_batch(rng, width, fill=max(1, width - 3),
                              mixed=(step % 4 == 2), prioritized=0.2)
        jstate, jdec = jent(jstate, jrules, jax_entry(ebuf), jnp.int64(now))
        pstate, pdec = PS.entry_step(pstate, prules, to_device(ebuf, "cpu"),
                                     now)
        assert_decisions_equal(jdec, pdec)
        assert_tree_equal(jax_to_np(jstate), port_np(pstate))
        reason = np.asarray(jdec.reason)
        reasons_seen |= set(reason[reason > 0].tolist())
        waits += int((np.asarray(jdec.wait_us) > 0).sum())
        now += int(rng.integers(5, 40))
        xbuf = sc.exit_batch(rng, ebuf, reason, width)
        jstate = jex(jstate, jrules, jax_exit(xbuf), jnp.int64(now))
        pstate = PS.exit_step(pstate, prules, to_device(xbuf, "cpu"), now)
        assert_tree_equal(jax_to_np(jstate), port_np(pstate))
        now += int(rng.integers(100, 700))
    assert now - NOW0 > 2000  # crossed several seconds
    if width == 512:
        # The sequence really exercised the families it claims to.
        assert {1, 2, 3, 4, 5} <= reasons_seen, reasons_seen
        assert waits > 0


def test_width_zero_batch_runs_and_leaves_state_unchanged(jitted):
    jent, jex = jitted
    sc, jrules, jstate, prules, pstate = _fresh(system_qps=400.0)
    rng = np.random.default_rng(9)
    now = NOW0 + 77
    ebuf = sc.entry_batch(rng, 8, fill=6)
    jstate, jdec = jent(jstate, jrules, jax_entry(ebuf), jnp.int64(now))
    pstate, _ = PS.entry_step(pstate, prules, to_device(ebuf, "cpu"), now)
    xbuf = sc.exit_batch(rng, ebuf, np.asarray(jdec.reason), 8)
    jstate = jex(jstate, jrules, jax_exit(xbuf), jnp.int64(now))
    pstate = PS.exit_step(pstate, prules, to_device(xbuf, "cpu"), now)
    # Every window is now rotated to ``now``: an empty batch at the same
    # instant must change nothing at all.
    before = port_np(pstate)
    e0, x0 = make_entry_batch_np(0), make_exit_batch_np(0)
    j0 = jax.jit(JS.entry_step)(jstate, jrules, jax_entry(e0), jnp.int64(now))
    pstate, pdec = PS.entry_step(pstate, prules, to_device(e0, "cpu"), now)
    assert tuple(pdec.reason.shape) == (0,)
    assert_decisions_equal(j0[1], pdec)
    jstate = jax.jit(JS.exit_step)(j0[0], jrules, jax_exit(x0),
                                   jnp.int64(now))
    pstate = PS.exit_step(pstate, prules, to_device(x0, "cpu"), now)
    assert_tree_equal(before, port_np(pstate), rtol=0)
    assert_tree_equal(jax_to_np(jstate), port_np(pstate))


def test_flush_seconds_matches_jax():
    sc, jrules, jstate, prules, pstate = _fresh(system_qps=400.0)
    rng = np.random.default_rng(3)
    now = NOW0 + 10
    ebuf = sc.entry_batch(rng, 8)
    jstate, _ = jax.jit(JS.entry_step)(jstate, jrules, jax_entry(ebuf),
                                       jnp.int64(now))
    pstate, _ = PS.entry_step(pstate, prules, to_device(ebuf, "cpu"), now)
    jstate = JS.flush_seconds(jstate, now + 2500)
    pstate = PS.flush_seconds(pstate, now + 2500)
    assert_tree_equal(jax_to_np(jstate), port_np(pstate))
    assert int(pstate.telemetry.totals.sum()) > 0
