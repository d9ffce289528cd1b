"""The JAX package's kernel-level test files, run against the port: the
window ops, the segmented prefix and bincount, the param CMS, the step
and token-service fuzzers; and the accounting of the files whose subject
exists only in JAX (Pallas interpret mode, compile budgets, the
``shard_map`` pod path).

The window, segment and CMS files drive JAX ops through ``jax.jit`` and
``jnp`` arrays: their cases run as port variants, the reference's own
bodies with ``jax`` / ``jax.numpy`` bound to the port's stand-ins
(``tests/test_torch_refsuite.py:PortJax``, ``PortArrays``: eager calls,
tensors on the harness's device, host clocks) and the port's ops where
the file wrapped JAX's in a jit.
"""

import functools

from tests.test_torch_refsuite import (
    DEVICE, PortArrays, PortJax, check_accounting, install, rebind, ref_id)

FILES = ("test_window.py", "test_segment_exactness.py", "test_param_cms.py",
         "test_step_fuzz.py", "test_token_service_fuzz.py")
# Whole files whose subject exists only in JAX (kind d).
JAX_ONLY = {
    "test_pallas_prefix.py":
        "Pallas interpret mode of the TPU prefix kernel (and C2: the module "
        "does not import under jax 0.9.0); the port's Hopper kernel is held "
        "to its plain form by tests/test_torch_segment.py and the smoke",
    "test_compile_budget.py":
        "XLA compile budgets of the jitted steps; the port runs eagerly",
    "test_pod_parallel.py":
        "the shard_map pod path (C1 on the reference); the port's pod is "
        "held to the reference's per-shard bodies by tests/test_torch_pod.py",
    "test_pod_fuzz.py":
        "the shard_map pod path (C1 on the reference); tests/test_torch_pod.py",
}


class _PortWindowOps:
    """The port's ``ops/window.py`` with the device the reference's
    ``make_window`` / ``make_row_window`` leave to JAX."""

    def __init__(self, W):
        self._W = W
        self.make_window = functools.partial(W.make_window, device=DEVICE)
        self.make_row_window = functools.partial(W.make_row_window,
                                                 device=DEVICE)

    def __getattr__(self, name):
        return getattr(self._W, name)


def _window_variant(name):
    def factory(mod):
        W = mod.W

        def add_jit(win, now, row, ev, val, spec):
            win = W.rotate(win, now, spec)
            return W.add_events(win, now, row, ev, val, spec)

        def totals_jit(win, now, row, spec):
            return W.row_totals(W.rotate(win, now, spec), row)

        names = dict(jnp=PortArrays(DEVICE), W=_PortWindowOps(W),
                     _add_jit=add_jit, _totals_jit=totals_jit)
        names["_add"] = rebind(mod._add, **names)
        names["_total"] = rebind(mod._total, **names)
        return rebind(getattr(mod, name), **names)
    return factory


def _arrays_variant(name, helpers=()):
    """The case with ``jnp`` (and ``jax``) as the port's stand-ins, the
    named module helpers rebound the same way."""
    def factory(mod):
        names = dict(jnp=PortArrays(DEVICE), jax=PortJax(DEVICE))
        for h in helpers:
            names[h] = rebind(getattr(mod, h), **names)
        return rebind(getattr(mod, name), **names)
    return factory


def _one_route(request, monkeypatch):
    """Both of the reference's routings (the CPU sort route and the dense
    MXU forms behind ``_FORCE_DENSE``) are the port's one route on the
    harness's device: the plain form on the CPU, the Hopper kernel on
    the card."""


_WINDOW = ("test_single_bucket_accumulates", "test_rotation_drops_old_buckets",
           "test_partial_rotation_keeps_recent_bucket",
           "test_negative_row_dropped", "test_window_matches_oracle_random_trace",
           "test_row_window_varying_bucket_len")
_SEGMENT = ("test_dense_prefix_exact_at_count_256",
            "test_dense_prefix_worst_case_accumulation",
            "test_dense_prefix_multicolumn_shares_mask",
            "test_sort_path_matches_dense_path",
            "test_bincount_exact_at_count_256",
            "test_bincount_byte_limb_recomposition_exact_at_rt_clip")
_CMS = ("test_no_value_over_admits_within_window",
        "test_hot_key_exact_and_survives_cold_storm",
        "test_cold_keys_mostly_admitted_at_moderate_load",
        "test_cms_window_reset", "test_100k_distinct_keys_stream_fail_closed",
        "test_hot_owner_survives_cold_steal_after_window_roll",
        "test_cold_nonowner_full_quota_every_window")

PORT_VARIANTS = {
    **{ref_id("test_window.py", n): _window_variant(n) for n in _WINDOW},
    **{ref_id("test_segment_exactness.py", n): _arrays_variant(n)
       for n in _SEGMENT},
    **{ref_id("test_param_cms.py", n): _arrays_variant(n, ("_batch",))
       for n in _CMS},
}
FIXTURES = {
    ref_id("test_segment_exactness.py", "_both_routings"):
        lambda fn: _one_route,
    ref_id("test_param_cms.py", "kit"):
        lambda fn: rebind(fn, jax=PortJax(DEVICE), jnp=PortArrays(DEVICE)),
}
XFAIL = {
    ref_id("test_step_fuzz.py", "test_fuzz_warmup_random_traffic[31-60-8]"):
        "C25: the reference fails it too (a slow case: seed 31 drifts 11 "
        "admissions from its serial oracle over 50 batches, against a "
        "tolerance of max(4, checked // 10); ROADMAP Queue C)",
}
EXCLUDED = {f"tests/{f}": why for f, why in JAX_ONLY.items()}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED, fixtures=FIXTURES)


def test_accounting():
    counts = check_accounting(__file__, FILES + tuple(JAX_ONLY), EXPORTED,
                              PORT_VARIANTS, XFAIL, EXCLUDED)
    assert set(counts) == set(FILES) | set(JAX_ONLY)
