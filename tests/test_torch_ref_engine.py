"""The JAX package's engine-subsystem test files, run against the port:
the pipeline, the slot table, checkpoints, SPI, spans, the observability
surface and the namespace router (``tests/test_torch_refsuite.py``)."""

from tests.test_torch_refsuite import (
    check_accounting, install, ref_id, step_alias)

FILES = ("test_pipeline.py", "test_slots.py", "test_checkpoint.py",
         "test_checkpoint_scenarios.py", "test_spi.py", "test_spans.py",
         "test_observability.py", "test_namespaces.py")

POD = ("the shard_map pod path (C1 on the reference: check_rep is rejected "
       "under jax 0.9.0); the port's pod is held to the reference's "
       "per-shard bodies by tests/test_torch_pod.py and "
       "tests/test_torch_namespaces.py")

# Failure injection through the JAX engine's jitted steps goes through the
# port's step functions instead (``_entry_jit`` -> ``_entry_step``).
PORT_VARIANTS = {
    ref_id("test_pipeline.py", n): (lambda n: lambda mod: step_alias(
        getattr(mod, n)))(n)
    for n in ("test_sync_device_failure_fails_open_and_recovers",
              "test_exit_device_failure_never_breaks_caller",
              "test_async_pipeline_mid_stream_fault_parity")
}
XFAIL: dict = {}
EXCLUDED = {
    ref_id("test_checkpoint_scenarios.py",
           "test_pod_state_checkpoint_roundtrip_keeps_global_quota"): POD,
    **{ref_id("test_namespaces.py", n): POD
       for n in ("test_pod_scope_rule_is_per_slice",
                 "test_global_scope_rule_spans_pods",
                 "test_global_scope_bounded_overshoot_then_stop",
                 "test_dcn_exit_step_balances_gauges")},
}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
