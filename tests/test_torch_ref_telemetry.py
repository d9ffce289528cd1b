"""The JAX package's telemetry and control-plane test files, run against
the port: attribution, the flight recorder, the population telescope, the
waterfall, SLOs, the adaptive loop, the fleet view and staged rollout
(``tests/test_torch_refsuite.py``)."""

from tests.test_torch_refsuite import (
    check_accounting, install, jax_stand_in, ref_id)

FILES = ("test_telemetry.py", "test_timeseries.py", "test_population.py",
         "test_waterfall.py", "test_slo.py", "test_adaptive.py",
         "test_fleet.py", "test_rollout.py")

POD = ("the shard_map pod path (C1 on the reference); the port's pod "
       "telemetry, flight ring and shadow reduction are held to the "
       "reference's per-shard bodies by tests/test_torch_pod.py")

PORT_VARIANTS = {
    # The flight recorder's marginal cost, timed on the port's eager step:
    # the body's ``jax.jit`` is the step itself, ``jnp`` batches tensors.
    ref_id("test_timeseries.py", "test_recording_marginal_cost_within_noise"):
        lambda mod: jax_stand_in(
            mod.test_recording_marginal_cost_within_noise),
}
XFAIL: dict = {}
EXCLUDED = {
    ref_id("test_telemetry.py", "test_pod_telemetry_counts_fold_device_axis"):
        POD,
    ref_id("test_timeseries.py", "test_pod_flight_recorder_folds_device_axis"):
        POD,
    ref_id("test_rollout.py", "test_pod_shadow_counters_ride_the_psum"): POD,
}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
