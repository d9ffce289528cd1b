"""The JAX package's main-path test files, run against the port.

``tests/test_torch_refsuite.py`` loads each file with its imports pointed
at ``sentinel_tpu_torch`` and the port's ``engine`` / ``frozen_time``
fixtures on the harness's device (``cpu`` here; ``chip_smoke.py``'s
reference phase runs this module with ``SENTINEL_REFSUITE_DEVICE=cuda``,
so every step goes through the Hopper prefix kernel). Every reference
case is run as written, replaced by a port variant, a strict xfail of a
reference caveat, or excluded with a reason; ``test_accounting`` holds
the four to the cases the reference files collect.
"""

from tests.test_torch_refsuite import (
    DEVICE, PortArrays, check_accounting, install, rebind, ref_id,
    step_alias)

FILES = ("test_flow.py", "test_degrade.py", "test_param_flow.py",
         "test_authority_system.py", "test_occupy.py",
         "test_warmup_oracle.py", "test_flow_batch_semantics.py",
         "test_lease.py")

C3 = ("C3: the reference fails it too (the slot floor reads 0 after the "
      "leased entry, or the jit trace-cache probe reads 0; ROADMAP Queue C)")

PORT_VARIANTS = {
    # The cap is a step argument in the port too: the step function the
    # engine dispatches stays the same object across a tune.
    ref_id("test_occupy.py",
           "test_occupy_timeout_tune_is_free_and_geometry_clamps"):
        lambda mod: step_alias(
            mod.test_occupy_timeout_tune_is_free_and_geometry_clamps),
    # ``jnp.asarray`` batches become tensors on the harness's device (on
    # the card the file's ``jax.numpy`` is the port's stand-in).
    ref_id("test_warmup_oracle.py", "test_warmup_curve_matches_serial_oracle"):
        lambda mod: rebind(mod.test_warmup_curve_matches_serial_oracle,
                           jnp=PortArrays(DEVICE)),
}
XFAIL = {
    ref_id("test_param_flow.py", n): C3
    for n in ("test_engine_slot_floor_ratchets_across_pushes",
              "test_reset_slot_floor_shrinks_after_transient_burst",
              "test_rule_push_cycle_never_retraces_after_first_use")
}
EXCLUDED: dict = {}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
