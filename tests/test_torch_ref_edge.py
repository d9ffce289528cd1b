"""The JAX package's edge test files, run against the port: the framework
adapters, the Envoy RLS service, the ops plane, the dashboard, LLM
admission and the simulator (``tests/test_torch_refsuite.py``)."""

from tests.test_torch_refsuite import check_accounting, install

FILES = ("test_adapters.py", "test_envoy_rls.py", "test_transport.py",
         "test_dashboard.py", "test_llm.py", "test_simulator.py")
PORT_VARIANTS: dict = {}
XFAIL: dict = {}
EXCLUDED: dict = {}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
