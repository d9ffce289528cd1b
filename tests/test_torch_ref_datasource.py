"""The JAX package's rule-datasource test files, run against the port:
the file and push sources and every config-system connector with its
fake server (``tests/test_torch_refsuite.py``)."""

from tests.test_torch_refsuite import check_accounting, install

FILES = ("test_datasource.py", "test_apollo_datasource.py",
         "test_etcd_datasource.py", "test_eureka_springconfig.py",
         "test_config_connectors.py", "test_redis_datasource.py",
         "test_zookeeper_datasource.py")
PORT_VARIANTS: dict = {}
XFAIL: dict = {}
EXCLUDED: dict = {}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
