"""The JAX package's cluster test files, run against the port: the token
service and its wire, HA failover, sharding, the rebalancer, overload
shedding, the TLV fixtures, the native client, the Java bridge and the
chaos drills (``tests/test_torch_refsuite.py``)."""

from tests.test_torch_refsuite import check_accounting, install

FILES = ("test_cluster.py", "test_cluster_ha.py", "test_shard.py",
         "test_rebalance.py", "test_wire.py", "test_overload.py",
         "test_tlv_fixtures.py", "test_native.py", "test_java_bridge.py",
         "test_remote_bridge.py", "test_chaos.py", "test_chaos_campaign.py")
PORT_VARIANTS: dict = {}
XFAIL: dict = {}
EXCLUDED: dict = {}

EXPORTED = install(globals(), FILES, variants=PORT_VARIANTS, xfail=XFAIL,
                   excluded=EXCLUDED)


def test_accounting():
    counts = check_accounting(__file__, FILES, EXPORTED, PORT_VARIANTS,
                              XFAIL, EXCLUDED)
    assert set(counts) == set(FILES)
