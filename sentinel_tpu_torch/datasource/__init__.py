"""Dynamic rule datasources (reference: ``sentinel-datasource-extension`` —
SURVEY.md §2.2): pull/push rule configuration into the property system.

``ReadableDataSource`` reads an external source, converts it with a
``Converter``, and pushes the result into its ``SentinelProperty`` — to which
a rule manager listens. ``WritableDataSource`` persists rules pushed from the
ops plane (``setRules`` command handler).

Coverage vs the reference's concrete connectors (every one follows one of
four wire shapes, each implemented here against a real protocol with an
in-repo fake server):

- **file mtime poll** (`FileRefreshableDataSource`) → ``base.py`` (exact).
- **HTTP poll / conditional GET** → ``http.py`` (generic endpoint),
  ``eureka.py`` (real Eureka instance-metadata REST with sticky URL
  failover), ``spring_config.py`` (real Config-Server environment
  endpoint with Spring source precedence).
- **HTTP long-poll push** → ``nacos.py`` (real Nacos 1.x open-api),
  ``consul.py`` (real Consul KV blocking queries), ``apollo.py`` (real
  notifications/v2 + releaseKey echo + open-api item/release publisher).
- **socket push-subscription** (Redis pub/sub, ZooKeeper watches) →
  ``redis.py`` (real RESP2), ``etcd.py`` (real etcd3 gRPC Watch),
  ``zookeeper.py`` (real jute frames with one-shot watch re-arm).

``push.py`` additionally proves the bare push/poll property shapes against
an in-process broker for tests that want no sockets at all.

Port of ``sentinel_tpu/datasource/``: the same connectors, wire and fake
servers, importing only this package. None of them touches a tensor: a
push reaches the card through the rule loader it is bound to
(``bind(source, st.load_flow_rules)``), which marks the family dirty; the
engine recompiles it at its next step.
"""

from sentinel_tpu_torch.datasource.base import (
    AbstractDataSource,
    AutoRefreshDataSource,
    Converter,
    FileRefreshableDataSource,
    FileWritableDataSource,
    ReadableDataSource,
    WritableDataSource,
    bind,
)
from sentinel_tpu_torch.datasource.push import (
    BrokerDataSource,
    BrokerWritableDataSource,
    InProcessBroker,
    PollingKVDataSource,
    PushDataSource,
)
from sentinel_tpu_torch.datasource.http import (
    HttpRefreshableDataSource,
    MiniConfigHTTPServer,
)
from sentinel_tpu_torch.datasource.eureka import (
    EurekaDataSource,
    EurekaWritableDataSource,
    MiniEurekaServer,
)
from sentinel_tpu_torch.datasource.spring_config import (
    MiniSpringConfigServer,
    SpringCloudConfigDataSource,
)
from sentinel_tpu_torch.datasource.redis import (
    MiniRedisServer,
    RedisDataSource,
    RedisWritableDataSource,
)
from sentinel_tpu_torch.datasource.nacos import (
    MiniNacosServer,
    NacosDataSource,
    NacosWritableDataSource,
)
from sentinel_tpu_torch.datasource.consul import (
    ConsulDataSource,
    ConsulWritableDataSource,
    MiniConsulServer,
)
from sentinel_tpu_torch.datasource.apollo import (
    ApolloDataSource,
    ApolloWritableDataSource,
    MiniApolloServer,
)
from sentinel_tpu_torch.datasource.zookeeper import (
    MiniZooKeeperServer,
    ZookeeperDataSource,
    ZookeeperWritableDataSource,
)
try:
    # The etcd connector needs the protobuf runtime (its etcd3 messages
    # are descriptor-built at import); every other datasource is stdlib-
    # only and must stay importable without it.
    from sentinel_tpu_torch.datasource.etcd import (
        EtcdDataSource,
        EtcdWritableDataSource,
        MiniEtcdServer,
    )
except ImportError:  # pragma: no cover — protobuf-less host
    EtcdDataSource = EtcdWritableDataSource = MiniEtcdServer = None
from sentinel_tpu_torch.datasource.converters import (
    authority_rules_from_json,
    authority_rules_to_json,
    degrade_rules_from_json,
    degrade_rules_to_json,
    flow_rules_from_json,
    flow_rules_to_json,
    param_rules_from_json,
    param_rules_to_json,
    system_rules_from_json,
    system_rules_to_json,
    tps_rules_from_json,
    tps_rules_to_json,
)

__all__ = [
    "AbstractDataSource", "AutoRefreshDataSource", "Converter",
    "BrokerDataSource", "BrokerWritableDataSource", "InProcessBroker",
    "PollingKVDataSource", "PushDataSource",
    "FileRefreshableDataSource", "FileWritableDataSource",
    "HttpRefreshableDataSource", "MiniConfigHTTPServer",
    "EurekaDataSource", "EurekaWritableDataSource", "MiniEurekaServer",
    "MiniSpringConfigServer", "SpringCloudConfigDataSource",
    "MiniRedisServer", "RedisDataSource", "RedisWritableDataSource",
    "MiniNacosServer", "NacosDataSource", "NacosWritableDataSource",
    "ConsulDataSource", "ConsulWritableDataSource", "MiniConsulServer",
    "MiniZooKeeperServer", "ZookeeperDataSource",
    "ZookeeperWritableDataSource",
    "ApolloDataSource", "ApolloWritableDataSource", "MiniApolloServer",
    "EtcdDataSource", "EtcdWritableDataSource", "MiniEtcdServer",
    "ReadableDataSource", "WritableDataSource", "bind",
    "authority_rules_from_json", "authority_rules_to_json",
    "degrade_rules_from_json", "degrade_rules_to_json",
    "flow_rules_from_json", "flow_rules_to_json",
    "param_rules_from_json", "param_rules_to_json",
    "system_rules_from_json", "system_rules_to_json",
    "tps_rules_from_json", "tps_rules_to_json",
]
