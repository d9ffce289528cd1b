"""The port's rule connectors (``sentinel_tpu_torch/datasource/``) against
their in-repo fake servers on loopback, on the CPU.

Every tier-1 case of the JAX package's connector files
(``tests/test_config_connectors.py``, ``test_apollo_datasource.py``,
``test_etcd_datasource.py``, ``test_redis_datasource.py``,
``test_zookeeper_datasource.py`` and ``test_eureka_springconfig.py``) runs
here on the port, but the dashboard publisher of
``test_redis_datasource.py:187`` (the port has no ``dashboard/`` yet).
The cases every connector shares (initial load and push, an absent
document then its first publish, the writable round trip, a bad payload
keeping the last good rules, a server restart, a push enforced by the
engine) are one parametrised test each over a table of connectors; the
cases only one connector has keep the reference's shape.

Rules bound to the engine land in one port engine for the module
(``device="cpu"``, the port's frozen clock), whose flow rules are cleared
before each test. Long-poll timeouts stay at the reference's 300-400 ms.
"""

from __future__ import annotations

import base64
import json
import os
import struct
import time
import urllib.error
import urllib.request

import pytest

from tests.test_torch_support import ds_pkgs, wait_for

P = ds_pkgs()[1]
NOW0 = 1_700_000_000_000


def rules_json(*resources, count=5.0) -> str:
    return json.dumps([{"resource": r, "count": count} for r in resources])


def resources(prop):
    return {r.resource for r in (prop.value or [])}


@pytest.fixture(scope="module")
def eng():
    """One port default engine for the module on the port's frozen clock."""
    P.tu.freeze_time(NOW0)
    P.ctx.replace_context(None)
    P.ctx.bump_generation()
    e = P.st.reset(capacity=512, device="cpu")
    yield e
    P.ctx.replace_context(None)
    e.close()
    P.tu.unfreeze_time()


@pytest.fixture()
def engine(eng):
    """The module's engine with no flow rules and a fresh second."""
    P.st.load_flow_rules([])
    P.tu.advance_time(10_000)
    P.ctx.replace_context(None)
    return eng


def engine_resources(eng):
    return [r.resource for r in eng.flow_rules.get_rules()]


# ---------------------------------------------------------------------------
# The connector table: one adapter per wire shape
# ---------------------------------------------------------------------------


class Connector:
    """How a test drives one connector of package ``M`` (``DsPkg``)
    against its fake server: ``server`` starts one, ``publish`` changes
    the document out of band, ``publish_offline`` does so while the
    server is down, ``source`` builds the (unstarted) connector and
    ``writer`` its writable half (None where the connector has none)."""

    name = ""
    watch = False          # a ReconnectingWatchMixin connector
    restartable = True

    def server(self, M, tmp_path):
        raise NotImplementedError

    def stop_server(self, srv):
        srv.stop()

    def restart_server(self, srv):
        srv.start()

    def publish(self, srv, text):
        raise NotImplementedError

    def publish_offline(self, srv, text):
        self.publish(srv, text)

    def source(self, M, srv, **kw):
        raise NotImplementedError

    def start(self, src):
        return src.start()

    def writer(self, M, srv):
        return None

    def ready(self, srv, src) -> bool:
        return True

    def __repr__(self):
        return self.name


class FileConn(Connector):
    name = "file"
    restartable = False

    class _Path:
        def __init__(self, path):
            self.path = str(path)
            self.tick = 0

        def stop(self):
            pass

    def server(self, M, tmp_path):
        return self._Path(tmp_path / "flow-rules.json")

    def publish(self, srv, text):
        tmp = srv.path + ".w"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, srv.path)
        # A distinct mtime for every rewrite: coarse filesystem clocks can
        # stamp two quick writes alike.
        srv.tick += 1
        t = 1_600_000_000 + srv.tick
        os.utime(srv.path, (t, t))

    def source(self, M, srv, **kw):
        return M.base.FileRefreshableDataSource(
            srv.path, M.conv.flow_rules_from_json, recommend_refresh_ms=40)

    def writer(self, M, srv):
        return M.base.FileWritableDataSource(srv.path,
                                             M.conv.flow_rules_to_json)


class HttpConn(Connector):
    name = "http"

    def server(self, M, tmp_path):
        return M.http.MiniConfigHTTPServer().start()

    def publish(self, srv, text):
        srv.set_document(text)

    def source(self, M, srv, **kw):
        return M.http.HttpRefreshableDataSource(
            srv.url, M.conv.flow_rules_from_json, recommend_refresh_ms=40,
            timeout_s=1.0)


RULE_KEY = "sentinel.flow.rules"


class EurekaConn(Connector):
    name = "eureka"

    def server(self, M, tmp_path):
        srv = M.eureka.MiniEurekaServer().start()
        srv.register("demo-app", "i-1", {})  # registered, no rule key yet
        return srv

    def publish(self, srv, text):
        srv.register("demo-app", "i-1", {RULE_KEY: text})

    def source(self, M, srv, **kw):
        return M.eureka.EurekaDataSource(
            [srv.service_url], "demo-app", "i-1", RULE_KEY,
            M.conv.flow_rules_from_json, recommend_refresh_ms=40,
            timeout_s=1.0)

    def writer(self, M, srv):
        return M.eureka.EurekaWritableDataSource(
            srv.service_url, "demo-app", "i-1", RULE_KEY,
            M.conv.flow_rules_to_json)


class SpringConn(Connector):
    name = "spring"

    def server(self, M, tmp_path):
        return M.spring.MiniSpringConfigServer().start()

    def publish(self, srv, text):
        srv.set_property("demo-app", RULE_KEY, text)

    def source(self, M, srv, **kw):
        return M.spring.SpringCloudConfigDataSource(
            srv.addr, "demo-app", RULE_KEY, M.conv.flow_rules_from_json,
            recommend_refresh_ms=40, timeout_s=1.0)


class NacosConn(Connector):
    name = "nacos"
    watch = True

    def server(self, M, tmp_path):
        return M.nacos.MiniNacosServer(max_hold_ms=400).start()

    def publish(self, srv, text):
        srv.publish("sentinel-flow", "DEFAULT_GROUP", text)

    def source(self, M, srv, **kw):
        kw.setdefault("poll_timeout_ms", 300)
        kw.setdefault("reconnect_backoff_ms", (20, 100))
        return M.nacos.NacosDataSource(srv.addr, "sentinel-flow",
                                       "DEFAULT_GROUP",
                                       M.conv.flow_rules_from_json, **kw)

    def writer(self, M, srv):
        return M.nacos.NacosWritableDataSource(
            srv.addr, "sentinel-flow", "DEFAULT_GROUP",
            M.conv.flow_rules_to_json)


CONSUL_KEY = "config/sentinel/flow-rules"


class ConsulConn(Connector):
    name = "consul"
    watch = True

    def server(self, M, tmp_path):
        return M.consul.MiniConsulServer(max_hold_ms=400).start()

    def publish(self, srv, text):
        srv.put(CONSUL_KEY, text)

    def source(self, M, srv, **kw):
        kw.setdefault("wait", "300ms")
        kw.setdefault("reconnect_backoff_ms", (20, 100))
        return M.consul.ConsulDataSource(srv.addr, CONSUL_KEY,
                                         M.conv.flow_rules_from_json, **kw)

    def writer(self, M, srv):
        return M.consul.ConsulWritableDataSource(srv.addr, CONSUL_KEY,
                                                 M.conv.flow_rules_to_json)


APP, NS = "demo-app", "application"


class ApolloConn(Connector):
    name = "apollo"
    watch = True

    def server(self, M, tmp_path):
        return M.apollo.MiniApolloServer(max_hold_ms=400).start()

    def publish(self, srv, text):
        srv.publish(APP, NS, "flowRules", text)

    def source(self, M, srv, **kw):
        kw.setdefault("poll_timeout_ms", 400)
        kw.setdefault("reconnect_backoff_ms", (20, 100))
        return M.apollo.ApolloDataSource(srv.addr, APP, NS, "flowRules",
                                         M.conv.flow_rules_from_json, **kw)

    def writer(self, M, srv):
        return M.apollo.ApolloWritableDataSource(
            srv.addr, APP, NS, "flowRules", M.conv.flow_rules_to_json)


class RedisConn(Connector):
    name = "redis"
    watch = True

    def server(self, M, tmp_path):
        return M.redis.MiniRedisServer().start()

    def publish(self, srv, text):
        conn = P.redis.RespConnection("127.0.0.1", srv.port)
        try:
            conn.command("SET", "rules/flow", text)
            conn.command("PUBLISH", "chan", text)
        finally:
            conn.close()

    def publish_offline(self, srv, text):
        srv._kv[b"rules/flow"] = text.encode()

    def source(self, M, srv, **kw):
        kw.setdefault("reconnect_backoff_ms", (20, 200))
        return M.redis.RedisDataSource("127.0.0.1", srv.port, "rules/flow",
                                       "chan", M.conv.flow_rules_from_json,
                                       **kw)

    def writer(self, M, srv):
        return M.redis.RedisWritableDataSource(
            "127.0.0.1", srv.port, "rules/flow", "chan",
            M.conv.flow_rules_to_json)

    def ready(self, srv, src):
        return bool(srv._subs.get(b"chan"))


ZK_PATH = "/sentinel/rules/flow"


class ZkConn(Connector):
    name = "zookeeper"
    watch = True

    def server(self, M, tmp_path):
        return M.zk.MiniZooKeeperServer().start()

    def publish(self, srv, text):
        srv.set_node(ZK_PATH, text.encode())

    def publish_offline(self, srv, text):
        srv._nodes[ZK_PATH] = (text.encode(), 0)

    def source(self, M, srv, **kw):
        kw.setdefault("reconnect_backoff_ms", (20, 100))
        return M.zk.ZookeeperDataSource(f"127.0.0.1:{srv.port}", ZK_PATH,
                                        M.conv.flow_rules_from_json, **kw)

    def writer(self, M, srv):
        return M.zk.ZookeeperWritableDataSource(
            f"127.0.0.1:{srv.port}", ZK_PATH, M.conv.flow_rules_to_json)


ETCD_KEY = "/sentinel/flow-rules"


class EtcdConn(Connector):
    name = "etcd"
    watch = True

    def server(self, M, tmp_path):
        if M.etcd is None:
            pytest.skip("no protobuf runtime for the etcd connector")
        return M.etcd.MiniEtcdServer().start()

    def publish(self, srv, text):
        srv.put(ETCD_KEY, text)

    def publish_offline(self, srv, text):
        with srv._lock:
            srv._revision += 1
            srv._kv[ETCD_KEY.encode()] = (text.encode("utf-8"), 1,
                                          srv._revision, 2)

    def source(self, M, srv, **kw):
        kw.setdefault("reconnect_backoff_ms", (20, 100))
        return M.etcd.EtcdDataSource(srv.endpoint, ETCD_KEY,
                                     M.conv.flow_rules_from_json, **kw)

    def writer(self, M, srv):
        return M.etcd.EtcdWritableDataSource(srv.endpoint, ETCD_KEY,
                                             M.conv.flow_rules_to_json)


class BrokerConn(Connector):
    name = "broker"
    restartable = False

    def server(self, M, tmp_path):
        broker = M.push.InProcessBroker()
        broker.stop = lambda: None
        return broker

    def publish(self, srv, text):
        srv.set("rules/flow", text)

    def source(self, M, srv, **kw):
        return M.push.BrokerDataSource(srv, "rules/flow",
                                       M.conv.flow_rules_from_json)

    def start(self, src):
        return src

    def writer(self, M, srv):
        return M.push.BrokerWritableDataSource(srv, "rules/flow",
                                               M.conv.flow_rules_to_json)


class PollingConn(BrokerConn):
    name = "polling"

    def source(self, M, srv, **kw):
        return M.push.PollingKVDataSource(srv, "rules/flow",
                                          M.conv.flow_rules_from_json,
                                          recommend_refresh_ms=40)

    def start(self, src):
        return src.start()


CONNECTORS = (FileConn(), HttpConn(), EurekaConn(), SpringConn(),
              NacosConn(), ConsulConn(), ApolloConn(), RedisConn(), ZkConn(),
              EtcdConn(), BrokerConn(), PollingConn())
BY_NAME = {c.name: c for c in CONNECTORS}
WRITABLE = tuple(BY_NAME[n] for n in (
    "file", "eureka", "nacos", "consul", "apollo", "redis", "zookeeper",
    "etcd", "broker", "polling"))
RESTARTABLE = tuple(c for c in CONNECTORS if c.restartable)
# The plain HTTP endpoint always serves a document (``[]`` until set).
ABSENT = tuple(c for c in CONNECTORS if c.name != "http")


class Running:
    """A started fake server and connector of one package, closed in
    reverse order."""

    def __init__(self, conn, M, tmp_path, publish_first=None, **kw):
        self.conn = conn
        self.srv = conn.server(M, tmp_path)
        if publish_first is not None:
            conn.publish(self.srv, publish_first)
        self.src = conn.start(conn.source(M, self.srv, **kw))

    def close(self):
        self.src.close()
        self.conn.stop_server(self.srv)


@pytest.fixture()
def running(tmp_path):
    opened = []

    def open_(conn, M=P, publish_first=None, **kw):
        r = Running(conn, M, tmp_path, publish_first, **kw)
        opened.append(r)
        return r

    yield open_
    for r in reversed(opened):
        r.close()


# ---------------------------------------------------------------------------
# The cases every connector shares (the reference's, parametrised)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conn", CONNECTORS, ids=repr)
def test_initial_load_and_push(conn, running):
    """test_config_connectors.py:68 / :209, test_etcd_datasource.py:59,
    test_eureka_springconfig.py:67 / :209, test_apollo_datasource.py:60,
    test_redis_datasource.py:66, test_zookeeper_datasource.py:100: the
    document present at start loads, a later publish lands with no
    restart."""
    r = running(conn, publish_first=rules_json("api:a"))
    assert wait_for(lambda: resources(r.src.property) == {"api:a"})
    conn.publish(r.srv, rules_json("api:a", "api:b"))
    assert wait_for(lambda: resources(r.src.property) == {"api:a", "api:b"})


@pytest.mark.parametrize("conn", ABSENT, ids=repr)
def test_absent_document_then_first_publish(conn, running):
    """test_config_connectors.py:82 / :222, test_etcd_datasource.py:71,
    test_eureka_springconfig.py:78, test_zookeeper_datasource.py:148: an
    absent key, node or instance pushes nothing; its first publish
    lands."""
    r = running(conn)
    assert r.src.property.value is None
    conn.publish(r.srv, rules_json("late"))
    assert wait_for(lambda: resources(r.src.property) == {"late"})


@pytest.mark.parametrize("conn", WRITABLE, ids=repr)
def test_writable_round_trip(conn, running):
    """test_config_connectors.py:91 / :231, test_etcd_datasource.py:80,
    test_apollo_datasource.py:109, test_redis_datasource.py:78,
    test_zookeeper_datasource.py:120, test_eureka_springconfig.py:158:
    what the writable half persists, the reading half loads."""
    r = running(conn)
    writer = conn.writer(P, r.srv)
    writer.write([P.st.FlowRule(resource="created", count=7.0)])
    assert wait_for(lambda: resources(r.src.property) == {"created"})
    writer.write([P.st.FlowRule(resource="updated", count=8.0)])
    assert wait_for(lambda: resources(r.src.property) == {"updated"})


@pytest.mark.parametrize("conn", CONNECTORS, ids=repr)
def test_bad_payload_keeps_last_good(conn, running):
    """test_datasource.py:54, test_config_connectors.py:257,
    test_etcd_datasource.py:91, test_apollo_datasource.py:156,
    test_redis_datasource.py:98, test_zookeeper_datasource.py:189,
    test_eureka_springconfig.py:283: a payload the converter refuses
    keeps the last good rules; a later good one still lands."""
    r = running(conn, publish_first=rules_json("good"))
    assert wait_for(lambda: resources(r.src.property) == {"good"})
    conn.publish(r.srv, "{not json]")
    time.sleep(0.2)
    assert resources(r.src.property) == {"good"}
    conn.publish(r.srv, rules_json("recovered"))
    assert wait_for(lambda: resources(r.src.property) == {"recovered"})


@pytest.mark.parametrize("conn", RESTARTABLE, ids=repr)
def test_reconnect_after_server_restart(conn, running):
    """test_config_connectors.py:150 / :270, test_etcd_datasource.py:104,
    test_apollo_datasource.py:168, test_redis_datasource.py:117,
    test_zookeeper_datasource.py:205, test_eureka_springconfig.py:134 /
    :296: the server crashes, the document changes while it is down, it
    comes back on the same port and the connector catches up; pushes
    work again afterwards."""
    r = running(conn, publish_first=rules_json("v1"))
    assert wait_for(lambda: resources(r.src.property) == {"v1"})
    assert wait_for(lambda: conn.ready(r.srv, r.src))
    conn.stop_server(r.srv)
    if conn.watch:
        assert wait_for(lambda: r.src.reconnect_count > 0)
    else:
        time.sleep(0.15)  # polls fail; the loop must survive
    conn.publish_offline(r.srv, rules_json("v2"))
    conn.restart_server(r.srv)
    assert wait_for(lambda: resources(r.src.property) == {"v2"},
                    timeout_s=8.0)
    conn.publish(r.srv, rules_json("after"))
    assert wait_for(lambda: resources(r.src.property) == {"after"})


@pytest.mark.parametrize("conn", CONNECTORS, ids=repr)
def test_push_enforced_by_the_engine(conn, running, engine):
    """test_config_connectors.py:183, test_etcd_datasource.py:141,
    test_datasource.py:24: a connector bound to ``st.load_flow_rules``
    delivers a count-0 rule and the port's engine enforces it."""
    r = running(conn)
    P.ds.bind(r.src, P.st.load_flow_rules)
    res = f"bound-{conn.name}"
    conn.publish(r.srv, rules_json(res, count=0.0))

    def blocked():
        try:
            with P.st.entry(res):
                pass
            return False
        except P.st.BlockException:
            return True

    assert wait_for(blocked)
    assert engine_resources(engine) == [res]


# ---------------------------------------------------------------------------
# Nacos (tests/test_config_connectors.py)
# ---------------------------------------------------------------------------


NACOS = BY_NAME["nacos"]


def test_nacos_bad_payload_keeps_last_good_without_spinning(running):
    """test_config_connectors.py:103."""
    r = running(NACOS, publish_first=rules_json("good"))
    assert wait_for(lambda: resources(r.src.property) == {"good"})
    NACOS.publish(r.srv, "{not json]")
    assert wait_for(lambda: r.src._md5 == P.nacos._md5_hex("{not json]"))
    rounds_after_bad = r.srv.poll_rounds
    time.sleep(0.7)
    assert resources(r.src.property) == {"good"}
    assert r.srv.poll_rounds - rounds_after_bad <= 6
    NACOS.publish(r.srv, rules_json("recovered"))
    assert wait_for(lambda: resources(r.src.property) == {"recovered"})


def test_nacos_deleted_config_keeps_rules_without_spinning(running):
    """test_config_connectors.py:124."""
    r = running(NACOS, publish_first=rules_json("good"))
    assert wait_for(lambda: resources(r.src.property) == {"good"})
    r.srv.delete("sentinel-flow", "DEFAULT_GROUP")
    assert wait_for(lambda: r.src._md5 == "")
    rounds_after_delete = r.srv.poll_rounds
    time.sleep(0.7)
    assert resources(r.src.property) == {"good"}
    assert r.srv.poll_rounds - rounds_after_delete <= 6
    NACOS.publish(r.srv, rules_json("republished"))
    assert wait_for(lambda: resources(r.src.property) == {"republished"})


def test_normalize_base_schemes():
    """test_config_connectors.py:141."""
    normalize_base = P.mini.normalize_base
    assert normalize_base("1.2.3.4:8848") == "http://1.2.3.4:8848"
    assert normalize_base("http://h:1/") == "http://h:1"
    assert normalize_base("https://h:1") == "https://h:1"
    assert normalize_base("httpd-gw:8848") == "http://httpd-gw:8848"


def test_nacos_tenant_isolation(tmp_path):
    """test_config_connectors.py:167."""
    srv = P.nacos.MiniNacosServer(max_hold_ms=400).start()
    srv.publish("sentinel-flow", "DEFAULT_GROUP", rules_json("t-a"),
                tenant="a")
    src_a = NACOS.source(P, srv, tenant="a").start()
    src_default = NACOS.source(P, srv).start()
    try:
        assert wait_for(lambda: resources(src_a.property) == {"t-a"})
        assert src_default.property.value is None
    finally:
        src_a.close()
        src_default.close()
        srv.stop()


# ---------------------------------------------------------------------------
# Consul (tests/test_config_connectors.py)
# ---------------------------------------------------------------------------


CONSUL = BY_NAME["consul"]


def test_parse_wait_durations():
    """test_config_connectors.py:200."""
    parse = P.consul._parse_wait
    assert parse("10s") == 10.0
    assert parse("1m") == 60.0
    assert parse("250ms") == 0.25
    assert parse("5") == 5.0
    with pytest.raises(ValueError):
        parse("soon")


def test_consul_bad_wait_fails_at_construction():
    """test_config_connectors.py:209."""
    with pytest.raises(ValueError):
        P.consul.ConsulDataSource("127.0.0.1:1", "k",
                                  P.conv.flow_rules_from_json,
                                  wait="5 minutes")


def test_consul_blocking_query_parks_when_idle(running):
    """test_config_connectors.py:286."""
    r = running(CONSUL, publish_first=rules_json("idle"))
    assert wait_for(lambda: resources(r.src.property) == {"idle"})
    before_idx = r.srv._index
    before_rounds = r.srv.poll_rounds
    time.sleep(0.7)
    assert r.srv._index == before_idx
    assert r.src.reconnect_count == 0
    assert r.srv.poll_rounds - before_rounds <= 6


def test_consul_index_reset_restarts_watch(running):
    """test_config_connectors.py:307."""
    r = running(CONSUL, publish_first=rules_json("v1"))
    assert wait_for(lambda: resources(r.src.property) == {"v1"})
    with r.srv._cond:
        r.srv._index = 0
        r.srv._kv[CONSUL_KEY] = (rules_json("reset").encode("utf-8"), 1)
        r.srv._cond.notify_all()
    assert wait_for(lambda: resources(r.src.property) == {"reset"})


def test_consul_raw_http_shape():
    """test_config_connectors.py:323."""
    srv = P.consul.MiniConsulServer(max_hold_ms=400).start()
    try:
        srv.put("k", "hello")
        with urllib.request.urlopen(f"{srv.addr}/v1/kv/k") as resp:
            assert resp.headers["X-Consul-Index"] == "1"
            (entry,) = json.loads(resp.read())
        assert entry["Key"] == "k"
        assert base64.b64decode(entry["Value"]) == b"hello"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Apollo (tests/test_apollo_datasource.py)
# ---------------------------------------------------------------------------


APOLLO = BY_NAME["apollo"]


def test_apollo_release_key_suppresses_requery(running):
    """test_apollo_datasource.py:80."""
    r = running(APOLLO, publish_first=rules_json("r1"))
    assert r.src._release_key
    assert r.src._fetch_config() is None


def test_apollo_other_keys_in_namespace_ignored(running):
    """test_apollo_datasource.py:93."""
    r = running(APOLLO, publish_first=rules_json("mine"))
    assert resources(r.src.property) == {"mine"}
    r.srv.publish(APP, NS, "unrelated.key", "whatever")
    time.sleep(0.3)
    assert resources(r.src.property) == {"mine"}


def test_apollo_working_copy_invisible_until_release(running):
    """test_apollo_datasource.py:106 (the working copy half; the
    two-step write is the shared writable case)."""
    r = running(APOLLO)
    APOLLO.writer(P, r.srv).write(
        [P.st.FlowRule(resource="updated", count=8)])
    assert wait_for(lambda: resources(r.src.property) == {"updated"})
    with r.srv._cond:
        r.srv._working[(APP, "default", NS)]["flowRules"] = \
            rules_json("draft")
    time.sleep(0.3)
    assert resources(r.src.property) == {"updated"}


def test_apollo_open_api_token_enforced():
    """test_apollo_datasource.py:132."""
    srv = P.apollo.MiniApolloServer(max_hold_ms=400,
                                    token="secret-token").start()
    try:
        bad = P.apollo.ApolloWritableDataSource(srv.addr, APP, NS, "k",
                                                P.conv.flow_rules_to_json)
        with pytest.raises(OSError):
            bad.write([P.st.FlowRule(resource="x", count=1)])
        good = P.apollo.ApolloWritableDataSource(
            srv.addr, APP, NS, "k", P.conv.flow_rules_to_json,
            token="secret-token")
        good.write([P.st.FlowRule(resource="x", count=1)])
        src = P.apollo.ApolloDataSource(srv.addr, APP, NS, "k",
                                        P.conv.flow_rules_from_json,
                                        poll_timeout_ms=400)
        assert '"x"' in src.read_source()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# etcd (tests/test_etcd_datasource.py)
# ---------------------------------------------------------------------------


ETCD = BY_NAME["etcd"]


def test_etcd_watch_is_event_driven_not_polled(running):
    """test_etcd_datasource.py:128."""
    r = running(ETCD, publish_first=rules_json("idle"))
    assert wait_for(lambda: resources(r.src.property) == {"idle"})
    assert wait_for(lambda: r.srv.watch_count >= 1)
    watches_before = r.srv.watch_count
    time.sleep(0.5)
    assert r.srv.watch_count == watches_before
    assert r.src.reconnect_count == 0


def test_etcd_wire_messages_roundtrip():
    """test_etcd_datasource.py:165."""
    if P.etcd is None:
        pytest.skip("no protobuf runtime for the etcd connector")
    E = P.etcd
    kv = E.KeyValue(key=b"k", value=b"v", mod_revision=7, version=2)
    back = E.KeyValue.FromString(kv.SerializeToString())
    assert back.key == b"k" and back.mod_revision == 7
    wr = E.WatchRequest()
    wr.create_request.key = b"/sentinel/flow-rules"
    wr.create_request.start_revision = 42
    parsed = E.WatchRequest.FromString(wr.SerializeToString())
    assert parsed.HasField("create_request")
    assert parsed.create_request.start_revision == 42
    resp = E.WatchResponse()
    resp.header.revision = 9
    ev = resp.events.add()
    ev.kv.key = b"k"
    ev.kv.value = b"v2"
    parsed2 = E.WatchResponse.FromString(resp.SerializeToString())
    assert parsed2.events[0].kv.value == b"v2"
    assert E.PutRequest(key=b"a", value=b"b").SerializeToString()
    assert E.RangeResponse.FromString(b"") is not None


# ---------------------------------------------------------------------------
# Redis (tests/test_redis_datasource.py)
# ---------------------------------------------------------------------------


def test_resp_command_basics():
    """test_redis_datasource.py:47."""
    srv = P.redis.MiniRedisServer().start()
    conn = P.redis.RespConnection("127.0.0.1", srv.port)
    try:
        assert conn.command("PING") == "PONG"
        assert conn.command("SET", "k", "v1") == "OK"
        assert conn.command("GET", "k") == b"v1"
        assert conn.command("GET", "missing") is None
        assert conn.command("DEL", "k", "missing") == 1
        with pytest.raises(P.redis.RespError):
            conn.command("WHATISTHIS")
    finally:
        conn.close()
        srv.stop()


def test_redis_set_half_reaches_a_cold_reader(running):
    """test_redis_datasource.py:78 (the SET half of the writer)."""
    r = running(BY_NAME["redis"])
    BY_NAME["redis"].writer(P, r.srv).write(
        [P.st.FlowRule(resource="pushed", count=7)])
    assert wait_for(lambda: resources(r.src.property) == {"pushed"})
    cold = P.redis.RedisDataSource("127.0.0.1", r.srv.port, "rules/flow",
                                   "c", P.conv.flow_rules_from_json)
    assert b"pushed" in cold.read_source()


def test_redis_auth_required_and_satisfied():
    """test_redis_datasource.py:146."""
    srv = P.redis.MiniRedisServer(password="hunter2").start()
    try:
        with pytest.raises(P.redis.RespError, match="NOAUTH"):
            P.redis.RespConnection("127.0.0.1", srv.port).command("GET", "k")
        with pytest.raises(P.redis.RespError, match="invalid password"):
            P.redis.RespConnection("127.0.0.1", srv.port, password="wrong")
        src = P.redis.RedisDataSource("127.0.0.1", srv.port, "rules/flow",
                                      "chan", P.conv.flow_rules_from_json,
                                      password="hunter2").start()
        try:
            P.redis.RedisWritableDataSource(
                "127.0.0.1", srv.port, "rules/flow", "chan",
                P.conv.flow_rules_to_json, password="hunter2",
            ).write([P.st.FlowRule(resource="authed", count=1)])
            assert wait_for(lambda: resources(src.property) == {"authed"})
        finally:
            src.close()
    finally:
        srv.stop()


def test_redis_large_payload_reassembled(running, engine):
    """test_redis_datasource.py:169: a payload far larger than one
    ``recv()`` on both the GET and the pub/sub paths, bound to the
    engine."""
    big = rules_json(*(f"res-{i:05d}" for i in range(3000)))
    assert len(big) > 100_000
    r = running(BY_NAME["redis"])
    P.ds.bind(r.src, P.st.load_flow_rules)
    BY_NAME["redis"].publish(r.srv, big)
    assert wait_for(lambda: len(engine.flow_rules.get_rules()) == 3000)
    assert r.src.read_source().decode() == big


# ---------------------------------------------------------------------------
# ZooKeeper (tests/test_zookeeper_datasource.py)
# ---------------------------------------------------------------------------


ZK = BY_NAME["zookeeper"]


def test_jute_ops_basics():
    """test_zookeeper_datasource.py:57."""
    srv = P.zk.MiniZooKeeperServer().start()
    conn = P.zk.ZkConnection("127.0.0.1", srv.port)
    try:
        assert conn.session_id > 0
        assert not conn.exists("/nope")
        assert conn.create("/a", b"v0") == "/a"
        assert conn.exists("/a")
        assert conn.get_data("/a") == b"v0"
        conn.set_data("/a", b"v1")
        assert conn.get_data("/a") == b"v1"
        with pytest.raises(P.zk.ZkError) as ei:
            conn.get_data("/nope")
        assert ei.value.code == P.zk.ERR_NONODE
        with pytest.raises(P.zk.ZkError) as ei:
            conn.set_data("/a", b"x", version=99)
        assert ei.value.code == P.zk.ERR_BADVERSION
        conn.delete("/a")
        assert not conn.exists("/a")
    finally:
        conn.close()
        srv.stop()


def test_zk_watch_fires_once_and_rearms_on_read():
    """test_zookeeper_datasource.py:80."""
    srv = P.zk.MiniZooKeeperServer().start()
    conn = P.zk.ZkConnection("127.0.0.1", srv.port, timeout_s=None)
    try:
        conn.create(ZK_PATH, b"v0")
        assert conn.get_data(ZK_PATH, watch=True) == b"v0"
        srv.set_node(ZK_PATH, b"v1")
        _etype, _state, path = conn.next_event()
        assert path == ZK_PATH
        srv.set_node(ZK_PATH, b"v2")
        time.sleep(0.1)
        assert conn.events == []
        assert conn.get_data(ZK_PATH, watch=True) == b"v2"
        srv.set_node(ZK_PATH, b"v3")
        assert conn.next_event()[2] == ZK_PATH
    finally:
        conn.close()
        srv.stop()


def test_zk_writes_reach_a_cold_reader(running):
    """test_zookeeper_datasource.py:120 (the durability half)."""
    r = running(ZK)
    ZK.writer(P, r.srv).write([P.st.FlowRule(resource="updated", count=8)])
    assert wait_for(lambda: resources(r.src.property) == {"updated"})
    cold = P.zk.ZookeeperDataSource(f"127.0.0.1:{r.srv.port}", ZK_PATH,
                                    P.conv.flow_rules_from_json)
    assert b"updated" in cold.read_source()


def test_zk_delete_keeps_last_good_and_recreate_recovers(running):
    """test_zookeeper_datasource.py:165."""
    r = running(ZK, publish_first=rules_json("good"))
    assert wait_for(lambda: resources(r.src.property) == {"good"})
    conn = P.zk.ZkConnection("127.0.0.1", r.srv.port)
    conn.delete(ZK_PATH)
    conn.close()
    time.sleep(0.15)
    assert resources(r.src.property) == {"good"}
    ZK.publish(r.srv, rules_json("reborn"))
    assert wait_for(lambda: resources(r.src.property) == {"reborn"})


def test_zk_large_payload_reassembled(running, engine):
    """test_zookeeper_datasource.py:229."""
    many = rules_json(*[f"res-{i:04d}" for i in range(3000)])
    assert len(many) > 100_000
    r = running(ZK, publish_first=many)
    P.ds.bind(r.src, P.st.load_flow_rules)
    assert len(engine.flow_rules.get_rules()) == 3000


def test_zk_frame_length_guard():
    """test_zookeeper_datasource.py:244."""
    srv = P.zk.MiniZooKeeperServer().start()
    conn = P.zk.ZkConnection("127.0.0.1", srv.port)
    try:
        conn._buf = struct.pack(">i", 1 << 30)
        with pytest.raises(ConnectionError):
            conn._read_frame()
    finally:
        conn.close()
        srv.stop()


# ---------------------------------------------------------------------------
# Eureka and Spring Cloud Config (tests/test_eureka_springconfig.py)
# ---------------------------------------------------------------------------


EUREKA, SPRING = BY_NAME["eureka"], BY_NAME["spring"]


def test_eureka_missing_key_and_bad_payload_keep_last_good(running):
    """test_eureka_springconfig.py:92."""
    r = running(EUREKA, publish_first=rules_json("resA"))
    assert resources(r.src.property) == {"resA"}
    r.srv.register("demo-app", "i-1", {"other": "x"})
    time.sleep(0.2)
    assert resources(r.src.property) == {"resA"}
    r.srv.set_metadata("demo-app", "i-1", RULE_KEY, "{nope")
    time.sleep(0.2)
    assert resources(r.src.property) == {"resA"}
    r.srv.set_metadata("demo-app", "i-1", RULE_KEY, rules_json("resC"))
    assert wait_for(lambda: resources(r.src.property) == {"resC"})


def test_eureka_unchanged_metadata_pushes_nothing(running):
    """test_eureka_springconfig.py:110."""
    r = running(EUREKA, publish_first=rules_json("resA"))
    before = r.src.property.value
    polls_before = r.srv.request_count
    time.sleep(0.3)
    assert r.srv.request_count > polls_before
    assert r.src.property.value is before


def test_eureka_sticky_failover_between_replicas():
    """test_eureka_springconfig.py:121."""
    dead = P.eureka.MiniEurekaServer().start()
    live = P.eureka.MiniEurekaServer().start()
    live.register("demo-app", "i-1", {RULE_KEY: rules_json("resF")})
    dead_url = dead.service_url
    dead.stop()
    src = P.eureka.EurekaDataSource(
        [dead_url, live.service_url], "demo-app", "i-1", RULE_KEY,
        P.conv.flow_rules_from_json, recommend_refresh_ms=40,
        timeout_s=1.0).start()
    try:
        assert wait_for(lambda: resources(src.property) == {"resF"})
        assert src.failover_count >= 1
        time.sleep(0.2)
        assert src._url_idx == 1
    finally:
        src.close()
        live.stop()


def test_eureka_writable_url_size_guard():
    """test_eureka_springconfig.py:173."""
    srv = P.eureka.MiniEurekaServer().start()
    try:
        srv.register("demo-app", "i-1", {RULE_KEY: rules_json("resA")})
        writer = EUREKA.writer(P, srv)
        big = [P.st.FlowRule(resource=f"res-{i:06d}", count=float(i))
               for i in range(2000)]
        with pytest.raises(ValueError, match="max_url_bytes"):
            writer.write(big)
        assert "res-000000" not in srv.metadata("demo-app", "i-1")[RULE_KEY]
    finally:
        srv.stop()


def test_eureka_raw_http_shape():
    """test_eureka_springconfig.py:190."""
    srv = P.eureka.MiniEurekaServer().start()
    try:
        srv.register("demo-app", "i-1", {RULE_KEY: rules_json("resA")})
        req = urllib.request.Request(srv.service_url + "/apps/DEMO-APP/i-1",
                                     headers={"Accept": "application/json"})
        with urllib.request.urlopen(req, timeout=2.0) as resp:
            doc = json.loads(resp.read().decode("utf-8"))
        inst = doc["instance"]
        assert inst["app"] == "DEMO-APP" and inst["status"] == "UP"
        assert RULE_KEY in inst["metadata"]
    finally:
        srv.stop()


@pytest.fixture()
def config_server():
    s = P.spring.MiniSpringConfigServer().start()
    s.set_property("demo-app", RULE_KEY, rules_json("resA"))
    yield s
    s.stop()


def scc_source(server, **kw):
    kw.setdefault("recommend_refresh_ms", 40)
    return P.spring.SpringCloudConfigDataSource(
        server.addr, "demo-app", RULE_KEY, P.conv.flow_rules_from_json, **kw)


def test_scc_version_tracks_the_server(config_server):
    """test_eureka_springconfig.py:209 (the version half)."""
    src = scc_source(config_server).start()
    try:
        config_server.set_property("demo-app", RULE_KEY,
                                   rules_json("resA", "resB"))
        assert wait_for(lambda: resources(src.property) == {"resA", "resB"})
        assert src._version == config_server.version
    finally:
        src.close()


def test_scc_profile_source_beats_default(config_server):
    """test_eureka_springconfig.py:221."""
    config_server.set_property("demo-app", RULE_KEY, rules_json("prod-only"),
                               profile="prod")
    src = scc_source(config_server, profile="prod").start()
    try:
        assert resources(src.property) == {"prod-only"}
    finally:
        src.close()
    src2 = scc_source(config_server, profile="dev").start()
    try:
        assert resources(src2.property) == {"resA"}
    finally:
        src2.close()


def test_scc_deleting_profile_override_falls_back(config_server):
    """test_eureka_springconfig.py:238."""
    config_server.set_property("demo-app", RULE_KEY, rules_json("override"),
                               profile="prod")
    src = scc_source(config_server, profile="prod").start()
    try:
        assert resources(src.property) == {"override"}
        config_server.delete_property("demo-app", RULE_KEY, profile="prod")
        assert wait_for(lambda: resources(src.property) == {"resA"})
    finally:
        src.close()


def test_scc_basic_auth():
    """test_eureka_springconfig.py:252."""
    srv = P.spring.MiniSpringConfigServer(auth=("cfg", "secret")).start()
    srv.set_property("demo-app", RULE_KEY, rules_json("authd"))
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.addr + "/demo-app/default",
                                   timeout=2.0)
        assert ei.value.code == 401
        src = scc_source(srv, auth=("cfg", "secret")).start()
        try:
            assert resources(src.property) == {"authd"}
        finally:
            src.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("label,want", [("feature-x", "feature"),
                                        ("release/1.2", "branch")])
def test_scc_label_in_path(config_server, label, want):
    """test_eureka_springconfig.py:309 and :318 (a slashed label rides
    Spring's ``(_)`` encoding)."""
    config_server.set_property("demo-app", RULE_KEY, rules_json(want),
                               label=label)
    src = scc_source(config_server, label=label).start()
    try:
        if "/" in label:
            assert "(_)" in src._endpoint()
        assert resources(src.property) == {want}
    finally:
        src.close()


def test_scc_raw_environment_shape(config_server):
    """test_eureka_springconfig.py:329."""
    req = urllib.request.Request(config_server.addr + "/demo-app/default",
                                 headers={"Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=2.0) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    assert doc["name"] == "demo-app"
    assert doc["profiles"] == ["default"]
    assert doc["version"].startswith("rev-")
    assert any(RULE_KEY in ps["source"] for ps in doc["propertySources"])
