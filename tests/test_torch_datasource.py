"""Rule datasources in the port (``sentinel_tpu_torch/datasource/``)
against the JAX package's, on the CPU.

- The tier-1 cases of ``tests/test_datasource.py`` on the port, but the
  ``setRules`` round trip (``:83``), which needs the ops plane
  (``transport/``) the port does not have yet.
- **Wire parity.** Each port connector against the JAX package's fake
  server, and each JAX connector against the port's fake server: the same
  documents, written by the other package's writable half where the
  connector has one, give the same sequence of rule lists (as converter
  dicts) in both directions; a bad payload in the middle pushes nothing.
- **Engine parity.** The same rules file feeds each package's
  ``FileRefreshableDataSource`` bound to its engine (one JAX engine and
  one port engine, ``device="cpu"``, on one injected clock, for the
  module); after each push both give the same ``Decisions`` (``reason``,
  ``wait_us``, ``rule_slot``) and the same state.
- **Journal parity.** Those pushes, and a broker push, write the same
  ``ruleLoad`` records with ``actor: datasource:<ClassName>`` in both
  engines' journals.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from sentinel_tpu_torch.core.batch import make_entry_batch_np

from tests.test_torch_connectors import CONNECTORS
from tests.test_torch_support import (
    CTX, assert_decisions_equal, assert_tree_equal, ds_pkgs, jax_entry,
    jax_to_np, port_np, wait_for)

J, P = ds_pkgs()
NOW0 = 1_700_000_000_000


# ---------------------------------------------------------------------------
# tests/test_datasource.py on the port
# ---------------------------------------------------------------------------


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


def test_push_source_drives_engine_rules(engine):
    """test_datasource.py:24: a rule push reaches the engine with no file
    involved, and is enforced at once."""
    broker = P.push.InProcessBroker()
    src = P.push.BrokerDataSource(broker, "rules/flow",
                                  P.conv.flow_rules_from_json)
    P.ds.bind(src, P.st.load_flow_rules)
    try:
        assert engine.flow_rules.get_rules() == []
        broker.set("rules/flow",
                   json.dumps([{"resource": "pushed", "count": 1.0}]))
        assert engine_resources(engine) == ["pushed"]
        assert P.st.entry_ok("pushed") and not P.st.entry_ok("pushed")
    finally:
        src.close()


def test_push_source_initial_load(engine):
    """test_datasource.py:41: a key present at subscribe time loads."""
    broker = P.push.InProcessBroker()
    broker.set("k", json.dumps([{"resource": "pre", "count": 5.0}]))
    src = P.push.BrokerDataSource(broker, "k", P.conv.flow_rules_from_json)
    P.ds.bind(src, P.st.load_flow_rules)
    assert engine_resources(engine) == ["pre"]
    src.close()


def test_push_bad_payload_keeps_last_good(engine):
    """test_datasource.py:54."""
    broker = P.push.InProcessBroker()
    src = P.push.BrokerDataSource(broker, "k", P.conv.flow_rules_from_json)
    P.ds.bind(src, P.st.load_flow_rules)
    try:
        broker.set("k", json.dumps([{"resource": "good", "count": 2.0}]))
        broker.set("k", "{not json!")
        assert engine_resources(engine) == ["good"]
    finally:
        src.close()


def test_polling_kv_source_version_gated(engine):
    """test_datasource.py:66."""
    broker = P.push.InProcessBroker()
    src = P.push.PollingKVDataSource(broker, "cfg",
                                     P.conv.flow_rules_from_json,
                                     recommend_refresh_ms=100000)
    P.ds.bind(src, P.st.load_flow_rules)
    try:
        src.first_load()
        assert engine.flow_rules.get_rules() == []
        src.refresh()
        broker.set("cfg", json.dumps([{"resource": "polled", "count": 3.0}]))
        src.refresh()
        assert engine_resources(engine) == ["polled"]
        assert not src.is_modified()
    finally:
        src.close()


def test_push_source_has_no_pull_path():
    """test_datasource.py:119."""
    src = P.push.PushDataSource(P.conv.flow_rules_from_json)
    with pytest.raises(NotImplementedError):
        src.read_source()


def test_http_initial_load_and_change_push(engine):
    """test_datasource.py:129."""
    server = P.http.MiniConfigHTTPServer().start()
    try:
        server.set_document(json.dumps([{"resource": "h0", "count": 5.0}]))
        src = P.http.HttpRefreshableDataSource(
            server.url, P.conv.flow_rules_from_json,
            recommend_refresh_ms=100000)
        P.ds.bind(src, P.st.load_flow_rules)
        src.first_load()
        assert engine_resources(engine) == ["h0"]
        server.set_document(json.dumps([{"resource": "h1", "count": 2.0}]))
        src.refresh()
        assert engine_resources(engine) == ["h1"]
    finally:
        server.stop()


def test_http_unchanged_poll_is_a_304(engine):
    """test_datasource.py:151."""
    server = P.http.MiniConfigHTTPServer().start()
    try:
        server.set_document(json.dumps([{"resource": "same", "count": 1.0}]))
        src = P.http.HttpRefreshableDataSource(
            server.url, P.conv.flow_rules_from_json,
            recommend_refresh_ms=100000)
        P.ds.bind(src, P.st.load_flow_rules)
        src.first_load()
        for _ in range(3):
            src.refresh()
        assert server.not_modified_count == 3
        assert engine_resources(engine) == ["same"]
    finally:
        server.stop()


def test_http_server_outage_keeps_last_good(engine):
    """test_datasource.py:173."""
    import urllib.error

    server = P.http.MiniConfigHTTPServer().start()
    server.set_document(json.dumps([{"resource": "kept", "count": 3.0}]))
    src = P.http.HttpRefreshableDataSource(
        server.url, P.conv.flow_rules_from_json, recommend_refresh_ms=100000,
        timeout_s=0.5)
    P.ds.bind(src, P.st.load_flow_rules)
    src.first_load()
    server.stop()
    with pytest.raises((urllib.error.URLError, OSError)):
        src.refresh()
    assert engine_resources(engine) == ["kept"]


def test_auto_refresh_close_joins_the_poll_thread():
    """A connector's ``close()`` stops its daemon thread within the
    reference's bound (``base.py:218-225``), so nothing it started
    outlives it."""
    broker = P.push.InProcessBroker()
    src = P.push.PollingKVDataSource(broker, "cfg",
                                     P.conv.flow_rules_from_json,
                                     recommend_refresh_ms=50).start()
    t0 = time.monotonic()
    src.close()
    assert time.monotonic() - t0 < 1.0
    assert not src._thread.is_alive()


# ---------------------------------------------------------------------------
# Wire parity: each package's connector against the other's fake server
# ---------------------------------------------------------------------------


DOC1 = json.dumps([
    {"resource": "api:a", "count": 5, "grade": 1},
    {"resource": "api:b", "count": 2.5, "controlBehavior": 2,
     "maxQueueingTimeMs": 200},
    {"resource": "api:c", "count": 10, "limitApp": "appA",
     "strategy": 0}])
DOC2 = json.dumps([
    {"resource": "api:a", "count": 1},
    {"resource": "api:d", "count": 8, "controlBehavior": 1,
     "warmUpPeriodSec": 5}])
DOC3 = json.dumps([
    {"resource": "api:e", "count": 4, "clusterMode": True,
     "clusterConfig": {"flowId": 7, "thresholdType": 1}}])
BAD = "{not json]"


def expected_dicts(doc):
    want = J.rule_dicts(J.conv.flow_rules_from_json(doc))
    assert want == P.rule_dicts(P.conv.flow_rules_from_json(doc))
    return want


@pytest.mark.parametrize("srv_pkg,src_pkg", [(0, 1), (1, 0)],
                         ids=["port-reads-jax", "jax-reads-port"])
@pytest.mark.parametrize("conn", CONNECTORS, ids=repr)
def test_wire_parity_across_packages(conn, srv_pkg, src_pkg, tmp_path):
    S, R = ds_pkgs()[srv_pkg], ds_pkgs()[src_pkg]
    srv = conn.server(S, tmp_path)
    seen = []
    src = conn.source(R, srv)
    src.property.add_listener(R.base.SimplePropertyListener(
        lambda v: seen.append(R.rule_dicts(v))))
    src = conn.start(src)
    seen.clear()  # the plain HTTP endpoint serves ``[]`` until set
    try:
        # The first document through the reader's package's writer where
        # the connector has one (a cross-package write), the third through
        # the server's package's, the others out of band.
        steps = [(DOC1, R), (DOC2, None), (BAD, None), (DOC3, S)]
        want = []
        for doc, W in steps:
            writer = None if W is None else conn.writer(W, srv)
            if writer is not None:
                writer.write(W.conv.flow_rules_from_json(doc))
            else:
                conn.publish(srv, doc)
            if doc is BAD:
                time.sleep(0.2)
                assert seen == want
                continue
            want.append(expected_dicts(doc))
            assert wait_for(lambda: seen == want), (seen, want)
    finally:
        src.close()
        conn.stop_server(srv)


# ---------------------------------------------------------------------------
# Engine and journal parity: one rules file, one engine per package
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


WIDTH = 16
LANES = ["api:a"] * 6 + ["api:b"] * 4 + ["api:c"] * 3 + ["free"] * 3
TWIN_DOCS = (
    json.dumps([{"resource": "api:a", "count": 4},
                {"resource": "api:b", "count": 2, "limitApp": "default"},
                {"resource": "api:c", "count": 100, "grade": 1}]),
    # The same structure, tightened: the second push recompiles no shape.
    json.dumps([{"resource": "api:a", "count": 1},
                {"resource": "api:b", "count": 2, "limitApp": "default"},
                {"resource": "api:c", "count": 2, "grade": 1}]),
)


def fill(eng, lanes):
    """Stage ``lanes`` (resource names, default origin) into one entry
    buffer resolved against ``eng``'s registry (rows are per engine)."""
    reg = eng.registry
    buf = make_entry_batch_np(WIDTH)
    parent = reg.entrance_row(CTX)
    for i, res in enumerate(lanes):
        cr, dn, orow, oid = reg.resolve_entry(res, CTX, "", parent, 1)
        buf["cluster_row"][i] = cr
        buf["dn_row"][i] = dn
        buf["origin_row"][i] = orow
        buf["origin_id"][i] = oid
        buf["context_id"][i] = reg.context_id(CTX)
        buf["count"][i] = 1
    return buf


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """A JAX and a port engine on one injected clock, each fed by its own
    package's ``FileRefreshableDataSource`` reading the same file, and a
    broker source of each package bound to its engine's degrade rules."""
    for M in (J, P):
        M.ctx.replace_context(None)
        M.ctx.bump_generation()
    clock = Clock(NOW0 + 100_000)
    engines = (J.engine_mod.SentinelEngine(capacity=128, clock=clock,
                                           journal_path=""),
               P.engine_mod.SentinelEngine(capacity=128, clock=clock,
                                           journal_path="", device="cpu"))
    path = tmp_path_factory.mktemp("twin") / "flow-rules.json"
    sources = []
    for M, eng in zip((J, P), engines):
        src = M.base.FileRefreshableDataSource(
            str(path), M.conv.flow_rules_from_json, recommend_refresh_ms=1)
        M.ds.bind(src, eng.flow_rules.load_rules)
        sources.append(src)
    yield {"clock": clock, "engines": engines, "sources": sources,
           "path": path}
    for M, eng in zip((P, J), engines[::-1]):
        M.ctx.replace_context(None)
        eng.close()


def twin_push(twin, doc):
    """Write ``doc`` and have both packages' sources read it (no poll
    thread: the read is deterministic), then compile both engines under
    their locks so neither compiles later on a background flush."""
    twin["path"].write_text(doc)
    for src in twin["sources"]:
        src.refresh(force=True)
    for eng in twin["engines"]:
        eng._flush_committer()
        with eng._lock:
            eng._ensure_compiled()


def twin_check(twin):
    j, p = twin["engines"]
    jb, pb = fill(j, LANES), fill(p, LANES)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    now = twin["clock"].now
    jd = j.check_batch(jax_entry(jb), now_ms=now)
    pd = p.check_batch(pb, now_ms=now)
    assert_decisions_equal(jd, pd)
    for eng in (j, p):
        eng._flush_committer()
    with j._lock, p._lock:
        assert_tree_equal(jax_to_np(j._state), port_np(p.state))
        assert_tree_equal(jax_to_np(j._rules), port_np(p.rules))
    return pd.reason.numpy()[:len(LANES)].copy()


def test_engine_parity_through_one_rules_file(twin):
    """The same file, read by each package's connector, gives both
    engines the same rules, decisions and state; the tightened second
    push takes hold at the next step on both."""
    twin_push(twin, TWIN_DOCS[0])
    j, p = twin["engines"]
    assert J.rule_dicts(j.flow_rules.get_rules()) \
        == P.rule_dicts(p.flow_rules.get_rules())
    first = twin_check(twin)
    assert (first[:6] != 0).sum() == 2       # api:a admits 4 of 6
    twin["clock"].now += 1000                # a fresh second
    twin_push(twin, TWIN_DOCS[1])
    second = twin_check(twin)
    assert (second[:6] == 0).sum() == 1      # tightened to 1
    assert (second[10:13] == 0).sum() == 2   # api:c tightened to 2
    assert (second[13:] == 0).all()          # unruled


def test_journal_parity_of_datasource_pushes(twin):
    """Every push above, and one broker push, journals the same
    ``ruleLoad`` records in both engines, each with the pushing
    connector's class as its actor."""
    j, p = twin["engines"]
    for M, eng in zip((J, P), (j, p)):
        broker = M.push.InProcessBroker()
        src = M.push.BrokerDataSource(broker, "degrade",
                                      M.conv.degrade_rules_from_json)
        M.ds.bind(src, eng.degrade_rules.load_rules)
        broker.set("degrade", json.dumps([
            {"resource": "api:c", "grade": 0, "count": 50,
             "timeWindow": 2}]))
        src.close()
    jrec = j.journal.tail(kind="ruleLoad")
    prec = p.journal.tail(kind="ruleLoad")
    assert jrec == prec
    actors = [r.get("actor") for r in prec]
    assert actors.count("datasource:FileRefreshableDataSource") >= 2
    assert actors[-1] == "datasource:BrokerDataSource"
    assert prec[-1]["family"] == "degrade"
