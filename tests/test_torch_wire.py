"""The port's token-server wire against the JAX package's, over loopback
on the CPU: both frontends (the reactor and the thread-per-connection
socketserver), both directions (the port's client against the JAX
server, the JAX client against the port's server), the overload shed,
the ``MSG_ENTRY`` / ``MSG_EXIT`` bridge through ``remote_entry`` on a
port engine, the fleet telemetry replies of a leader engine, the
streaming-reservation branch's replies, and the epoch TLV.

Verdict sequences and reply bytes are compared exactly. Both packages'
clocks are frozen at the same instant, so every window and wait hint is
the same on both sides; requests go out one call at a time (a pipelined
call is one write), so the servers see them in one order.
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

from sentinel_tpu.cluster import client as JC
from sentinel_tpu.cluster import codec as jcodec
from sentinel_tpu.cluster import server as JS
from sentinel_tpu.cluster import token_service as JT
from sentinel_tpu.models.flow import FlowRule as JFlowRule
from sentinel_tpu.utils import time_util as jtu

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.cluster import client as PC
from sentinel_tpu_torch.cluster import codec as pcodec
from sentinel_tpu_torch.cluster import server as PS
from sentinel_tpu_torch.cluster import token_service as PT
from sentinel_tpu_torch.cluster.constants import (
    MSG_ENTRY, MSG_EXIT, MSG_FLEET, MSG_FLOW, MSG_PARAM_FLOW, MSG_PING,
    MSG_STREAM_TICK, TokenResultStatus)
from sentinel_tpu_torch.cluster.state import EpochFence
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.models.flow import FlowRule as PFlowRule
from sentinel_tpu_torch.resilience import faults
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000
FLOW_ID = 8100


@pytest.fixture(autouse=True)
def frozen_clocks():
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    yield
    for tu in (jtu, ptu):
        tu.unfreeze_time()


def _advance(ms):
    for tu in (jtu, ptu):
        tu.advance_time(ms)


def _rules(cls):
    return [
        cls(resource="g", count=5, cluster_mode=True,
            cluster_config={"flowId": FLOW_ID, "thresholdType": 1}),
        cls(resource="a", count=2, cluster_mode=True,
            cluster_config={"flowId": FLOW_ID + 1, "thresholdType": 0,
                            "windowIntervalMs": 2000, "sampleCount": 4}),
        cls(resource="p", count=3, cluster_mode=True,
            cluster_config={"flowId": FLOW_ID + 2, "thresholdType": 1}),
    ]


def _service(pkg, epoch=0):
    if pkg == "jax":
        svc = JT.DefaultTokenService(epoch=epoch)
        svc.rules.load_rules("default", _rules(JFlowRule))
    else:
        svc = PT.DefaultTokenService(epoch=epoch, device="cpu")
        svc.rules.load_rules("default", _rules(PFlowRule))
    return svc


def _server(pkg, reactor, svc=None, **kw):
    mod = JS if pkg == "jax" else PS
    return mod.ClusterTokenServer(svc or _service(pkg), host="127.0.0.1",
                                  port=0, reactor=reactor, **kw).start()


def _client(pkg, server, **kw):
    mod = JC if pkg == "jax" else PC
    c = mod.ClusterTokenClient("127.0.0.1", server.bound_port,
                               request_timeout_s=10.0, **kw).start()
    deadline = time.monotonic() + 10
    while not c.is_connected() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert c.is_connected()
    return c


def _recv_frames(sock, n, timeout_s=15.0):
    sock.settimeout(timeout_s)
    reader = pcodec.FrameReader()
    raw = bytearray()
    out = []
    while len(out) < n:
        data = sock.recv(65536)
        if not data:
            break
        raw.extend(data)
        out.extend(pcodec.decode_response(b) for b in reader.feed(data))
    return bytes(raw), out


def _drive(client):
    """One fixed request sequence; -> [(status, remaining, wait_ms)]."""
    out = []

    def note(results):
        out.extend((int(r.status), r.remaining, r.wait_ms) for r in results)

    for count in (1, 1, 3, 1):
        note([client.request_token(FLOW_ID, count)])
    note([client.request_token(FLOW_ID, 1, prioritized=True)])
    note(client.request_tokens_pipelined(
        [(FLOW_ID, 1, False)] * 2 + [(FLOW_ID + 1, 1, True)] * 5
        + [(999, 1, False), (FLOW_ID, 1, True)]))
    for v in ("k", "k", 7, "k", True):
        note([client.request_param_token(FLOW_ID + 2, 1, [v])])
    note([client.request_param_token(FLOW_ID + 2, 1, ["k", "k"])])
    _advance(1000)
    note(client.request_tokens_pipelined([(FLOW_ID + 1, 1, False)] * 3
                                         + [(FLOW_ID, 2, False)] * 3))
    note([client.request_param_token(FLOW_ID + 2, 2, ["k"])])
    return out


def _sequence(client_pkg, server_pkg, reactor):
    server = _server(server_pkg, reactor)
    client = _client(client_pkg, server)
    try:
        return _drive(client)
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("reactor", [True, False])
@pytest.mark.parametrize("pair", [("port", "jax"), ("jax", "port"),
                                  ("port", "port")])
def test_loopback_verdicts_match_the_reference(pair, reactor):
    """(client package, server package) against JAX client + JAX server,
    on the reactor and on the legacy frontend: the same verdicts, the
    same remaining quota and the same wait hints."""
    want = _sequence("jax", "jax", reactor)
    got = _sequence(*pair, reactor)
    assert got == want
    statuses = {s for s, _, _ in want}
    assert statuses >= {0, 1, 2, 3}


def _script():
    return [
        pcodec.encode_request(1, MSG_PING, pcodec.encode_ping("default")),
        pcodec.encode_request(2, MSG_FLOW,
                              pcodec.encode_flow_request(FLOW_ID, 2, False)),
        pcodec.encode_request(3, MSG_FLOW, pcodec.append_trace_tlv(
            pcodec.encode_flow_request(FLOW_ID, 9, True),
            "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")[:-1]),  # garbled
        pcodec.encode_request(4, MSG_FLOW,
                              pcodec.encode_flow_request(999, 1, False)),
        pcodec.encode_request(5, MSG_PARAM_FLOW,
                              pcodec.encode_param_flow_request(
                                  FLOW_ID + 2, 1, ["k", 7])),
        pcodec.encode_request(6, MSG_EXIT, pcodec.encode_exit_request(
            99, False)),
        pcodec.encode_request(7, 42, b"junk"),  # unknown type
    ]


def _replies(pkg, reactor, epoch):
    server = _server(pkg, reactor, _service(pkg, epoch=epoch))
    script = _script()
    try:
        with socket.create_connection(
                ("127.0.0.1", server.bound_port), timeout=15) as sock:
            sock.sendall(b"".join(script))
            raw, resps = _recv_frames(sock, len(script))
        assert len(resps) == len(script)
        return raw
    finally:
        server.stop()


@pytest.mark.parametrize("epoch", [0, 5])
@pytest.mark.parametrize("reactor", [True, False])
def test_reply_bytes_match_the_reference(reactor, epoch):
    """A scripted stream of every ported message type (a garbled trace
    TLV, an unknown flow, a param token, an unknown exit id, an unknown
    type), with and without the epoch TLV: the port's server answers
    byte for byte as the JAX package's."""
    assert _replies("port", reactor, epoch) == _replies("jax", reactor, epoch)


@pytest.mark.parametrize("reactor", [True, False])
def test_fleet_and_stream_tick_answer_the_pinned_fail(reactor):
    """The fleet telemetry branch answers byte for byte as the JAX
    package's server does for the same engine state (a seconds page and
    the population page, each served by a leader engine of its own
    package); the streaming-reservation branch answers as the JAX
    package's: OK with the reservation for a well-formed open on an
    engine with no TPS rule (nothing caps it), BAD_REQUEST for a
    malformed stream frame."""
    from sentinel_tpu.core.engine import SentinelEngine as JEngine

    fleet = [(1, pcodec.encode_fleet_request(0, 16)),
             (2, pcodec.encode_fleet_request(0, -1))]
    replies = {}
    for pkg in ("jax", "port"):
        eng = (JEngine(capacity=64, journal_path="") if pkg == "jax"
               else pst.SentinelEngine(capacity=64, device="cpu"))
        server = _server(pkg, reactor, engine=eng)
        script = [pcodec.encode_request(x, MSG_FLEET, body)
                  for x, body in fleet]
        script += [
            pcodec.encode_request(
                3, MSG_STREAM_TICK,
                pcodec.encode_stream_request(0, "s", "m", 8)),
            pcodec.encode_request(4, MSG_STREAM_TICK, b"\x01"),
        ]
        try:
            with socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=15) as sock:
                sock.sendall(b"".join(script))
                replies[pkg] = _recv_frames(sock, len(script))
        finally:
            server.stop()
            eng.close()
    jraw, jresps = replies["jax"]
    praw, presps = replies["port"]
    assert [(r.xid, r.msg_type, r.status, bytes(r.entity))
            for r in presps] == [
        (r.xid, r.msg_type, r.status, bytes(r.entity)) for r in jresps]
    assert all(r.status == TokenResultStatus.OK for r in presps[:2])
    page, _ = pcodec.decode_json_entity(presps[0].entity)
    assert page["seconds"] == [] and page["health"]["instance"] == 100
    assert [(r.xid, r.msg_type, r.status, bytes(r.entity))
            for r in presps[2:]] == [
        (3, MSG_STREAM_TICK, TokenResultStatus.OK,
         pcodec.encode_stream_response(8)),
        (4, MSG_STREAM_TICK, TokenResultStatus.BAD_REQUEST, b""),
    ]


@pytest.mark.parametrize("reactor", [True, False])
def test_epoch_tlv_and_client_fence(reactor):
    """Replies carry the leader's epoch; a client's fence rejects a reply
    below the highest epoch it has seen (FAIL, counted), and the
    ``cluster.ha.stale.epoch`` seam replays a deposed epoch."""
    svc = _service("port", epoch=5)
    server = _server("port", reactor, svc)
    fence = EpochFence()
    client = _client("port", server, epoch_fence=fence)
    jclient = _client("jax", server)
    try:
        assert client.request_token(FLOW_ID, 1).status == 0
        assert fence.highest_seen == 5
        svc.epoch = 3  # a deposed leader answering
        assert client.request_token(FLOW_ID, 1).status == TokenResultStatus.FAIL
        assert fence.stale_rejected_count == 1
        svc.epoch = 6
        with faults.FaultInjector(seed=1) as inj:
            inj.arm("cluster.ha.stale.epoch", "garbage",
                    garbage=pcodec.encode_epoch_value(4), times=1)
            assert client.request_token(FLOW_ID, 1).status == \
                TokenResultStatus.FAIL
        assert client.request_token(FLOW_ID, 1).status == 0
        assert fence.highest_seen == 6
        # The JAX client reads the port's stamp the same way.
        raw = jclient._call(MSG_FLOW, jcodec.encode_flow_request(
            FLOW_ID, 1, False))
        assert jcodec.read_epoch_tlv(raw.entity, jcodec.FLOW_RESP_SIZE) == 6
    finally:
        client.stop()
        jclient.stop()
        server.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_batcher_overload_shed_is_deterministic(pkg):
    """An undrained admission queue: the watermark and the full queue shed
    with the retry-after hint, allocating nothing per shed; both
    packages count the same."""
    mod = PS if pkg == "port" else JS
    b = mod._Batcher(_service(pkg), 0.0, 256, max_queue_groups=4,
                     watermark_pct=50, retry_after_ms=77)
    admitted = [b.submit_many([(FLOW_ID, 1, False)] * 8) for _ in range(2)]
    s1 = b.submit_many([(FLOW_ID, 1, False)] * 30)
    s2 = b.submit_many([(FLOW_ID, 1, False)])
    assert s1[0] is s2[0] and s1[0].is_set()
    assert s1[1] == {"shed_retry_after_ms": 77}
    assert admitted[0][0] is not admitted[1][0]
    stats = b.overload_stats()
    assert (stats["admittedRequests"], stats["shedRequests"],
            stats["shedWatermark"], stats["watermarkGroups"]) == (16, 31, 2, 2)


@pytest.mark.parametrize("reactor", [True, False])
def test_overloaded_reply_reaches_both_clients(reactor):
    """A shed group answers OVERLOADED with the retry-after in waitMs;
    the port's and the JAX client decode it alike, and the breaker stays
    CLOSED (the wire round-tripped)."""
    server = _server("port", reactor)

    def shed(requests, budget=None):
        done = threading.Event()
        done.set()
        return done, {"shed_retry_after_ms": 40}

    server.batcher.submit_many = shed
    clients = [_client("port", server), _client("jax", server)]
    try:
        for c in clients:
            out = c.request_tokens_pipelined([(FLOW_ID, 1, False)] * 3)
            out.append(c.request_token(FLOW_ID, 1))
            assert [(int(r.status), r.wait_ms) for r in out] == \
                [(TokenResultStatus.OVERLOADED, 40)] * 4
            assert c.health_gate.snapshot()["state"] == "CLOSED"
    finally:
        for c in clients:
            c.stop()
        server.stop()


@pytest.mark.parametrize("reactor", [True, False])
def test_entry_exit_bridge_through_remote_entry(reactor):
    """``MSG_ENTRY`` runs the port engine's full slot chain for a remote
    caller: two passes with their entry ids, then a FLOW block with its
    reason. ``MSG_EXIT`` exits one (OK), the same id again is
    BAD_REQUEST, and the dropped connection exits the entry it held."""
    pctx.replace_context(None)
    pctx.bump_generation()  # retire a context pooled by an earlier engine
    eng = pst.SentinelEngine(capacity=64, device="cpu")
    eng.flow_rules.load_rules([PFlowRule(resource="bridged", count=2)])
    server = _server("port", reactor, engine=eng)
    entry = pcodec.encode_entry_request("bridged", "app-a", 1, 0, False)
    steps = [
        (MSG_ENTRY, entry, TokenResultStatus.OK, (1, 0)),
        (MSG_ENTRY, entry, TokenResultStatus.OK, (2, 0)),
        (MSG_ENTRY, entry, TokenResultStatus.BLOCKED, (0, 1)),
        (MSG_EXIT, pcodec.encode_exit_request(1, False),
         TokenResultStatus.OK, None),
        (MSG_EXIT, pcodec.encode_exit_request(1, False),
         TokenResultStatus.BAD_REQUEST, None),
    ]
    try:
        with socket.create_connection(
                ("127.0.0.1", server.bound_port), timeout=15) as sock:
            for xid, (kind, ent, status, body) in enumerate(steps, 1):
                sock.sendall(pcodec.encode_request(xid, kind, ent))
                _, (resp,) = _recv_frames(sock, 1)
                assert (resp.xid, resp.msg_type, resp.status) == (
                    xid, kind, status)
                if body is not None:
                    assert pcodec.decode_entry_response(resp.entity) == body
            assert eng.node_snapshot()["bridged"]["curThreadNum"] == 1
        deadline = time.monotonic() + 10
        while (eng.node_snapshot()["bridged"]["curThreadNum"]
               and time.monotonic() < deadline):
            time.sleep(0.02)
        snap = eng.node_snapshot()["bridged"]
        assert (snap["passQps"], snap["blockQps"], snap["curThreadNum"]) \
            == (2.0, 1.0, 0)
    finally:
        server.stop()
        eng.close()
        pctx.replace_context(None)


def test_engine_roles_build_services_on_the_engine_device():
    """An engine's embedded server (``set_to_server`` and the staged
    ``apply_mode``) runs its token service on the engine's device, and
    ``resilience_stats`` reports the server's overload and wire views."""
    from sentinel_tpu_torch.cluster import state as pstate

    pctx.replace_context(None)
    pctx.bump_generation()  # retire a context pooled by an earlier engine
    eng = pst.SentinelEngine(capacity=64, device="cpu")
    try:
        server = eng.cluster.set_to_server(host="127.0.0.1", port=0)
        assert server.service.device.type == "cpu"
        assert server.engine is eng
        stats = eng.resilience_stats()
        assert stats["clusterHA"]["roleName"] == "SERVER"
        assert stats["overload"]["queueLimitGroups"] == 512
        assert stats["wire"]["connections"] == 0
        eng.cluster.server_rules().load_rules("default", _rules(PFlowRule))
        eng.cluster.server_config["port"] = 0
        eng.cluster.apply_mode(pstate.CLUSTER_SERVER)
        svc = eng.cluster.token_server.service
        assert svc.device.type == "cpu" and svc.rules is \
            eng.cluster.server_rules()
        client = _client("port", eng.cluster.token_server)
        try:
            assert client.request_token(FLOW_ID, 1).status == 0
        finally:
            client.stop()
        eng.cluster.apply_mode(pstate.CLUSTER_NOT_STARTED)
        assert eng.resilience_stats()["overload"] is None
    finally:
        eng.close()
        pctx.replace_context(None)
