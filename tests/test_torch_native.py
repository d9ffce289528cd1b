"""The port's native token client (``sentinel_tpu_torch/native.py``, the C++
shim ``csrc/sentinel_shim.cpp`` built into ``sentinel_tpu_torch/_build/``)
on the CPU.

Every case of ``tests/test_native.py`` runs the port's shim against the
JAX package's token server and then against the port's (each on its own
frozen clock, the port's service on the CPU); the statuses, wait hints,
entry ids and block reasons the shim saw must be equal, and the
reference's own assertions then run on what it saw from the port's
server. The remote-entry cases run on both packages' default engines,
built once for the module (capacity 512, the lease fast path off).

Then the shim half of ``tests/test_tlv_fixtures.py`` (``:154``, ``:188``)
on the port's build against the golden frames, and the build itself: it
writes into the directory it is given and never into ``native/``, names
its file by a hash of the sources and flags, survives racing builds,
and fails loudly (``load_shim`` None with a reason, the client raising)
when no compiler works.
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import sentinel_tpu_torch.native as N
from sentinel_tpu_torch.cluster import codec as pcodec
from sentinel_tpu_torch.cluster.constants import TokenResultStatus as TS
from tests.test_torch_support import ops_pkgs, wait_for

NOW0 = 1_700_000_000_000
LEASE_KEY = "csp.sentinel.lease.enabled"
REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(N.load_shim() is None,
                                reason="no C++ compiler for the shim")


@pytest.fixture(scope="module")
def pkgs():
    """Both packages, their clocks frozen at one epoch for the module."""
    out = ops_pkgs()
    for P in out:
        P.tu.freeze_time(NOW0)
    yield out
    for P in out:
        P.tu.unfreeze_time()


@pytest.fixture()
def clocks(pkgs):
    """Both clocks at one whole second at least 100 s past the last case."""
    target = max(P.tu.current_time_millis() for P in pkgs)
    target = (target // 1000 + 100) * 1000
    for P in pkgs:
        P.tu.advance_time(target - P.tu.current_time_millis())
    return pkgs


def token_server(P, flow_id, count):
    """A token server of package ``P`` with one GLOBAL cluster flow rule."""
    rules = P.cluster_rules.ClusterFlowRuleManager()
    rules.load_rules("default", [P.flow.FlowRule(
        resource=f"native-{flow_id}", count=count, cluster_mode=True,
        cluster_config={"flowId": flow_id,
                        "thresholdType": P.CC.THRESHOLD_GLOBAL})])
    return P.server.ClusterTokenServer(
        P.ts.DefaultTokenService(rules, **P.kw), host="127.0.0.1",
        port=0).start()


def against_both(pkgs, flow_id, count, run):
    """``run(server)`` with the port's shim against the JAX package's
    server, then the port's; returns (jax_out, port_out)."""
    outs = []
    for P in pkgs:
        server = token_server(P, flow_id, count)
        try:
            outs.append(run(server))
        finally:
            server.stop()
    return tuple(outs)


def fields(r):
    return (int(r.status), r.remaining, r.wait_ms)


# -- tests/test_native.py, case by case ------------------------------------------

def test_native_client_acquires_tokens(clocks):
    def run(server):
        with N.NativeTokenClient("127.0.0.1", server.bound_port) as client:
            return [fields(client.request_token(4242)) for _ in range(5)]

    jax_out, port_out = against_both(clocks, 4242, 3, run)
    assert port_out == jax_out
    got = [s for s, _, _ in port_out]
    assert got.count(TS.OK) == 3 and got.count(TS.BLOCKED) == 2


def test_native_client_unknown_flow(clocks):
    def run(server):
        with N.NativeTokenClient("127.0.0.1", server.bound_port) as client:
            return fields(client.request_token(999))

    jax_out, port_out = against_both(clocks, 4242, 3, run)
    assert port_out == jax_out
    assert port_out[0] == TS.NO_RULE_EXISTS


def test_native_client_registers_namespace(clocks):
    def run(server):
        conns = server.service.connections
        with N.NativeTokenClient("127.0.0.1", server.bound_port, "nsZ"):
            wait_for(lambda: conns.connected_count("nsZ") == 1, 2.0)
            return conns.connected_count("nsZ")

    jax_out, port_out = against_both(clocks, 4242, 3, run)
    assert port_out == jax_out == 1


def test_native_connect_failure_raises():
    with pytest.raises((ConnectionError, RuntimeError)):
        N.NativeTokenClient("127.0.0.1", 1, timeout_ms=300)


def test_native_clock_reasonable():
    now = N.native_now_ms()
    assert now is not None
    assert abs(now - time.time() * 1000) < 5000


def test_native_param_token_acquire(clocks):
    """PARAM_FLOW through the shim: per-value buckets enforced."""
    def run(server):
        with N.NativeTokenClient("127.0.0.1", server.bound_port) as client:
            hot = [int(client.request_param_token(7100, 1, ["hotKey"]).status)
                   for _ in range(4)]
            cold = int(client.request_param_token(7100, 1, ["coldKey"])
                       .status)
            unknown = int(client.request_param_token(999, 1, ["x"]).status)
            return hot, cold, unknown

    jax_out, port_out = against_both(clocks, 7100, 2, run)
    assert port_out == jax_out
    hot, cold, unknown = port_out
    assert hot.count(TS.OK) == 2 and hot.count(TS.BLOCKED) == 2
    assert cold == TS.OK and unknown == TS.NO_RULE_EXISTS


def test_native_concurrent_acquires_one_handle(clocks):
    """8 threads share one handle; the xid demux routes every response to
    its caller (odd threads ask for an unknown flow)."""
    def run(server):
        results = [None] * 8
        with N.NativeTokenClient("127.0.0.1", server.bound_port) as client:
            barrier = threading.Barrier(8)

            def worker(tid):
                barrier.wait()
                results[tid] = int(client.request_token(
                    4242 if tid % 2 == 0 else 999).status)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return sorted(results[0::2]), results[1::2]

    jax_out, port_out = against_both(clocks, 4242, 3, run)
    assert port_out == jax_out
    evens, odds = port_out
    assert all(s == TS.NO_RULE_EXISTS for s in odds)
    assert evens.count(TS.OK) == 3 and evens.count(TS.BLOCKED) == 1


def test_native_batch_acquire(clocks):
    """``st_request_tokens_batch``: one pipelined burst, statuses in order."""
    def run(server):
        with N.NativeTokenClient("127.0.0.1", server.bound_port) as client:
            return [fields(r) for r in client.request_tokens_batch(
                [(4242, 1, False)] * 5 + [(999, 1, False)])]

    jax_out, port_out = against_both(clocks, 4242, 3, run)
    assert port_out == jax_out
    statuses = [s for s, _, _ in port_out]
    assert statuses[:5].count(TS.OK) == 3
    assert statuses[:5].count(TS.BLOCKED) == 2
    assert statuses[5] == TS.NO_RULE_EXISTS


def test_native_slow_response_does_not_brick_handle():
    """A per-call timeout fails that call only: the connection stays
    usable and the late reply is dropped by xid."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    port = sock.getsockname()[1]

    def serve():
        conn, _ = sock.accept()
        reader = pcodec.FrameReader()
        try:
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                for body in reader.feed(data):
                    req = pcodec.decode_request(body)
                    if req.msg_type == 0:  # PING
                        conn.sendall(pcodec.encode_response(req.xid, 0, 0))
                    elif req.xid == 2:  # the first acquire: answered late
                        def late(xid=req.xid):
                            time.sleep(0.6)
                            try:
                                conn.sendall(pcodec.encode_response(
                                    xid, 1, 0,
                                    pcodec.encode_flow_response(9, 0)))
                            except OSError:
                                pass
                        threading.Thread(target=late, daemon=True).start()
                    else:
                        conn.sendall(pcodec.encode_response(
                            req.xid, 1, 0, pcodec.encode_flow_response(5, 0)))
        except OSError:
            pass

    threading.Thread(target=serve, daemon=True).start()
    try:
        with N.NativeTokenClient("127.0.0.1", port, timeout_ms=200) as client:
            first = client.request_token(1)
            assert first.status == -1  # timed out, reported as such
            time.sleep(0.6)  # the stale xid-2 reply arrives and is dropped
            second = client.request_token(1)
            assert second.status == TS.OK
            assert second.remaining == 5  # xid-matched: not the stale one
    finally:
        sock.close()


# -- the remote slot-chain bridge ------------------------------------------------

@pytest.fixture(scope="module")
def bridge(pkgs):
    """Both packages' default engines (lease off) with a token server in
    engine mode each, for the module."""
    saved = [P.config.config.get(LEASE_KEY) for P in pkgs]
    servers = {}
    for P in pkgs:
        P.config.config.set(LEASE_KEY, "false")
        P.ctx.replace_context(None)
        P.ctx.bump_generation()
        eng = P.st.reset(capacity=512, **P.kw)
        servers[P.name] = P.server.ClusterTokenServer(
            host="127.0.0.1", port=0, engine=eng).start()
    yield servers
    for P, value in zip(pkgs, saved):
        servers[P.name].stop()
        P.ctx.replace_context(None)
        if value is None:
            P.config.config._config.pop(LEASE_KEY, None)
        else:
            P.config.config.set(LEASE_KEY, value)
    # The JAX default engine is left fresh; the port's is closed.
    pkgs[0].st.reset(capacity=512)
    pkgs[1].st._default_engine.close()


def on_bridges(clocks, bridge, rules, run):
    """``rules(P)`` loaded on each default engine, then ``run(client)``
    with the port's shim against that package's bridge server."""
    outs = []
    for P in clocks:
        eng = P.st._default_engine
        for mgr in (eng.flow_rules, eng.param_rules):
            mgr.load_rules([])
        rules(P)
        try:
            with N.NativeTokenClient("127.0.0.1",
                                     bridge[P.name].bound_port,
                                     timeout_ms=120_000) as client:
                outs.append(run(client))
        finally:
            for mgr in (eng.flow_rules, eng.param_rules):
                mgr.load_rules([])
            P.ctx.replace_context(None)
    return tuple(outs)


def test_native_remote_entry_exit(clocks, bridge):
    """Pass with an id, a typed block reason, the exit commit, and a
    consumed id answering BAD_REQUEST."""
    def run(client):
        outcomes = [client.remote_entry("shimRes", origin="jvm-app")
                    for _ in range(5)]
        ok = [e for s, e, _ in outcomes if s == TS.OK]
        exits = [client.remote_exit(e) for e in ok]
        again = client.remote_exit(ok[0]) if ok else None
        return ([(s, e > 0, r) for s, e, r in outcomes], exits, again)

    jax_out, port_out = on_bridges(clocks, bridge, lambda P: (
        P.st.load_flow_rules([P.st.FlowRule(resource="shimRes", count=2)])),
        run)
    assert port_out == jax_out
    outcomes, exits, again = port_out
    ok = [o for o in outcomes if o[0] == TS.OK]
    blocked = [o for o in outcomes if o[0] == TS.BLOCKED]
    assert len(ok) == 2 and len(blocked) == 3
    assert all(has_id for _, has_id, _ in ok)
    assert all(r == 1 for _, _, r in blocked)  # BlockReason.FLOW
    assert exits == [TS.OK, TS.OK]
    assert again == TS.BAD_REQUEST


def test_native_remote_entry_params(clocks, bridge):
    """Hot params ride the shim's ENTRY frame into the param checker."""
    def run(client):
        return [client.remote_entry("shimHot", params=["k1"])[::2]
                for _ in range(3)]

    jax_out, port_out = on_bridges(clocks, bridge, lambda P: (
        P.st.load_param_flow_rules([P.st.ParamFlowRule(
            "shimHot", param_idx=0, count=1)])), run)
    assert port_out == jax_out
    blocked = [r for s, r in port_out if s == TS.BLOCKED]
    assert len(blocked) >= 1
    assert all(r == 5 for r in blocked)  # BlockReason.PARAM_FLOW


def test_native_param_buckets_shared_with_python_client(clocks):
    """Typed wire params hash alike from the shim and the Python client,
    so both drain the same (flowId, value) bucket; 42 and "42" differ."""
    def run(server):
        P = ops_pkgs()[1]
        py = P.client.ClusterTokenClient("127.0.0.1",
                                         server.bound_port).start()
        out = []
        try:
            with N.NativeTokenClient("127.0.0.1", server.bound_port) as c:
                out += [c.request_param_token(7100, 1, [42]).status,
                        py.request_param_token(7100, 1, [42]).status,
                        c.request_param_token(7100, 1, [42]).status,
                        py.request_param_token(7100, 1, [42]).status,
                        c.request_param_token(7100, 1, ["42"]).status]
            with N.NativeTokenClient("127.0.0.1", server.bound_port) as c:
                out.append(c.request_param_token(7100, 1,
                                                 [True, 1.5, "u"]).status)
        finally:
            py.stop()
        return [int(s) for s in out]

    jax_out, port_out = against_both(clocks, 7100, 2, run)
    assert port_out == jax_out
    assert port_out == [TS.OK, TS.OK, TS.BLOCKED, TS.BLOCKED, TS.OK, TS.OK]


# -- the shim half of tests/test_tlv_fixtures.py -----------------------------------

def test_c_shim_speaks_golden_bytes():
    from tests.test_tlv_fixtures import _CaptureServer, _fx

    param_reply = bytearray(bytes.fromhex(
        _fx("param_response_blocked")["hex"]))
    param_reply[5] = 3  # xid 2 -> 3: the shim's third request here
    server = _CaptureServer(script=[
        bytes.fromhex(_fx("ping_response_ok")["hex"]),
        bytes.fromhex(_fx("flow_response_should_wait_350ms")["hex"]),
        bytes(param_reply),
    ])
    with N.NativeTokenClient("127.0.0.1", server.port, "default") as client:
        r1 = client.request_token(4242, count=1)
        assert r1.status == TS.SHOULD_WAIT and r1.wait_ms == 350
        r2 = client.request_param_token(7100, 1, [7, "user-1", True, 2.5])
        assert r2.status == TS.BLOCKED
    assert server.done.wait(3.0)
    ping, flow, param = server.frames
    assert ping == bytes.fromhex(_fx("ping_request_default")["hex"])[2:]
    assert flow == bytes.fromhex(_fx("flow_request_basic")["hex"])[2:]
    golden = bytearray(bytes.fromhex(
        _fx("param_request_every_type")["hex"])[2:])
    golden[3] = 3  # xid 2 -> 3
    assert param == bytes(golden)


def test_c_shim_entry_exit_golden_bytes():
    from tests.test_tlv_fixtures import _CaptureServer, _fx

    exit_reply = bytearray(bytes.fromhex(_fx("exit_response_ok")["hex"]))
    exit_reply[5] = 3  # xid 4 -> 3: the shim's third request here
    server = _CaptureServer(script=[
        bytes.fromhex(_fx("ping_response_ok")["hex"]),
        bytes.fromhex(_fx("entry_response_pass")["hex"]),
        bytes(exit_reply),
    ])
    with N.NativeTokenClient("127.0.0.1", server.port, "default") as client:
        status, entry_id, reason = client.remote_entry(
            "getUser", origin="appA", count=1, entry_type=0)
        assert status == TS.OK and (entry_id, reason) == (1, 0)
        assert client.remote_exit(1) == TS.OK
    assert server.done.wait(3.0)
    ping, entry, exit_ = server.frames
    assert ping == bytes.fromhex(_fx("ping_request_default")["hex"])[2:]
    assert entry == bytes.fromhex(_fx("entry_request_basic")["hex"])[2:]
    golden = bytearray(bytes.fromhex(_fx("exit_request_basic")["hex"])[2:])
    golden[3] = 3  # xid 4 -> 3
    assert exit_ == bytes(golden)


# -- the build ------------------------------------------------------------------

def _tree(path: Path):
    """{relative name: (size, mtime_ns, sha256)} of every file under
    ``path``."""
    return {str(p.relative_to(path)): (p.stat().st_size, p.stat().st_mtime_ns,
                                       hashlib.sha256(p.read_bytes())
                                       .hexdigest())
            for p in sorted(path.rglob("*")) if p.is_file()}


def test_racing_builds_write_one_library_and_leave_native_untouched(
        tmp_path, monkeypatch):
    """Three builds at once into an empty build directory: each returns
    the same file (named by the sources' and flags' hash), nothing is
    left half-written, the library binds, and ``native/`` (where the JAX
    package builds its own shim) is untouched."""
    before = _tree(REPO / "native")
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    with ThreadPoolExecutor(max_workers=3) as pool:
        paths = [f.result() for f in [pool.submit(N.build_shim)
                                      for _ in range(3)]]
    assert len(set(paths)) == 1
    out = paths[0]
    assert out.parent == tmp_path and out == N.shim_path()
    h = hashlib.sha256(" ".join(N.CXXFLAGS).encode() + b"\0")
    for src in N.SHIM_SOURCES:
        h.update(src.read_bytes())
    assert out.name == f"{N.SHIM_LIB}_{h.hexdigest()[:16]}.so"
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]
    import ctypes
    assert ctypes.CDLL(str(out)).st_now_ms() > 0
    assert _tree(REPO / "native") == before
    assert N.build_shim() == out  # built already: no second compile


def test_shim_sources_ship_with_the_port():
    for src in N.SHIM_SOURCES:
        assert src.parent == REPO / "sentinel_tpu_torch" / "csrc"
        assert src.is_file()
    assert "st_remote_entry" in N.SHIM_SOURCES[1].read_text()


def test_no_compiler_means_no_shim_and_a_raising_client(tmp_path,
                                                        monkeypatch):
    """With no working C++ compiler the shim is None with the reason,
    ``native_now_ms`` is None, and the client raises: nothing switches
    to the Python client."""
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "_shim", None)
    monkeypatch.setattr(N, "_shim_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    assert N.load_shim() is None
    assert "shim build failed" in N.shim_build_error()
    assert N.native_now_ms() is None
    with pytest.raises(RuntimeError, match="native shim unavailable"):
        N.NativeTokenClient("127.0.0.1", 1)
    assert list(tmp_path.iterdir()) == []
