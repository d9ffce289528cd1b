"""The port's hash-slice sharding (``cluster/sharding.py``, the token
service's shard hooks, the server's WRONG_SLICE replies and the
slice-filtered cluster checkpoints) against the JAX package's, on the
CPU: the reference's ``tests/test_shard.py`` scenarios on both packages.

Each scenario runs once per package on that package's frozen clock
(``freeze_time`` at the same instant) and returns what it observed: every
``TokenResult``'s status, remaining, wait and epoch, the fences, the
seats' counters and stats. The two observations must be equal, and the
reference's own assertions hold on the port. The WRONG_SLICE reply is
pinned byte for byte against the JAX package's server, on both
frontends. Leaders of the port run with ``device="cpu"``.

Left out until their modules are ported: the exporter's shard families
(``telemetry/exporter.py``). The reference's slow tests are slow here.
"""

from __future__ import annotations

import socket
import time
from collections import Counter

import pytest

from tests.test_torch_support import cluster_pkgs, tr_tuple

JAX, PORT = cluster_pkgs()
BOTH = (JAX, PORT)

NOW0 = 1_700_000_000_000
N = 8
FID_A, FID_B, FID_C = 9003, 9001, 9000   # slices 0, 4, 6 of the 8-ring
SL_A, SL_B, SL_C = 0, 4, 6


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _both(scenario, *args):
    """``scenario(P, *args)`` on each package's frozen clock; the two
    observations must be equal. Returns the port's."""
    got = {}
    for P in BOTH:
        P.tu.freeze_time(NOW0)
        try:
            got[P.name] = scenario(P, *args)
        finally:
            P.tu.unfreeze_time()
    assert got["port"] == got["jax"]
    return got["port"]


def _rules(P, *pairs):
    mgr = P.rules.ClusterFlowRuleManager()
    mgr.load_rules("default", [P.rule(fid, cnt) for fid, cnt in pairs])
    return mgr


def _owner_map(P, assign, version=1, epochs=None, servers=None,
               clients=("X",)):
    owner = [None] * N
    for mid, sls in assign.items():
        for sl in sls:
            owner[sl] = mid
    first = next(iter(assign))
    owner = [m if m is not None else first for m in owner]
    eps = [version] * N
    for sl, ep in (epochs or {}).items():
        eps[sl] = ep
    return P.sharding.ShardMap(
        version=version, n_slices=N, servers=tuple(servers),
        slice_owner=tuple(owner), slice_epoch=tuple(eps),
        clients=tuple(clients))


def _specs(P, mids, ports=None):
    return tuple(P.ha.ClusterServerSpec(m, "127.0.0.1",
                                        ports[i] if ports else _free_port())
                 for i, m in enumerate(mids))


def _seats(P, tmp_path, machine_ids, rule_pairs):
    base = str(tmp_path / f"{P.name}-shard.ck")
    out = {}
    for mid in machine_ids:
        state = P.state.ClusterStateManager(**P.kw)
        state.server_rules().load_rules(
            "default", [P.rule(fid, cnt) for fid, cnt in rule_pairs])
        out[mid] = P.ha.ClusterHAManager(
            state=state, machine_id=mid, checkpoint_path=base,
            checkpoint_period_s=3600.0, server_host="127.0.0.1", **P.kw)
    return out


# -- routing helper and fence (no sockets) -----------------------------------


def test_slice_of_pinned_and_stable():
    for P in BOTH:
        s = P.sharding.slice_of
        assert (s(6000, 64), s(6001, 64), s(123456789, 64)) == (30, 36, 48)
        assert [s(f, N) for f in (FID_A, FID_B, FID_C)] == [SL_A, SL_B, SL_C]
    pj, pp = JAX.sharding.slice_of, PORT.sharding.slice_of
    assert [pp(i, 64) for i in range(5000)] == [pj(i, 64) for i in range(5000)]
    counts = Counter(pp(i, N) for i in range(10_000))
    assert len(counts) == N and max(counts.values()) < 10_000 // N * 3
    # The population telescope attributes through the same helper.
    from sentinel_tpu_torch.telemetry import population

    assert population.slice_of is pp


def test_slice_epoch_fence_lanes_independent():
    def scenario(P):
        f = P.state.SliceEpochFence()
        seen = [f.observe(5, scope=3), f.observe(1, scope=7),
                f.observe(4, scope=3), f.observe(5, scope=3),
                f.observe(2, scope=None), f.observe(1, scope=None)]
        assert seen == [True, True, False, True, True, False]
        return seen, f.stale_rejected_count, f.highest_seen, f.snapshot()

    assert _both(scenario)[3] == {3: 5, 7: 1, None: 2}


# -- converter -------------------------------------------------------------------


def _map_json(owners, version=3, n=N, epochs=None):
    d = {"version": version, "nSlices": n,
         "servers": [{"machineId": "a", "host": "10.0.0.1", "port": 1871},
                     {"machineId": "b", "host": "10.0.0.2", "port": 1871}],
         "sliceOwners": owners, "clients": ["c1", "c2"]}
    if epochs is not None:
        d["sliceEpochs"] = epochs
    return d


def test_shard_map_converter_roundtrip():
    def scenario(P):
        C = P.conv
        m = C.shard_map_from_json(_map_json(
            {"a": [0, 1, 2, 3], "b": [4, 5, 6, 7]}, epochs={"4": 9}))
        assert m.slice_epoch == (3, 3, 3, 3, 9, 3, 3, 3)
        assert m.slices_of("b") == (4, 5, 6, 7)
        assert C.shard_map_from_json(C.shard_map_to_dict(m)) == m
        flat = C.shard_map_from_json(_map_json(list(m.slice_owner)))
        assert flat.slice_owner == m.slice_owner
        assert isinstance(C.any_cluster_map_from_json(
            _map_json({"a": list(range(8))})), P.sharding.ShardMap)
        cm = C.any_cluster_map_from_json(
            {"epoch": 1, "servers": [{"machineId": "a", "host": "h",
                                      "port": 1}], "leader": "a"})
        assert isinstance(cm, P.ha.ClusterMap)
        return (tuple(m), C.shard_map_to_dict(m), m.epochs_of("a"),
                tuple(cm), C.cluster_map_to_dict(cm))

    _both(scenario)


BAD_MAPS = {
    "gaps": {"sliceOwners": {"a": [0, 1], "b": [4, 5, 6, 7]}},
    "double": {"sliceOwners": {"a": [0, 0, 1, 2, 3], "b": [4, 5, 6, 7]}},
    "unknown-owner": {"sliceOwners": {"zz": list(range(8))}},
    "off-ring": {"sliceOwners": {"a": [0, 1, 2, 99], "b": [3, 4, 5, 6, 7]}},
    "short-list": {"sliceOwners": ["a"] * 7},
    "empty-ring": {"nSlices": 0},
    "bad-version": {"version": "x"},
    "no-servers": {"servers": []},
    "epoch-off-ring": {"sliceEpochs": {"99": 2}},
    "short-epochs": {"sliceEpochs": [1, 2]},
    "bare-clients": {"clients": "c1"},
}


@pytest.mark.parametrize("case", sorted(BAD_MAPS) + ["not-an-object"])
def test_shard_map_converter_rejects_malformed(case):
    good = _map_json({"a": [0, 1, 2, 3], "b": [4, 5, 6, 7]})
    d = [] if case == "not-an-object" else {**good, **BAD_MAPS[case]}
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError) as ex:
            P.conv.shard_map_from_json(d)
        msgs.append(str(ex.value))
    assert msgs[1] == msgs[0]


# -- server-side ownership -------------------------------------------------------


def test_service_wrong_slice_is_pre_device_and_quota_free():
    def scenario(P):
        svc = P.service(_rules(P, (FID_A, 4), (FID_C, 4)))
        svc.set_shard(P.sharding.ShardState(N, 7, {SL_A: 2}))
        out = [tr_tuple(svc.request_token(FID_C)) for _ in range(6)]
        assert out[0] == (int(P.CC.TokenResultStatus.WRONG_SLICE), 0, 7,
                          None)
        got = [tr_tuple(svc.request_token(FID_A)) for _ in range(5)]
        assert [g[0] for g in got] == [0] * 4 + [1] and \
            all(g[3] == 2 for g in got)
        # A batch mixing owned and out-of-slice lanes: only owned lanes
        # commit (the window after it is the same as without the others).
        batch = svc.request_tokens([(FID_C, 1, False), (FID_A, 1, True),
                                    (None, 0, False), (FID_C, 2, False)])
        out += got + [tr_tuple(r) for r in batch]
        out.append(tr_tuple(svc.request_param_token(FID_C, 1, ["k"])))
        out.append(tr_tuple(svc.request_param_token(FID_A, 1, ["k"])))
        snap = svc.shard_snapshot()
        assert snap["slicesOwned"] == 1 and snap["sliceEpochs"] == {"0": 2}
        return out, snap, svc.wrong_slice_count, svc.epoch, \
            svc.metrics_snapshot()

    assert _both(scenario)[2] == 9


def _wire_script(P):
    """Raw frames: owned, out-of-slice, out-of-slice param, owned param,
    an unknown flow and a ping."""
    c, CC = PORT.codec, PORT.CC
    return [
        c.encode_request(1, CC.MSG_FLOW, c.encode_flow_request(FID_A, 1,
                                                               False)),
        c.encode_request(2, CC.MSG_FLOW, c.encode_flow_request(FID_C, 1,
                                                               False)),
        c.encode_request(3, CC.MSG_PARAM_FLOW,
                         c.encode_param_flow_request(FID_C, 1, ["k"])),
        c.encode_request(4, CC.MSG_PARAM_FLOW,
                         c.encode_param_flow_request(FID_A, 1, ["k"])),
        c.encode_request(5, CC.MSG_FLOW, c.encode_flow_request(FID_B, 2,
                                                               True)),
        c.encode_request(6, CC.MSG_PING, c.encode_ping("default")),
    ]


def _recv(sock, n):
    reader = PORT.codec.FrameReader()
    raw, got = bytearray(), 0
    sock.settimeout(15)
    while got < n:
        data = sock.recv(65536)
        if not data:
            break
        raw.extend(data)
        got += len(reader.feed(data))
    return bytes(raw)


@pytest.mark.parametrize("reactor", [True, False])
def test_wrong_slice_reply_bytes_match_the_reference(reactor):
    """The sharded leader's replies on the raw wire — WRONG_SLICE with the
    map-version TLV and no epoch TLV, in-slice verdicts with their slice's
    epoch TLV — byte for byte as the JAX package's server writes them,
    on the reactor and on the thread-per-connection frontend."""
    def scenario(P):
        svc = P.service(_rules(P, (FID_A, 100), (FID_B, 100), (FID_C, 100)))
        svc.set_shard(P.sharding.ShardState(N, 5, {SL_A: 9, SL_B: 3}))
        server = P.server.ClusterTokenServer(
            svc, host="127.0.0.1", port=0, reactor=reactor).start()
        try:
            script = _wire_script(P)
            with socket.create_connection(
                    ("127.0.0.1", server.bound_port), timeout=15) as sock:
                sock.sendall(b"".join(script))
                return _recv(sock, len(script))
        finally:
            server.stop()

    raw = _both(scenario)
    frames = PORT.codec.FrameReader().feed(raw)
    statuses = [PORT.codec.decode_response(b).status for b in frames]
    assert PORT.CC.TokenResultStatus.WRONG_SLICE in statuses


def test_wrong_slice_wire_roundtrip_and_fence_hygiene():
    def scenario(P):
        svc = P.service(_rules(P, (FID_A, 100), (FID_C, 100)))
        svc.set_shard(P.sharding.ShardState(N, 5, {SL_A: 9}))
        server = P.server.ClusterTokenServer(svc, host="127.0.0.1",
                                             port=0).start()
        fence = P.state.SliceEpochFence()
        cli = P.client.ClusterTokenClient(
            "127.0.0.1", server.bound_port, request_timeout_s=10.0,
            epoch_fence=fence,
            fence_scope_fn=lambda fid: P.sharding.slice_of(int(fid), N)
        ).start()
        try:
            assert _wait(cli.is_connected)
            out = [tr_tuple(cli.request_token(FID_C)), fence.snapshot()]
            out += [tr_tuple(cli.request_token(FID_A)), fence.snapshot()]
            out.append(tr_tuple(cli.request_param_token(FID_C, 1, ["k"])))
            assert out[1] == {} and out[3] == {SL_A: 9}
            return out
        finally:
            cli.stop()
            server.stop()

    _both(scenario)


def test_stale_slice_epoch_rejected_per_lane():
    def scenario(P):
        svc = P.service(_rules(P, (FID_A, 100), (FID_C, 100)))
        svc.set_shard(P.sharding.ShardState(N, 1, {SL_A: 2, SL_C: 1}))
        server = P.server.ClusterTokenServer(svc, host="127.0.0.1",
                                             port=0).start()
        fence = P.state.SliceEpochFence()
        fence.observe(3, SL_A)
        cli = P.client.ClusterTokenClient(
            "127.0.0.1", server.bound_port, request_timeout_s=10.0,
            epoch_fence=fence,
            fence_scope_fn=lambda fid: P.sharding.slice_of(int(fid), N)
        ).start()
        try:
            assert _wait(cli.is_connected)
            a = tr_tuple(cli.request_token(FID_A))
            c = tr_tuple(cli.request_token(FID_C))
            assert a[0] == int(P.CC.TokenResultStatus.FAIL) and c[0] == 0
            return a, c, fence.stale_rejected_count, fence.snapshot()
        finally:
            cli.stop()
            server.stop()

    _both(scenario)


# -- the sharded client ----------------------------------------------------------


def _two_leader_wire(P, counts=((FID_A, 1000), (FID_B, 1000), (FID_C, 1000)),
                     a_slices=(SL_A,), version=1):
    servers, specs = [], []
    for mid in ("A", "B"):
        owned = set(a_slices) if mid == "A" \
            else set(range(N)) - set(a_slices)
        svc = P.service(_rules(P, *counts), max_allowed_qps=1e9)
        svc.set_shard(P.sharding.ShardState(N, version,
                                            {s: version for s in owned}))
        srv = P.server.ClusterTokenServer(svc, host="127.0.0.1",
                                          port=0).start()
        servers.append(srv)
        specs.append(P.ha.ClusterServerSpec(mid, "127.0.0.1",
                                            srv.bound_port))
    return servers, specs


def _wrong(servers):
    return [s.service.wrong_slice_count for s in servers]


def _stats(cli):
    """failover_stats without the wall-clock and port-bearing fields."""
    s = dict(cli.failover_stats())
    s.pop("targets", None)
    s.pop("activeTarget", None)
    shard = dict(s.get("shard", {}))
    shard["leaders"] = {m: {k: v for k, v in row.items() if k != "target"}
                        for m, row in shard.get("leaders", {}).items()}
    s["shard"] = shard
    return s


def test_sharded_client_routes_by_slice_and_pipelines():
    def scenario(P):
        servers, specs = _two_leader_wire(P)
        smap = _owner_map(P, {"A": [SL_A],
                              "B": [s for s in range(N) if s != SL_A]},
                          servers=specs)
        cli = P.sharding.ShardedTokenClient(smap,
                                            request_timeout_s=10.0).start()
        try:
            assert _wait(cli.is_connected)
            out = [tr_tuple(cli.request_token(f))
                   for f in (FID_A, FID_B, FID_C)]
            out += [tr_tuple(r) for r in cli.request_tokens_pipelined(
                [(FID_A, 1, False), (FID_B, 1, False), (FID_C, 1, False),
                 (FID_A, 1, False), ("x", 1, False)])]
            assert _wrong(servers) == [0, 0]
            return out, _stats(cli)
        finally:
            cli.stop()
            for s in servers:
                s.stop()

    out, _ = _both(scenario)
    assert [o[0] for o in out[:7]] == [0] * 7


def test_sharded_client_self_heals_on_stale_map():
    def scenario(P):
        servers, specs = _two_leader_wire(P)
        stale = _owner_map(P, {"A": list(range(N))}, servers=specs)
        cli = P.sharding.ShardedTokenClient(stale,
                                            request_timeout_s=10.0).start()
        try:
            assert _wait(cli.is_connected)
            out = [tr_tuple(cli.request_token(f))
                   for f in (FID_A, FID_B, FID_C)]
            s1 = _stats(cli)
            assert s1["shard"]["wrongSliceRejected"] == 2
            assert s1["shard"]["learnedOverrides"] == 2
            out += [tr_tuple(cli.request_token(f))
                    for f in (FID_A, FID_B, FID_C)]
            return out, s1, _stats(cli), _wrong(servers)
        finally:
            cli.stop()
            for s in servers:
                s.stop()

    assert _both(scenario)[2]["shard"]["wrongSliceRejected"] == 2


def test_per_slice_failover_only_victim_slices_degrade():
    def scenario(P):
        TS = P.CC.TokenResultStatus
        servers, specs = _two_leader_wire(P)
        smap = _owner_map(P, {"A": [SL_A],
                              "B": [s for s in range(N) if s != SL_A]},
                          servers=specs)
        cli = P.sharding.ShardedTokenClient(
            smap, request_timeout_s=0.3, failover_deadline_ms=400,
            degraded=P.ha.DegradedQuota(
                divisor=2, thresholds={FID_B: (8.0, 1000)})).start()
        try:
            assert _wait(cli.is_connected)
            out = [tr_tuple(cli.request_token(FID_A)),
                   tr_tuple(cli.request_token(FID_B))]
            servers[1].stop()
            assert _wait(lambda: not cli._pool["B"].is_connected())
            out.append(tr_tuple(cli.request_token(FID_B)))
            P.tu.advance_time(500)
            out += [tr_tuple(cli.request_token(FID_B)) for _ in range(5)]
            out.append(tr_tuple(cli.request_token(FID_A)))
            s = _stats(cli)
            assert s["shard"]["degradedSlices"] == N - 1
            assert [o[0] for o in out[2:8]] == [int(TS.FAIL)] + [0] * 4 + [1]
            svc = P.service(_rules(P, (FID_B, 1000)), max_allowed_qps=1e9)
            svc.set_shard(P.sharding.ShardState(
                N, 1, {s: 1 for s in range(N) if s != SL_A}))
            revived = P.server.ClusterTokenServer(
                svc, host="127.0.0.1", port=specs[1].port).start()
            try:
                assert _wait(lambda: cli._pool["B"].is_connected(), 10.0)
                assert _wait(lambda: cli.request_token(FID_B).status
                             == TS.OK, 10.0)
                healed = _stats(cli)["shard"]["degradedSlices"]
            finally:
                revived.stop()
            return out, s["shard"]["leaders"], s["degradedQuota"], healed
        finally:
            cli.stop()
            for srv in servers:
                srv.stop()

    assert _both(scenario)[3] == 0


class _StatusStub:
    def __init__(self, P, status, wait_ms=0, connected=True):
        self._result = P.ts.TokenResult(status, wait_ms=wait_ms)
        self._connected = connected
        self.calls = 0

    def is_connected(self):
        return self._connected

    def request_token(self, *a, **k):
        self.calls += 1
        return self._result

    def request_param_token(self, *a, **k):
        return self.request_token()

    def stop(self):
        pass


def test_survivor_overload_does_not_mask_victim_failover():
    def scenario(P):
        TS = P.CC.TokenResultStatus
        specs = _specs(P, ("A", "B"))
        smap = _owner_map(P, {"A": [SL_A],
                              "B": [s for s in range(N) if s != SL_A]},
                          servers=specs)
        cli = P.sharding.ShardedTokenClient(
            smap, request_timeout_s=0.3, failover_deadline_ms=400,
            degraded=P.ha.DegradedQuota(divisor=2,
                                        thresholds={FID_B: (8.0, 1000)}),
            health_gate=None)
        try:
            shedding = _StatusStub(P, TS.OVERLOADED, wait_ms=50)
            cli._pool = {"A": shedding,
                         "B": _StatusStub(P, TS.FAIL, connected=False)}
            out = [tr_tuple(cli.request_token(FID_B))]
            P.tu.advance_time(500)
            out += [tr_tuple(cli.request_token(FID_B)) for _ in range(5)]
            s1 = _stats(cli)["shard"]["leaders"]
            P.tu.advance_time(300)
            cli._pool["B"] = _StatusStub(P, TS.OVERLOADED, wait_ms=50)
            out.append(tr_tuple(cli.request_token(FID_B)))
            s2 = _stats(cli)
            assert s1["B"]["degraded"] is True
            assert s2["shard"]["leaders"]["B"]["degraded"] is False
            return out, s1, s2, shedding.calls
        finally:
            cli.stop()

    out = _both(scenario)[0]
    assert [o[0] for o in out] == [int(PORT.CC.TokenResultStatus.OVERLOADED)] \
        + [0] * 4 + [1] + [int(PORT.CC.TokenResultStatus.OVERLOADED)]


def test_map_change_reuses_live_sockets():
    def scenario(P):
        servers, specs = _two_leader_wire(P)
        m1 = _owner_map(P, {"A": [SL_A],
                            "B": [s for s in range(N) if s != SL_A]},
                        servers=specs)
        cli = P.sharding.ShardedTokenClient(m1,
                                            request_timeout_s=10.0).start()
        try:
            assert _wait(cli.is_connected)
            inner_a, inner_b = cli._pool["A"], cli._pool["B"]
            out = [tr_tuple(cli.request_token(FID_A))]
            moved = [s for s in range(N) if s not in (SL_A, SL_B)]
            m2 = _owner_map(P, {"A": [SL_A, SL_B], "B": moved}, version=2,
                            servers=specs)
            out += [cli.apply_map(m2), cli._pool["A"] is inner_a,
                    cli._pool["B"] is inner_b, cli.socket_reuse_count,
                    cli.map.version, cli.apply_map(m1),
                    cli.apply_map(m2._replace(version=3, n_slices=N * 2))]
            specs2 = (specs[0],
                      P.ha.ClusterServerSpec("B", "127.0.0.1", _free_port()))
            m3 = _owner_map(P, {"A": [SL_A, SL_B], "B": moved}, version=3,
                            servers=specs2)
            out += [cli.apply_map(m3), cli._pool["A"] is inner_a,
                    cli._pool["B"] is not inner_b, cli.fence.snapshot()]
            return out
        finally:
            cli.stop()
            for s in servers:
                s.stop()

    out = _both(scenario)
    assert out[1:9] == [True, True, True, 2, 2, False, False, True]


# -- slice-filtered checkpoints and handoffs ---------------------------------------


def test_checkpoint_slice_filter_roundtrip(tmp_path):
    def scenario(P):
        path = str(tmp_path / f"{P.name}-slice.ck")
        pairs = ((FID_A, 10), (FID_B, 10), (FID_C, 10))
        svc = P.service(_rules(P, *pairs))
        out = [tr_tuple(svc.request_token(FID_A)) for _ in range(3)]
        out += [tr_tuple(svc.request_token(FID_C)) for _ in range(5)]
        P.ckpt.save_cluster_checkpoint(svc, path, slices=(SL_A,),
                                       n_slices=N, epoch=4)
        header, arrays = P.ckpt._load_npz(path)
        assert set(header["flows"]) == {str(FID_A)}
        svc2 = P.service(_rules(P, *pairs))
        out.append(P.ckpt.restore_cluster_checkpoint(
            svc2, path, slices=(SL_C,), n_slices=N))
        out.append(P.ckpt.restore_cluster_checkpoint(
            svc2, path, slices=(SL_A,), n_slices=N))
        out += [tr_tuple(svc2.request_token(FID_A)) for _ in range(8)]
        out.append(tr_tuple(svc2.request_token(FID_C)))
        with pytest.raises(ValueError):
            P.ckpt.save_cluster_checkpoint(svc, path, slices=(SL_A,))
        return out, header, {k: v.tolist() for k, v in arrays.items()}

    out = _both(scenario)[0]
    assert out[8:10] == [0, 1]
    assert [o[0] for o in out[10:18]].count(0) == 7


def test_handoff_preserves_quota_bound(tmp_path):
    def scenario(P):
        seats = _seats(P, tmp_path, ("A", "B"), [(FID_A, 6), (FID_C, 6)])
        specs = _specs(P, ("A", "B"))
        m1 = _owner_map(P, {"A": [SL_A],
                            "B": [s for s in range(N) if s != SL_A]},
                        servers=specs)
        try:
            seats["A"].apply_map(m1)
            seats["B"].apply_map(m1)
            svc_a = seats["A"].state.token_server.service
            svc_b = seats["B"].state.token_server.service
            out = [tr_tuple(svc_a.request_token(FID_A)) for _ in range(4)]
            m2 = _owner_map(P, {"B": list(range(N))}, version=2,
                            epochs={**{s: 1 for s in range(N)}, SL_A: 2},
                            servers=specs)
            seats["A"].apply_map(m2)
            assert seats["A"].state.mode == P.state.CLUSTER_CLIENT
            assert svc_a.shard.epochs == {SL_A: 1}
            seats["B"].apply_map(m2)
            out += [tr_tuple(svc_b.request_token(FID_A)) for _ in range(4)]
            out.append(tr_tuple(svc_b.request_token(FID_C)))
            return out, seats["A"].stats(), seats["B"].stats()
        finally:
            seats["A"].stop()
            seats["B"].stop()

    out, _a, b = _both(scenario)
    assert [o[0] for o in out[4:8]] == [0, 0, 1, 1]
    assert all(o[3] == 2 for o in out[4:8]) and out[8][3] == 1
    assert b["rowsRestored"] >= 1 and b["handoffs"] >= 1


def test_flat_leader_first_shard_map_publishes_whole_ring(tmp_path):
    def scenario(P):
        seats = _seats(P, tmp_path, ("A", "B"), [(FID_A, 6), (FID_B, 6)])
        specs = _specs(P, ("A", "B"))
        flat = P.ha.ClusterMap(epoch=3, servers=_specs(P, ("A",)),
                               clients=("X",))
        try:
            seats["A"].apply_map(flat)
            svc_flat = seats["A"].state.token_server.service
            out = [tr_tuple(svc_flat.request_token(FID_A))
                   for _ in range(4)]
            out += [tr_tuple(svc_flat.request_token(FID_B))
                    for _ in range(3)]
            m = _owner_map(P, {"A": [SL_A],
                               "B": [s for s in range(N) if s != SL_A]},
                           version=4, servers=specs)
            seats["A"].apply_map(m)
            seats["B"].apply_map(m)
            svc_a = seats["A"].state.token_server.service
            svc_b = seats["B"].state.token_server.service
            assert svc_a is not svc_flat and svc_a.shard is not None
            out += [tr_tuple(svc_a.request_token(FID_A)) for _ in range(3)]
            out += [tr_tuple(svc_b.request_token(FID_B)) for _ in range(4)]
            return out, seats["A"].stats(), seats["B"].stats()
        finally:
            seats["A"].stop()
            seats["B"].stop()

    out = _both(scenario)[0]
    assert [o[0] for o in out[7:]] == [0, 0, 1, 0, 0, 0, 1]


# -- chaos seams -----------------------------------------------------------------


def test_handoff_stall_widens_margin_but_stays_bounded(tmp_path):
    def scenario(P):
        seats = _seats(P, tmp_path, ("A", "B"), [(FID_A, 5)])
        specs = _specs(P, ("A", "B"))
        m1 = _owner_map(P, {"A": [SL_A],
                            "B": [s for s in range(N) if s != SL_A]},
                        servers=specs)
        with P.resilience.FaultInjector(seed=4242) as inj:
            inj.arm("cluster.shard.handoff.stall", "delay", delay_ms=50,
                    times=64)
            try:
                seats["A"].apply_map(m1)
                seats["B"].apply_map(m1)
                svc_a = seats["A"].state.token_server.service
                out = [tr_tuple(svc_a.request_token(FID_A))
                       for _ in range(3)]
                m2 = _owner_map(P, {"B": list(range(N))}, version=2,
                                epochs={**{s: 1 for s in range(N)},
                                        SL_A: 2}, servers=specs)
                t0 = time.monotonic()
                seats["A"].apply_map(m2)
                assert time.monotonic() - t0 >= 0.05
                seats["B"].apply_map(m2)
                svc_b = seats["B"].state.token_server.service
                out += [tr_tuple(svc_b.request_token(FID_A))
                        for _ in range(3)]
                return out, seats["B"].stats()
            finally:
                seats["A"].stop()
                seats["B"].stop()

    out = _both(scenario)[0]
    assert [o[0] for o in out[3:]] == [0, 0, 1]


def test_map_split_seat_sits_out_push(tmp_path):
    def scenario(P):
        seats = _seats(P, tmp_path, ("A",), [(FID_A, 5)])
        specs = _specs(P, ("A",))
        m1 = _owner_map(P, {"A": list(range(N))}, servers=specs)
        try:
            seats["A"].apply_map(m1)
            with P.resilience.FaultInjector(seed=4242) as inj:
                inj.arm("cluster.shard.map.split", "error", times=1)
                m2 = _owner_map(P, {"A": list(range(N))}, version=2,
                                servers=specs)
                seats["A"].apply_map(m2)
                seen = [seats["A"].shard_map.version,
                        seats["A"].stats()["shardMapVersion"]]
                seats["A"].apply_map(m2)
            seen.append(seats["A"].shard_map.version)
            assert seen == [1, 1, 2]
            return seen
        finally:
            seats["A"].stop()

    _both(scenario)


def test_donor_zombie_late_replies_fence_rejected(tmp_path):
    def scenario(P):
        seats = _seats(P, tmp_path, ("A", "B"), [(FID_A, 100)])
        specs = _specs(P, ("A", "B"))
        m1 = _owner_map(P, {"A": [SL_A],
                            "B": [s for s in range(N) if s != SL_A]},
                        servers=specs)
        try:
            seats["A"].apply_map(m1)
            seats["B"].apply_map(m1)
            m2 = _owner_map(P, {"B": list(range(N))}, version=2,
                            epochs={**{s: 1 for s in range(N)}, SL_A: 2},
                            servers=specs)
            with P.resilience.FaultInjector(seed=4242) as inj:
                inj.arm("cluster.shard.donor.zombie", "error", times=1)
                seats["A"].apply_map(m2)
            assert seats["A"].shard_map.version == 1
            assert seats["A"].state.mode == P.state.CLUSTER_SERVER
            seats["B"].apply_map(m2)
            fence = P.state.SliceEpochFence()
            for sl, ep in enumerate(m2.slice_epoch):
                fence.observe(ep, sl)
            cli = P.client.ClusterTokenClient(
                "127.0.0.1", specs[0].port, request_timeout_s=10.0,
                epoch_fence=fence,
                fence_scope_fn=lambda fid: P.sharding.slice_of(int(fid), N)
            ).start()
            try:
                assert _wait(cli.is_connected)
                r = tr_tuple(cli.request_token(FID_A))
                assert r[0] == int(P.CC.TokenResultStatus.FAIL)
                return r, fence.stale_rejected_count, \
                    seats["A"].state.token_server.service.shard.epochs
            finally:
                cli.stop()
        finally:
            seats["A"].stop()
            seats["B"].stop()

    assert _both(scenario)[1] == 1


# -- engine ------------------------------------------------------------------------


class _WrongSliceStub:
    serves_degraded = False

    def __init__(self, P):
        self.P = P
        self.calls = 0

    def is_connected(self):
        return True

    def request_token(self, *a, **k):
        self.calls += 1
        return self.P.ts.TokenResult(
            self.P.CC.TokenResultStatus.WRONG_SLICE, wait_ms=9)

    def request_param_token(self, *a, **k):
        return self.request_token()

    def stop(self):
        pass


def _engine_wrong_slice(P):
    """An un-healed WRONG_SLICE reaching the engine degrades the rule to
    its local check, counted on its own."""
    if P is JAX:
        from sentinel_tpu.core.context import replace_context
        from sentinel_tpu.core.engine import SentinelEngine

        replace_context(None)
        eng = SentinelEngine(capacity=64, journal_path="")
        blocked_exc = JAX.root.BlockException
    else:
        from sentinel_tpu_torch.core.context import (
            bump_generation,
            replace_context,
        )
        from sentinel_tpu_torch.core.engine import SentinelEngine

        replace_context(None)
        bump_generation()
        eng = SentinelEngine(capacity=64, device="cpu")
        blocked_exc = PORT.root.BlockException
    try:
        eng.flow_rules.load_rules([P.flow.FlowRule(
            resource="shard-res", count=3, cluster_mode=True,
            cluster_config={"flowId": 4242,
                            "thresholdType": P.CC.THRESHOLD_GLOBAL,
                            "fallbackToLocalWhenFail": True})])
        stub = _WrongSliceStub(P)
        eng.cluster.token_client = stub
        eng.cluster.mode = P.state.CLUSTER_CLIENT
        verdicts = []
        for _ in range(5):
            try:
                eng.entry("shard-res").exit()
                verdicts.append("pass")
            except blocked_exc:
                verdicts.append("block")
        rs = eng.resilience_stats()
        eng.cluster.token_client = None
        eng.cluster.mode = -1
        return (verdicts, stub.calls, rs["clusterWrongSliceCount"],
                rs["clusterFallbackCount"])
    finally:
        eng.close()
        replace_context(None)


@pytest.mark.slow
def test_engine_wrong_slice_degrades_to_local_check():
    got = _both(_engine_wrong_slice)
    assert got[0] == ["pass"] * 3 + ["block"] * 2 and got[1:3] == (5, 5)


def test_shard_stats_reach_ha_stats():
    def scenario(P):
        state = P.state.ClusterStateManager(**P.kw)
        state.server_rules().load_rules("default", [P.rule(FID_A, 50)])
        svc = P.service(state.server_rules())
        shard = P.sharding.ShardState(N, 3, {SL_A: 4, SL_B: 2})
        svc.set_shard(shard)
        state.set_to_server(host="127.0.0.1", port=0, service=svc, epoch=4)
        svc.set_shard(shard)
        try:
            r = tr_tuple(svc.request_token(FID_C))
            ha = state.ha_stats()
            assert ha["shard"]["slicesOwned"] == 2
            assert state.shard_stats() == ha["shard"]
            return r, ha["shard"], ha["epoch"]
        finally:
            state.stop()

    assert _both(scenario)[1]["wrongSliceRejected"] == 1


# -- the three-leader drill ----------------------------------------------------------


def _three_leader_cluster(P, tmp_path, T=6):
    pairs = [(FID_A, T), (FID_B, T), (FID_C, T)]
    seats = _seats(P, tmp_path, ("A", "B", "C"), pairs)
    specs = _specs(P, ("A", "B", "C"))
    rest = [s for s in range(N) if s not in (SL_A, SL_B, SL_C)]
    m1 = _owner_map(P, {"A": [SL_A], "B": [SL_B], "C": [SL_C] + rest},
                    servers=specs)
    for seat in seats.values():
        seat.apply_map(m1)
        svc = seat.state.token_server.service
        for w in (1, 2, 3, 4):
            svc.request_tokens([(None, 0, False)] * w)
    cli = P.sharding.ShardedTokenClient(
        m1, request_timeout_s=2.0, failover_deadline_ms=400,
        health_gate=None,
        degraded=P.ha.DegradedQuota(
            divisor=1, thresholds={fid: (float(T), 1000)
                                   for fid, _ in pairs})).start()
    return seats, specs, m1, cli


def test_three_leader_crash_drill_scaled(tmp_path):
    """Kill one of three leaders mid-traffic: only its slices degrade,
    and they recover through a checkpoint-grafted handoff with
    over-admission equal to the grants since the victim's last publish."""
    def scenario(P):
        T = 6
        seats, specs, m1, cli = _three_leader_cluster(P, tmp_path, T)
        try:
            assert _wait(lambda: all(c.is_connected()
                                     for c in cli._pool.values()))
            out = []
            for _ in range(2):
                out += [tr_tuple(cli.request_token(FID_A)),
                        tr_tuple(cli.request_token(FID_B))]
            out += [tr_tuple(cli.request_token(FID_C)) for _ in range(3)]
            seats["C"].publish_checkpoint()
            out.append(tr_tuple(cli.request_token(FID_C)))
            seats["C"].state.token_server._fault_crash()
            assert _wait(lambda: not cli._pool["C"].is_connected())
            out += [tr_tuple(cli.request_token(FID_A)),
                    tr_tuple(cli.request_token(FID_B)),
                    tr_tuple(cli.request_token(FID_C))]
            P.tu.advance_time(500)
            out.append(tr_tuple(cli.request_token(FID_C)))
            degraded = _stats(cli)["shard"]
            moved = m1.slices_of("C")
            m2 = _owner_map(
                P, {"A": [SL_A], "B": [s for s in range(N) if s != SL_A]},
                version=2,
                epochs={**{s: 1 for s in range(N)},
                        **{s: 2 for s in moved}}, servers=specs)
            seats["A"].apply_map(m2)
            seats["B"].apply_map(m2)
            assert cli.apply_map(m2)
            P.tu.advance_time(100)
            post = [tr_tuple(cli.request_token(FID_C)) for _ in range(4)]
            out += post
            assert [p[0] for p in post] == [0, 0, 0, 1]
            healed = _stats(cli)["shard"]["degradedSlices"]
            out += [tr_tuple(cli.request_token(f))
                    for f in (FID_A, FID_B, FID_C)]
            return (out, degraded, healed, seats["B"].stats(),
                    cli.fence.snapshot(), cli.fence.stale_rejected_count)
        finally:
            cli.stop()
            for seat in seats.values():
                seat.stop()

    got = _both(scenario)
    assert got[1]["degradedSlices"] == 6 and got[2] == 0
    assert got[3]["rowsRestored"] >= 1 and got[5] == 0


@pytest.mark.slow
def test_three_leader_multi_spell_drill(tmp_path):
    """Two successive victim crashes with rebalances between them and
    concurrent traffic on the never-killed leader's slice: it serves a
    wire verdict through both spells, and no fence rejects anything. The
    hammer's timing makes the verdict order run-dependent, so this drill
    holds the port to the reference's assertions alone."""
    import threading

    P = PORT
    TS = P.CC.TokenResultStatus
    P.tu.freeze_time(NOW0)
    seats, specs, m1, cli = _three_leader_cluster(P, tmp_path, T=50)
    stop = threading.Event()
    survivor_fail = []

    def hammer():
        while not stop.is_set():
            r = cli.request_token(FID_A)
            if r.status not in (TS.OK, TS.BLOCKED):
                survivor_fail.append(int(r.status))
            time.sleep(0.01)

    t = threading.Thread(target=hammer, daemon=True)
    try:
        assert _wait(lambda: all(c.is_connected()
                                 for c in cli._pool.values()))
        t.start()
        for _ in range(5):
            assert cli.request_token(FID_C).status == TS.OK
        seats["C"].publish_checkpoint()
        seats["C"].state.token_server._fault_crash()
        assert _wait(lambda: not cli._pool["C"].is_connected())
        cli.request_token(FID_C)
        P.tu.advance_time(500)
        assert cli.request_token(FID_C).status == TS.OK
        moved = m1.slices_of("C")
        m2 = _owner_map(P, {"A": [SL_A],
                            "B": [s for s in range(N) if s != SL_A]},
                        version=2,
                        epochs={**{s: 1 for s in range(N)},
                                **{s: 2 for s in moved}}, servers=specs)
        seats["A"].apply_map(m2)
        seats["B"].apply_map(m2)
        assert cli.apply_map(m2)
        assert _wait(lambda: cli.request_token(FID_C).status == TS.OK, 10.0)
        seats["B"].publish_checkpoint()
        seats["B"].state.token_server._fault_crash()
        assert _wait(lambda: not cli._pool["B"].is_connected())
        cli.request_token(FID_B)
        P.tu.advance_time(500)
        assert cli.request_token(FID_B).status in (TS.OK, TS.BLOCKED)
        assert cli.request_token(FID_A).status == TS.OK
        m3 = _owner_map(P, {"A": list(range(N))}, version=3,
                        epochs={**{s: 3 for s in range(N)}, SL_A: 1},
                        servers=specs)
        seats["A"].apply_map(m3)
        assert cli.apply_map(m3)
        assert _wait(lambda: cli.request_token(FID_B).status
                     in (TS.OK, TS.BLOCKED), 10.0)
        stop.set()
        t.join(timeout=5)
        assert survivor_fail == []
        assert cli.fence.stale_rejected_count == 0
    finally:
        stop.set()
        cli.stop()
        for seat in seats.values():
            seat.stop()
        P.tu.unfreeze_time()
