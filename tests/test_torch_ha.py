"""The port's cluster HA (``cluster/ha.py``, the cluster checkpoints of
``core/checkpoint.py`` and the ``ClusterStateManager.ha`` hook) against
the JAX package's, on the CPU: the reference's ``tests/test_cluster_ha.py``
scenarios on both packages.

Each scenario runs once per package on that package's frozen clock and
returns what it observed — every ``TokenResult``'s status, remaining, wait
and epoch, the seats' modes, epochs and counters, the journal's records —
and the two observations must be equal. The cluster checkpoint file is the
JAX package's ``.npz``: each package's file restores into the other's
service bit for bit (whole and slice-filtered), and a deposed epoch's save
is refused across packages too. The port's leaders run with
``device="cpu"``; without a card and without a device the HA manager, the
chaos mesh and campaign and a leader's token service raise.

The standalone participant (``cluster/__main__.py``) is held in
``tests/test_torch_cluster_main.py``. Left out until their modules are
ported: the exporter's HA families, the
``getClusterMode`` command and the heartbeat drills (``transport/``,
``telemetry/exporter.py``, item 9).
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from tests.test_torch_support import cluster_pkgs, strip_keys, tr_tuple

JAX, PORT = cluster_pkgs()
BOTH = (JAX, PORT)

NOW0 = 1_700_000_000_000


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


def _ok_with_retry(P, request, timeout_s: float = 15.0):
    t0 = time.monotonic()
    r = request()
    while r.status != P.CC.TokenResultStatus.OK \
            and time.monotonic() - t0 < timeout_s:
        time.sleep(0.05)
        r = request()
    return r


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


class _Host:
    """The engine stand-in an HA seat journals through (the chaos mesh's
    ``_SeatHost``): a journal on the package's frozen clock."""

    def __init__(self, P, thresholds_fn):
        self.journal = P.journal.ControlPlaneJournal(
            P.tu.current_time_millis, path=None)
        self.cluster_degraded_thresholds = thresholds_fn
        self.spans = None


def _seats(P, ck_path, rule, mids=("A", "B"), journal=False):
    seats = {}
    for mid in mids:
        state = P.state.ClusterStateManager(**P.kw)
        state.server_rules().load_rules("default", [rule])
        host = None
        if journal:
            host = _Host(P, state.server_rules().thresholds)
            state.journal = host.journal
        seats[mid] = P.ha.ClusterHAManager(
            engine=host, state=state, machine_id=mid, checkpoint_path=ck_path,
            checkpoint_period_s=3600.0, server_host="127.0.0.1", **P.kw)
    return seats


def _specs(P, mids=("A", "B"), ports=None):
    ports = ports or [_free_port() for _ in mids]
    return tuple(P.ha.ClusterServerSpec(m, "127.0.0.1", p)
                 for m, p in zip(mids, ports))


def _stop(seats):
    for seat in seats.values():
        seat.stop()


# -- epoch fence, role flips, stats --------------------------------------------


def test_epoch_fence_monotonic_observe_and_mint():
    def scenario(P):
        f = P.state.EpochFence()
        out = [f.observe(3), f.observe(3), f.observe(2),
               f.stale_rejected_count, f.highest_seen, f.mint(), f.mint()]
        assert out == [True, True, False, 1, 3, 4, 5]
        return out

    _both(scenario)


def test_manual_server_flip_epoch_semantics():
    def scenario(P):
        mgr = P.state.ClusterStateManager(**P.kw)
        try:
            srv = mgr.set_to_server(host="127.0.0.1", port=0)
            out = [srv.epoch, mgr.epoch]
            mgr.set_to_server(host="127.0.0.1", port=0, epoch=7)
            out.append(mgr.token_server.epoch)
            out.append(mgr.set_to_server(host="127.0.0.1", port=0).epoch)
            assert out == [0, 0, 7, 8]
            return out, strip_keys(mgr.ha_stats())
        finally:
            mgr.stop()

    _both(scenario)


def test_ha_stats_plain_deployment_zeroes():
    def scenario(P):
        stats = P.state.ClusterStateManager(**P.kw).ha_stats()
        assert stats["roleName"] == "NOT_STARTED" and stats["epoch"] == 0
        return stats

    _both(scenario)


def test_epoch_tlv_round_trip_and_tag_scanning():
    def scenario(P):
        c = P.codec
        entity = c.encode_flow_response(5, 0)
        base = len(entity)
        entity = c.append_trace_tlv(entity, c.encode_span_info(
            "00f067aa0ba902b7", 1700000000000, 250))
        entity = c.append_epoch_tlv(entity, c.encode_epoch_value(9))
        bad = c.append_tlv(c.encode_flow_response(5, 0), c.TLV_EPOCH,
                           b"\x01")
        out = [c.read_epoch_tlv(entity, base),
               c.read_trace_tlv(entity, base) is not None,
               c.read_epoch_tlv(c.encode_flow_response(5, 0), base),
               c.read_epoch_tlv(entity[:-3], base),
               c.read_epoch_tlv(bad, base), bytes(entity)]
        assert out[:5] == [9, True, None, None, None]
        return out

    _both(scenario)


# -- cluster map converter -------------------------------------------------------


def test_cluster_map_converter_valid_and_leader_reorder():
    def scenario(P):
        m = P.conv.cluster_map_from_json(json.dumps({
            "epoch": 3, "namespace": "nsX",
            "servers": [{"machineId": "a", "host": "10.0.0.1",
                         "port": 18730},
                        {"machineId": "b", "host": "10.0.0.2",
                         "port": 18731}],
            "clients": ["c", "d"], "leader": "b",
            "requestTimeoutMs": 1500}))
        assert m.leader().machine_id == "b"
        assert m.server_for("zz") is None
        again = P.conv.cluster_map_from_json(P.conv.cluster_map_to_dict(m))
        assert again == m
        return tuple(m), P.conv.cluster_map_to_dict(m)

    _both(scenario)


_GOOD = {"machineId": "a", "host": "h", "port": 1}
BAD_CLUSTER_MAPS = {
    "not-an-object": [1, 2],
    "bad-epoch": {"epoch": "x", "servers": [_GOOD]},
    "no-servers": {"epoch": 1},
    "empty-servers": {"epoch": 1, "servers": []},
    "no-host": {"epoch": 1, "servers": [{"machineId": "a"}]},
    "bad-port": {"epoch": 1, "servers": [{**_GOOD, "port": "nope"}]},
    "ghost-leader": {"epoch": 1, "servers": [_GOOD], "leader": "ghost"},
    "bare-clients": {"epoch": 1, "servers": [_GOOD], "clients": "node-c"},
}


@pytest.mark.parametrize("case", sorted(BAD_CLUSTER_MAPS))
def test_cluster_map_converter_rejects_malformed(case):
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError) as ex:
            P.conv.cluster_map_from_json(json.dumps(BAD_CLUSTER_MAPS[case]))
        msgs.append(str(ex.value))
    assert msgs[1] == msgs[0]


# -- degraded quota ------------------------------------------------------------------


def test_degraded_quota_share_bound_sum_leq_global():
    def scenario(P):
        T, N = 12.0, 4
        clients = [P.ha.DegradedQuota(divisor=N, thresholds={7: (T, 1000)})
                   for _ in range(N)]
        out = [[tr_tuple(q.acquire(7)) for _ in range(10)] for q in clients]
        grants = [sum(1 for r in row if r[0] == 0) for row in out]
        assert grants == [3] * N and sum(grants) <= T
        P.tu.advance_time(1100)
        out.append(tr_tuple(clients[0].acquire(7)))
        return out, clients[0].snapshot()

    snap = _both(scenario)[1]
    assert snap == {"divisor": 4, "grantedCount": 4, "blockedCount": 7,
                    "flows": 1}


def test_degraded_quota_unknown_flow_and_live_thresholds():
    def scenario(P):
        seen = {}
        q = P.ha.DegradedQuota(divisor=2, thresholds_fn=lambda: seen)
        out = [q.acquire(9), q.acquire("junk")]
        seen[9] = (4.0, 1000)
        out += [tr_tuple(q.acquire(9)) for _ in range(3)]
        assert out[0] is None and [o[0] for o in out[2:]] == [0, 0, 1]
        return out

    _both(scenario)


# -- wire fencing over TCP -------------------------------------------------------------


def _epoch_server(P, epoch=5, flow=500):
    return P.server.ClusterTokenServer(
        P.service(_rules(P, (flow, 1000)), epoch=epoch),
        host="127.0.0.1", port=0).start()


def test_fenced_client_accepts_current_epoch_and_rejects_a_replay():
    def scenario(P):
        server = _epoch_server(P)
        fence = P.state.EpochFence()
        client = P.client.ClusterTokenClient(
            "127.0.0.1", server.bound_port, epoch_fence=fence,
            health_gate=None).start()
        try:
            assert _wait(client.is_connected)
            out = [tr_tuple(_ok_with_retry(
                P, lambda: client.request_token(500))), fence.highest_seen]
            with P.resilience.FaultInjector(seed=1234) as inj:
                inj.arm("cluster.ha.stale.epoch", "garbage", times=1,
                        garbage=P.codec.encode_epoch_value(4))
                out.append(tr_tuple(client.request_token(500)))
                out += [fence.stale_rejected_count, fence.highest_seen]
                out.append(tr_tuple(client.request_token(500)))
            assert [out[1], out[2][0], out[3], out[4], out[5][0]] == [
                5, int(P.CC.TokenResultStatus.FAIL), 1, 5, 0]
            return out
        finally:
            client.stop()
            server.stop()

    _both(scenario)


def test_epoch_zero_keeps_pre_ha_wire_format():
    def scenario(P):
        server = _epoch_server(P, epoch=0, flow=501)
        fence = P.state.EpochFence()
        client = P.client.ClusterTokenClient(
            "127.0.0.1", server.bound_port, epoch_fence=fence,
            health_gate=None).start()
        try:
            assert _wait(client.is_connected)
            r = tr_tuple(_ok_with_retry(
                P, lambda: client.request_token(501)))
            assert fence.highest_seen == 0
            return r
        finally:
            client.stop()
            server.stop()

    _both(scenario)


def test_halfopen_swallowed_reply_times_out_not_hangs():
    def scenario(P):
        server = _epoch_server(P)
        client = P.client.ClusterTokenClient(
            "127.0.0.1", server.bound_port, request_timeout_s=0.4,
            health_gate=None).start()
        try:
            assert _wait(client.is_connected)
            out = [tr_tuple(_ok_with_retry(
                P, lambda: client.request_token(500)))]
            with P.resilience.FaultInjector(seed=1234) as inj:
                inj.arm("cluster.ha.halfopen", "garbage", times=1,
                        garbage=b"")
                t0 = time.monotonic()
                out.append(tr_tuple(client.request_token(500)))
                assert time.monotonic() - t0 < 2.0
                assert client.is_connected()
                out.append(tr_tuple(client.request_token(500)))
            return out
        finally:
            client.stop()
            server.stop()

    out = _both(scenario)
    assert [o[0] for o in out] == [0, int(PORT.CC.TokenResultStatus.FAIL), 0]


# -- the failover client ---------------------------------------------------------------


def test_failover_client_walks_to_standby():
    def scenario(P):
        a = _epoch_server(P, epoch=1, flow=600)
        b = _epoch_server(P, epoch=1, flow=600)
        fc = P.ha.FailoverTokenClient(
            [("127.0.0.1", a.bound_port), ("127.0.0.1", b.bound_port)],
            request_timeout_s=2.0, reconnect_interval_s=0.05,
            failover_deadline_ms=60_000).start()
        try:
            assert _wait(fc.is_connected)
            out = [tr_tuple(_ok_with_retry(P, lambda: fc.request_token(600))),
                   fc.failover_count]
            b.service.request_tokens([(None, 0, False)])
            a.stop()
            out += [tr_tuple(_ok_with_retry(
                P, lambda: fc.request_token(600))), fc.failover_count,
                fc.failover_stats()["activeTarget"].endswith(
                    str(b.bound_port)), fc.is_degraded()]
            assert out[3:] == [1, True, False]
            return out
        finally:
            fc.stop()
            a.stop()
            b.stop()

    _both(scenario)


def test_degraded_mode_after_deadline_and_recovery():
    def scenario(P):
        TS = P.CC.TokenResultStatus
        port = _free_port()
        fc = P.ha.FailoverTokenClient(
            [("127.0.0.1", port)], request_timeout_s=0.3,
            reconnect_interval_s=0.05, failover_deadline_ms=1000,
            degraded=P.ha.DegradedQuota(divisor=2,
                                        thresholds={7: (10.0, 1000)}))
        fc.start()
        try:
            out = [tr_tuple(fc.request_token(7)), fc.is_degraded()]
            P.tu.advance_time(1001)
            out += [tr_tuple(fc.request_token(7)) for _ in range(7)]
            out += [fc.is_degraded(), fc.degraded_entry_count,
                    tr_tuple(fc.request_param_token(7, 1, ["k"])),
                    tr_tuple(fc.request_token(999))]
            P.tu.advance_time(2500)
            server = P.server.ClusterTokenServer(
                P.service(_rules(P, (7, 1000)), epoch=2),
                host="127.0.0.1", port=port).start()
            try:
                assert _wait(fc.is_connected)
                out.append(tr_tuple(_ok_with_retry(
                    P, lambda: fc.request_token(7))))
                stats = fc.failover_stats()
                assert not fc.is_degraded()
                assert stats["degradedSeconds"] == pytest.approx(2.5)
                out += [stats["degradedSeconds"], stats["degradedQuota"],
                        stats["degraded"], stats["degradedEntries"]]
            finally:
                server.stop()
            assert [o[0] for o in out[2:9]].count(int(TS.OK)) == 5
            return out
        finally:
            fc.stop()

    _both(scenario)


def test_failover_walk_shares_one_timeout_budget():
    def scenario(P):
        TR, TS = P.ts.TokenResult, P.CC.TokenResultStatus

        class _Stub:
            def __init__(self, fail_for_s=0.0):
                self.fail_for_s = fail_for_s
                self.seen = []

            def is_connected(self):
                return True

            def request_token(self, *a, timeout_s=None, **k):
                self.seen.append(timeout_s)
                if self.fail_for_s:
                    time.sleep(self.fail_for_s)
                    return TR(TS.FAIL)
                return TR(TS.OK)

        fc = P.ha.FailoverTokenClient([("127.0.0.1", 1), ("127.0.0.1", 2)],
                                      failover_deadline_ms=60_000)
        slow, fast = _Stub(fail_for_s=0.05), _Stub()
        fc._clients = [slow, fast]
        out = [tr_tuple(fc.request_token(5, timeout_s=0.2))]
        assert slow.seen[0] == pytest.approx(0.2, abs=0.01)
        assert 0 < fast.seen[0] <= 0.16
        slow.seen.clear()
        fast.seen.clear()
        out.append(tr_tuple(fc.request_token(5, timeout_s=0.03)))
        assert fast.seen == []
        slow.seen.clear()
        fc.request_token(5)
        assert slow.seen == [None]
        return out

    _both(scenario)


# -- the HA manager: map-driven flips, drain, warm start -------------------------------


def test_apply_map_graceful_flip_preserves_windows(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-ha.npz"), P.rule(700, 6))
        servers = _specs(P)
        pa, pb = servers[0].port, servers[1].port
        m1 = P.ha.ClusterMap(epoch=1, servers=servers, clients=("X",))
        m2 = P.ha.ClusterMap(epoch=2, servers=servers[::-1], clients=("X",))
        fc = P.ha.FailoverTokenClient(
            [("127.0.0.1", pa), ("127.0.0.1", pb)], request_timeout_s=2.0,
            reconnect_interval_s=0.05, failover_deadline_ms=60_000).start()
        try:
            seats["A"].apply_map(m1)
            seats["B"].apply_map(m1)
            out = [seats["A"].state.mode, seats["B"].state.mode]
            assert _wait(fc.is_connected)
            out.append(tr_tuple(_ok_with_retry(
                P, lambda: fc.request_token(700))))
            out += [tr_tuple(fc.request_token(700)) for _ in range(4)]
            seats["A"].apply_map(m2)
            seats["B"].apply_map(m2)
            out += [seats["A"].state.mode, seats["B"].state.mode,
                    seats["B"].rows_restored,
                    seats["A"].checkpoints_published >= 1]
            out.append(tr_tuple(_ok_with_retry(
                P, lambda: fc.request_token(700))))
            out += [tr_tuple(fc.request_token(700)) for _ in range(3)]
            out += [fc.failover_count, fc.fence.highest_seen,
                    strip_keys(seats["B"].state.ha_stats())]
            return out
        finally:
            fc.stop()
            _stop(seats)

    out = _both(scenario)
    assert [o[0] for o in out[2:7]] == [0] * 5
    assert out[11][0] == 0 and [o[0] for o in out[12:15]] == [1, 1, 1]
    assert out[10] == 1 and out[15:17] == [1, 2]


def test_stale_map_ignored(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-ha.npz"), P.rule(710, 5))
        servers = _specs(P)
        try:
            seats["A"].apply_map(P.ha.ClusterMap(epoch=2,
                                                 servers=servers[::-1]))
            m0 = seats["A"].state.mode
            seats["A"].apply_map(P.ha.ClusterMap(epoch=1, servers=servers))
            assert seats["A"].state.mode == P.state.CLUSTER_CLIENT
            return m0, seats["A"].state.mode, seats["A"].map.epoch
        finally:
            _stop(seats)

    _both(scenario)


def test_in_process_repromotion_preserves_unpublished_grants(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-reprom.npz"),
                       P.rule(730, 6))
        servers = _specs(P)
        try:
            seats["A"].apply_map(P.ha.ClusterMap(epoch=1, servers=servers))
            svc = seats["A"].state.token_server.service
            out = [tr_tuple(svc.request_token(730)) for _ in range(4)]
            seats["A"].apply_map(P.ha.ClusterMap(epoch=2, servers=servers))
            svc2 = seats["A"].state.token_server.service
            out += [seats["A"].state.token_server.epoch,
                    seats["A"].rows_restored]
            out += [tr_tuple(svc2.request_token(730)) for _ in range(3)]
            return out
        finally:
            _stop(seats)

    out = _both(scenario)
    assert out[4:6] == [2, 1] and [o[0] for o in out[6:]] == [0, 0, 1]


def test_same_target_map_change_reuses_live_client(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-ha.npz"), P.rule(740, 5))
        servers = _specs(P)
        try:
            seats["B"].apply_map(P.ha.ClusterMap(epoch=1, servers=servers,
                                                 clients=("X",)))
            cur = seats["B"].state.token_client
            cur.failover_count = 3
            seats["B"].apply_map(P.ha.ClusterMap(
                epoch=2, servers=servers, clients=("X", "Y"),
                request_timeout_ms=5000))
            out = [seats["B"].state.token_client is cur, cur.failover_count,
                   cur.degraded.divisor,
                   [c.request_timeout_s for c in cur._clients],
                   seats["B"].state.epoch,
                   seats["B"].state.fence.highest_seen]
            seats["B"].apply_map(P.ha.ClusterMap(epoch=3, servers=servers))
            out += [seats["B"].state.token_client is cur,
                    cur.degraded.divisor]
            seats["B"].apply_map(P.ha.ClusterMap(epoch=4,
                                                 servers=servers[:1]))
            out.append(seats["B"].state.token_client is not cur)
            return out
        finally:
            _stop(seats)

    assert _both(scenario) == [True, 3, 2, [5.0, 5.0], 2, 2, True, 1, True]


def test_failed_promotion_retries_until_port_frees(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-ha.npz"), P.rule(760, 5))
        port = _free_port()
        blocker = socket.socket()
        blocker.bind(("127.0.0.1", port))
        blocker.listen(1)
        try:
            seats["A"].retry_delay_s = 0.05
            seats["A"].apply_map(P.ha.ClusterMap(
                epoch=1, servers=_specs(P, ("A",), [port])))
            out = [seats["A"].state.mode != P.state.CLUSTER_SERVER,
                   seats["A"].map is None,
                   seats["A"].transition_pending()]
            blocker.close()
            # Both packages flip the mode before they set ``map`` (ROADMAP
            # C21): wait for the two, not for the mode alone.
            assert _wait(lambda: seats["A"].state.mode
                         == P.state.CLUSTER_SERVER
                         and seats["A"].map is not None, 10.0)
            out += [seats["A"].map.epoch,
                    seats["A"].state.token_server.epoch,
                    seats["A"].transition_pending()]
            return out
        finally:
            blocker.close()
            _stop(seats)

    assert _both(scenario) == [True, True, True, 1, 1, False]


def test_map_below_wire_observed_epoch_ignored(tmp_path):
    def scenario(P):
        seats = _seats(P, str(tmp_path / f"{P.name}-ha.npz"), P.rule(750, 5))
        servers = _specs(P, ("A",))
        try:
            seats["A"].state.fence.observe(5)
            seats["A"].apply_map(P.ha.ClusterMap(epoch=4, servers=servers))
            out = [seats["A"].state.mode, seats["A"].map is None,
                   seats["A"].state.fence.stale_rejected_count]
            seats["A"].apply_map(P.ha.ClusterMap(epoch=5, servers=servers))
            out += [seats["A"].state.mode,
                    seats["A"].state.token_server.epoch]
            return out
        finally:
            _stop(seats)

    out = _both(scenario)
    assert out[1:3] == [True, 0] and out[3:] == [PORT.state.CLUSTER_SERVER, 5]


def test_leader_crash_failover_acceptance(tmp_path):
    """The leader dies through the ``cluster.ha.leader.crash`` seam (no
    drain), the standby restores the last published checkpoint and
    admits: total admissions across the handoff are the threshold plus
    exactly the grants made since the publish, on both packages."""
    def scenario(P):
        T, margin = 10, 2
        seats = _seats(P, str(tmp_path / f"{P.name}-crash.npz"),
                       P.rule(720, T), journal=True)
        servers = _specs(P)
        pa, pb = servers[0].port, servers[1].port
        fc = P.ha.FailoverTokenClient(
            [("127.0.0.1", pa), ("127.0.0.1", pb)], request_timeout_s=0.5,
            reconnect_interval_s=0.05, failover_deadline_ms=20_000).start()
        try:
            seats["A"].apply_map(P.ha.ClusterMap(epoch=1, servers=servers,
                                                 clients=("X",)))
            assert _wait(fc.is_connected)
            out = [tr_tuple(_ok_with_retry(
                P, lambda: fc.request_token(720)))]
            out += [tr_tuple(fc.request_token(720)) for _ in range(3)]
            seats["A"].publish_checkpoint()
            out += [tr_tuple(fc.request_token(720)) for _ in range(margin)]
            with P.resilience.FaultInjector(seed=1234) as inj:
                inj.arm("cluster.ha.leader.crash", "error", times=1)
                out.append(tr_tuple(fc.request_token(720)))
                assert _wait(lambda: seats["A"].state.token_server.crashed,
                             5.0)
            published = seats["A"].checkpoints_published
            seats["B"].apply_map(P.ha.ClusterMap(
                epoch=2, servers=servers[::-1], clients=("X",)))
            out += [seats["B"].state.mode, seats["B"].rows_restored]
            out.append(tr_tuple(_ok_with_retry(
                P, lambda: fc.request_token(720))))
            post = 1
            while fc.request_token(720).status == P.CC.TokenResultStatus.OK:
                post += 1
                assert post <= T
            assert 6 + post == T + margin
            out += [post, fc.failover_count, fc.fence.highest_seen,
                    seats["A"].checkpoints_published == published,
                    strip_keys(seats["B"].state.ha_stats())]
            journals = {m: strip_keys(s.engine.journal.tail(limit=1000))
                        for m, s in seats.items()}
            return out, journals
        finally:
            fc.stop()
            _stop(seats)

    out, journals = _both(scenario)
    assert [o[0] for o in out[:6]] == [0] * 6
    assert out[6][0] == int(PORT.CC.TokenResultStatus.FAIL)
    assert out[8] == 1 and out[10:13] == [6, 1, 2]
    # The journal: each map apply, then the role flip it caused.
    kinds = [(r["kind"], r.get("causeSeq")) for r in journals["B"]]
    applies = [r["seq"] for r in journals["B"]
               if r["kind"] == "clusterMapApply"]
    assert ("haRoleFlip", applies[-1]) in kinds


def test_default_machine_id_shape():
    assert PORT.ha.default_machine_id().endswith(f"@{os.getpid()}")
    assert PORT.ha.default_machine_id() == JAX.ha.default_machine_id()


# -- the cluster checkpoint file across packages ------------------------------------


def _window(svc):
    w = svc._state.win
    if hasattr(w.counts, "numpy"):
        return [np.asarray(t.cpu().numpy()) for t in (w.counts, w.starts,
                                                      w.bucket_ms)]
    return [np.asarray(t) for t in (w.counts, w.starts, w.bucket_ms)]


FIDS = (9003, 9001, 9000, 42, 77)


def _fid_rules(P, order=FIDS):
    rules = P.rules.ClusterFlowRuleManager()
    rules.load_rules("default", [
        P.rule(f, 50, **({"windowIntervalMs": 2000, "sampleCount": 4}
                         if f == 42 else {})) for f in order])
    return rules


def _loaded(P, epoch=0):
    """A service with five flows (one a 2 s / 4-bucket window) after a
    scripted stream over two seconds on the package's frozen clock: the
    rows a checkpoint carries."""
    P.tu.freeze_time(NOW0)
    svc = P.service(_fid_rules(P), epoch=epoch)
    for step in range(6):
        for i, f in enumerate(FIDS):
            svc.request_tokens([(f, 1 + (i + step) % 3, False)] * (1 + i))
        P.tu.advance_time(350)
    return svc


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("sliced", [False, True])
def test_cluster_checkpoint_restores_across_packages(tmp_path, direction,
                                                     sliced):
    """One package saves, the other restores: the same rows graft (bit
    for bit: int32 counts, int64 starts and bucket lengths), and the next
    verdicts equal the saving package's own restore. A slice-filtered
    handoff file carries and grafts only its slice's flows."""
    src, dst = (JAX, PORT) if direction == "jax->port" else (PORT, JAX)
    kw = dict(slices=(0, 6), n_slices=8) if sliced else {}
    for P in BOTH:
        P.tu.freeze_time(NOW0)
    try:
        path = str(tmp_path / "x.npz")
        svc = _loaded(src, epoch=3)
        src.ckpt.save_cluster_checkpoint(svc, path, epoch=4 if sliced
                                         else None, **kw)
        header, _ = src.ckpt._load_npz(path)
        restored = {}
        for P in (src, dst):
            P.tu.freeze_time(NOW0 + 2_500)
            fresh = P.service(_fid_rules(P))
            n = P.ckpt.restore_cluster_checkpoint(fresh, path, **kw)
            after = [tr_tuple(r) for r in fresh.request_tokens(
                [(f, 1, False) for f in FIDS for _ in range(3)])]
            restored[P.name] = (n, _window(fresh), after)
        want, got = restored[src.name], restored[dst.name]
        assert got[0] == want[0] == (2 if sliced else len(FIDS))
        for a, b in zip(want[1], got[1]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[2] == want[2]
        if sliced:
            assert header["slices"] == [0, 6] and header["epoch"] == 4
            assert set(header["flows"]) == {"9003", "9000"}
    finally:
        for P in BOTH:
            P.tu.unfreeze_time()


def test_restore_grafts_rows_bit_for_bit(tmp_path):
    """Restored rows are the saved rows, byte for byte, in the service's
    own layout (a service with a different rule order)."""
    for P in BOTH:
        P.tu.freeze_time(NOW0)
    try:
        path = str(tmp_path / "rows.npz")
        svc = _loaded(PORT)
        PORT.ckpt.save_cluster_checkpoint(svc, path)
        header, arrays = PORT.ckpt._load_npz(path)
        fresh = PORT.service(_fid_rules(PORT, order=FIDS[::-1]))
        assert PORT.ckpt.restore_cluster_checkpoint(fresh, path) == len(FIDS)
        counts, starts, _ = _window(fresh)
        for fid, old in header["flows"].items():
            new = fresh._slot_of[int(fid)]
            assert np.array_equal(counts[new], arrays["counts"][old])
            assert np.array_equal(starts[new], arrays["starts"][old])
        assert counts.dtype == np.int32 and starts.dtype == np.int64
    finally:
        for P in BOTH:
            P.tu.unfreeze_time()


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_deposed_epoch_save_is_refused_across_packages(tmp_path, direction):
    newer, older = (JAX, PORT) if direction == "jax->port" else (PORT, JAX)
    path = str(tmp_path / "fence.npz")
    for P in BOTH:
        P.tu.freeze_time(NOW0)
    try:
        newer.ckpt.save_cluster_checkpoint(_loaded(newer, epoch=5), path)
        before = open(path, "rb").read()
        with pytest.raises(ValueError, match="deposed epoch 3"):
            older.ckpt.save_cluster_checkpoint(_loaded(older, epoch=3), path)
        assert open(path, "rb").read() == before
        older.ckpt.save_cluster_checkpoint(_loaded(older, epoch=6), path)
        assert older.ckpt._load_npz(path)[0]["epoch"] == 6
    finally:
        for P in BOTH:
            P.tu.unfreeze_time()


def test_corrupt_cluster_checkpoint_is_one_value_error(tmp_path):
    path = str(tmp_path / "bad.npz")
    with open(path, "wb") as f:
        f.write(b"not a zip")
    for P in BOTH:
        with pytest.raises(ValueError, match="corrupted or truncated"):
            P.ckpt.restore_cluster_checkpoint(P.service(_rules(P, (1, 5))),
                                              path)
        with pytest.raises(FileNotFoundError):
            P.ckpt.restore_cluster_checkpoint(P.service(_rules(P, (1, 5))),
                                              str(tmp_path / "none.npz"))


# -- device policy ---------------------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a card-less host")
def test_without_a_card_leaders_need_an_explicit_device(tmp_path):
    from sentinel_tpu_torch.simulator.clock import SimClock

    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.ha.ClusterHAManager(state=PORT.state.ClusterStateManager(),
                                 machine_id="A")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.ts.DefaultTokenService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.mesh.ChaosMesh(SimClock(0), PORT.inv.History(), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.campaign.ChaosCampaign(episodes=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PORT.slot_storm.SlotStormCampaign(episodes=1)
    rb = PORT.rebalance.ShardRebalancer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rb._device()


def test_warm_up_is_best_effort_only_off_the_card():
    """The pre-bind probe: a CPU service's failure is logged and the
    promotion goes on; a CUDA service's failure (its acquire kernel did
    not build or launch) raises out of the promotion."""
    class _Svc:
        def __init__(self, kind):
            self.device = torch.device(kind)

        def request_tokens(self, requests):
            raise RuntimeError("acquire kernel failed to load")

    PORT.ha.ClusterHAManager._warm_up(_Svc("cpu"))
    with pytest.raises(RuntimeError, match="failed to load"):
        PORT.ha.ClusterHAManager._warm_up(_Svc("cuda"))


def test_engine_seat_builds_leaders_on_the_engine_device(tmp_path):
    """An engine's HA seat: ``state.ha`` is wired, the leader runs on the
    engine's device, and the engine journal holds the map apply and the
    role flip it caused."""
    from sentinel_tpu_torch.core.engine import SentinelEngine

    eng = SentinelEngine(capacity=64, device="cpu", journal_path="")
    try:
        eng.cluster.server_rules().load_rules("default",
                                              [PORT.rule(810, 5)])
        mgr = PORT.ha.ClusterHAManager(
            engine=eng, machine_id="A",
            checkpoint_path=str(tmp_path / "e.npz"), server_host="127.0.0.1")
        assert eng.cluster.ha is mgr and mgr.device.type == "cpu"
        mgr.apply_map(PORT.ha.ClusterMap(epoch=3, servers=_specs(
            PORT, ("A",))))
        svc = eng.cluster.token_server.service
        assert svc.device.type == "cpu" and svc.epoch == 3
        assert svc.request_token(810).status == 0
        recs = eng.journal.tail(limit=50)
        apply = [r for r in recs if r["kind"] == "clusterMapApply"][-1]
        flip = [r for r in recs if r["kind"] == "haRoleFlip"][-1]
        assert flip["causeSeq"] == apply["seq"] and flip["role"] == "SERVER"
        assert eng.cluster.ha_stats()["manager"]["mapEpoch"] == 3
        mgr.stop()
        assert mgr._ckpt_timer is None
    finally:
        eng.close()


# -- slow: the real-clock partition drill ------------------------------------------------


@pytest.mark.slow
def test_extended_partition_multiple_degraded_spells():
    P = PORT
    port = _free_port()
    fc = P.ha.FailoverTokenClient(
        [("127.0.0.1", port)], request_timeout_s=0.2,
        reconnect_interval_s=0.05, failover_deadline_ms=300,
        degraded=P.ha.DegradedQuota(divisor=1, thresholds={7: (1000.0,
                                                               1000)}))
    fc.start()
    try:
        for spell in (1, 2):
            deadline = time.monotonic() + 10
            while not fc.is_degraded() and time.monotonic() < deadline:
                fc.request_token(7)
                time.sleep(0.05)
            assert fc.is_degraded()
            assert fc.request_token(7).status == 0
            svc = P.service(_rules(P, (7, 1000)), epoch=spell)
            svc.request_tokens([(None, 0, False)])
            server = P.server.ClusterTokenServer(svc, host="127.0.0.1",
                                                 port=port).start()
            try:
                assert _wait(fc.is_connected, 10.0)
                assert _wait(lambda: fc.request_token(7).status == 0
                             and not fc.is_degraded(), 10.0)
            finally:
                server.stop()
            fc._clients[0]._drop_connection()
            assert _wait(lambda: not fc.is_connected(), 10.0)
        assert fc.degraded_entry_count >= 2 and fc.degraded_seconds() > 0.0
    finally:
        fc.stop()
