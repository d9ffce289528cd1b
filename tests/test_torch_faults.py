"""``tests/test_chaos.py`` on the port: fault injection at every remote
seam the port has, with graceful, bounded degradation, on the CPU.

The three cases that arm ``datasource.read`` (``:148``, ``:167`` and
``:201``) run on both packages, and what each observed must be equal; the
second point that ``:167`` arms mid-run is ``datasource.flap`` on both
(the reference's ``heartbeat.post`` belongs to the heartbeat sender,
which the port does not have yet). Every other tier-1 case runs on the
port with ``device="cpu"`` token services and engines, but two that need
the ops plane: the ``resilience`` command (``:302``) and the heartbeat's
rotation backoff (``:427``).

Host-side cases run under the port's frozen clock and a seeded injector;
the socket scenarios use real time with millisecond budgets.
"""

from __future__ import annotations

import gc
import logging
import socket
import threading
import time

import pytest

import sentinel_tpu_torch as st
from sentinel_tpu_torch.cluster.client import ClusterTokenClient
from sentinel_tpu_torch.cluster.constants import (THRESHOLD_GLOBAL,
                                                  TokenResultStatus)
from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core.exceptions import BlockException
from sentinel_tpu_torch.datasource.base import AutoRefreshDataSource
from sentinel_tpu_torch.models.flow import FlowRule
from sentinel_tpu_torch.resilience import (
    STATE_CLOSED,
    STATE_OPEN,
    DeadlineBudget,
    FaultInjector,
    HealthGate,
    RetryPolicy,
    faults,
    health_snapshot,
    register_probe,
)
from sentinel_tpu_torch.utils import time_util

from tests.test_torch_support import ds_pkgs

SEED = 1234
NOW0 = 1_700_000_000_000


@pytest.fixture()
def frozen_time():
    time_util.freeze_time(NOW0)
    yield time_util
    time_util.unfreeze_time()


@pytest.fixture()
def injector():
    with FaultInjector(seed=SEED) as inj:
        yield inj


@pytest.fixture()
def live_engine():
    """A fresh port engine on the real clock (the socket scenarios need
    real time), with a fast token-client reconnect cadence."""
    from sentinel_tpu_torch.core.config import config
    from sentinel_tpu_torch.core.context import (bump_generation,
                                                 replace_context)

    time_util.unfreeze_time()
    config.set("csp.sentinel.resilience.cluster.client.retry.base.ms", "50")
    config.set("csp.sentinel.resilience.cluster.client.retry.max.ms", "200")
    replace_context(None)
    bump_generation()
    eng = st.reset(capacity=256, device="cpu")
    yield eng
    replace_context(None)
    eng.cluster.stop()
    config.set("csp.sentinel.resilience.cluster.client.retry.base.ms", "")
    config.set("csp.sentinel.resilience.cluster.client.retry.max.ms", "")
    eng.close()


# -- the datasource.read cases, on both packages -------------------------------


def both(fn):
    """``fn(M)`` on the JAX package and on the port; equal observations."""
    out = [fn(M) for M in ds_pkgs()]
    assert out[0] == out[1], out
    return out[1]


def test_fault_injector_schedule_probability_and_replay():
    """test_chaos.py:148."""

    def run(M):
        fired = []
        with M.resilience.FaultInjector(seed=SEED) as inj:
            inj.arm("datasource.read", "error", probability=0.5, times=3)
            for _ in range(20):
                try:
                    M.faults.fire("datasource.read")
                    fired.append(False)
                except M.resilience.FaultInjected:
                    fired.append(True)
        return fired

    first = both(run)
    assert first == both(run)
    assert sum(first) == 3
    assert any(first) and not all(first)


def test_arming_a_new_point_mid_run_never_shifts_other_streams():
    """test_chaos.py:167, the second point ``datasource.flap``."""

    def run(M, arm_second_mid_run):
        fired = []
        with M.resilience.FaultInjector(seed=SEED) as inj:
            inj.arm("datasource.read", "error", probability=0.5)
            for i in range(24):
                if arm_second_mid_run and i == 12:
                    inj.arm("datasource.flap", "error", probability=0.5)
                if arm_second_mid_run and i >= 12:
                    try:
                        M.faults.fire("datasource.flap")
                    except M.resilience.FaultInjected:
                        pass
                try:
                    M.faults.fire("datasource.read")
                    fired.append(False)
                except M.resilience.FaultInjected:
                    fired.append(True)
        return fired

    baseline = both(lambda M: run(M, False))
    assert both(lambda M: run(M, True)) == baseline
    assert any(baseline) and not all(baseline)
    assert both(lambda M: run(M, False)) == baseline


def test_thread_scoped_injector_ignores_foreign_threads():
    """test_chaos.py:201."""

    def run(M):
        with M.resilience.FaultInjector(seed=SEED, scope_thread=True) as inj:
            inj.arm("datasource.read", "error", times=1)
            inj.arm("cluster.server.frame", "garbage", garbage=b"XX",
                    times=1)
            results = []

            def foreign():
                try:
                    M.faults.fire("datasource.read")
                    results.append("no-fire")
                except M.resilience.FaultInjected:
                    results.append("fired")
                results.append(M.faults.mutate("cluster.server.frame", b"ok"))

            t = threading.Thread(target=foreign)
            t.start()
            t.join()
            untouched = inj.fires("datasource.read")
            with pytest.raises(M.resilience.FaultInjected):
                M.faults.fire("datasource.read")
            mutated = M.faults.mutate("cluster.server.frame", b"ok")
        return results, untouched, mutated

    assert both(run) == (["no-fire", b"ok"], 0, b"XX")


# -- primitives (frozen clock, no sockets) ------------------------------------


def test_retry_policy_is_seed_deterministic_and_capped():
    """test_chaos.py:78."""
    p = RetryPolicy(base_ms=100, max_ms=800, seed=7)
    a = [p.session().next_delay_ms() for _ in range(1)]
    s1, s2 = p.session(), p.session()
    seq1 = [s1.next_delay_ms() for _ in range(10)]
    seq2 = [s2.next_delay_ms() for _ in range(10)]
    assert seq1 == seq2
    assert seq1[0] == 100 == a[0]
    assert all(0 <= d <= 800 for d in seq1)
    s1.reset()
    assert s1.next_delay_ms() == 100


def test_retry_policy_no_jitter_is_plain_exponential():
    """test_chaos.py:91."""
    s = RetryPolicy(base_ms=10, max_ms=100, multiplier=2.0,
                    jitter="none").session()
    assert [s.next_delay_ms() for _ in range(6)] == [10, 20, 40, 80, 100, 100]


def test_retry_policy_config_overrides():
    """test_chaos.py:97."""
    from sentinel_tpu_torch.core.config import config

    config.set("csp.sentinel.resilience.heartbeat.retry.base.ms", "77")
    config.set("csp.sentinel.resilience.retry.max.ms", "9999")
    try:
        p = RetryPolicy.from_config("heartbeat", base_ms=10, max_ms=100)
        assert p.base_ms == 77
        assert p.max_ms == 9999
        q = RetryPolicy.from_config("datasource", base_ms=10, max_ms=100000)
        assert q.base_ms == 10
        assert q.max_ms == 9999
    finally:
        config.set("csp.sentinel.resilience.heartbeat.retry.base.ms", "")
        config.set("csp.sentinel.resilience.retry.max.ms", "")


def test_health_gate_full_cycle(frozen_time):
    """test_chaos.py:114."""
    g = HealthGate(failure_threshold=3, open_ms=1000, half_open_probes=1)
    for _ in range(2):
        g.record_failure()
    assert g.state == STATE_CLOSED and g.allow()
    g.record_failure()
    assert g.state == STATE_OPEN
    assert not g.allow() and g.snapshot()["rejectedCount"] == 1
    frozen_time.advance_time(999)
    assert not g.allow()
    frozen_time.advance_time(1)
    assert g.allow()
    assert g.state_name == "HALF_OPEN"
    assert not g.allow()
    g.record_failure()
    assert g.state == STATE_OPEN and not g.allow()
    frozen_time.advance_time(1000)
    assert g.allow()
    g.record_success()
    assert g.state == STATE_CLOSED and g.snapshot()["openCount"] == 2
    g.record_failure()
    g.record_failure()
    assert g.state == STATE_CLOSED


def test_deadline_budget_clamps_waits(frozen_time):
    """test_chaos.py:139."""
    b = DeadlineBudget(300)
    assert b.remaining_ms() == 300 and not b.expired
    frozen_time.advance_time(250)
    assert b.clamp_wait_ms(500) == 50
    frozen_time.advance_time(100)
    assert b.expired and b.clamp_wait_ms(500) == 0


def test_fault_injector_unarmed_and_uninstalled_are_noops():
    """test_chaos.py:274 (``datasource.read`` for the reference's
    heartbeat point)."""
    faults.fire("datasource.read")
    assert faults.mutate("cluster.server.frame", b"x") == b"x"
    with FaultInjector(seed=0):
        faults.fire("datasource.read")
        assert faults.mutate("cluster.server.frame", b"x") == b"x"
    with pytest.raises(ValueError):
        FaultInjector().arm("no.such.point", "error")


def test_note_fail_open_counts_and_rate_limits_logging(frozen_time, caplog):
    """test_chaos.py:287."""
    from sentinel_tpu_torch.core.context import (bump_generation,
                                                 replace_context)
    from sentinel_tpu_torch.core.engine import SentinelEngine

    replace_context(None)
    bump_generation()
    engine = SentinelEngine(capacity=64, device="cpu")
    try:
        with caplog.at_level(logging.WARNING, logger="sentinel_tpu_torch"):
            for _ in range(5):
                engine._note_fail_open("test-channel")
            assert engine.fail_open_count == 5
            logs = [r for r in caplog.records
                    if "UNGUARDED" in r.getMessage()]
            assert len(logs) == 1
            frozen_time.advance_time(1000)
            engine._note_fail_open("test-channel")
            assert engine.fail_open_count == 6
            logs = [r for r in caplog.records
                    if "UNGUARDED" in r.getMessage()]
            assert len(logs) == 2
        assert engine.resilience_stats()["failOpenCount"] == 6
    finally:
        replace_context(None)
        engine.close()


def test_request_token_fails_immediately_when_disconnected():
    """test_chaos.py:327."""
    client = ClusterTokenClient("127.0.0.1", 1, request_timeout_s=2.0)
    t0 = time.monotonic()
    tr = client.request_token(900)
    elapsed = time.monotonic() - t0
    assert tr.status == TokenResultStatus.FAIL
    assert elapsed < 0.25, f"disconnected FAIL took {elapsed:.3f}s"


def test_open_breaker_fails_fast_without_wire(frozen_time):
    """test_chaos.py:337."""
    gate = HealthGate(failure_threshold=1, open_ms=10_000)
    client = ClusterTokenClient("127.0.0.1", 1, health_gate=gate)
    gate.record_failure()
    assert gate.state == STATE_OPEN
    tr = client.request_token(900)
    assert tr.status == TokenResultStatus.FAIL
    assert gate.snapshot()["rejectedCount"] == 1


def test_gate_neutral_misses_do_not_trip_the_breaker(frozen_time):
    """test_chaos.py:347."""
    gate = HealthGate(failure_threshold=1, open_ms=10_000)
    client = ClusterTokenClient("127.0.0.1", 1, health_gate=gate)
    assert client.request_token(900, gate_neutral=True).status \
        == TokenResultStatus.FAIL
    assert gate.state == STATE_CLOSED
    client.request_token(900)
    assert gate.state == STATE_OPEN


class _ListSource(AutoRefreshDataSource):
    def __init__(self, **kw):
        super().__init__(converter=lambda s: s, **kw)
        self.value = ["a"]

    def read_source(self):
        return list(self.value)


def test_dead_probe_owners_self_prune():
    """test_chaos.py:359."""
    src = _ListSource(recommend_refresh_ms=60_000)
    register_probe("chaos-dead-probe", src.health)
    assert "chaos-dead-probe" in health_snapshot()
    del src
    gc.collect()
    assert "chaos-dead-probe" not in health_snapshot()


def test_datasource_backoff_and_last_success(frozen_time, injector):
    """test_chaos.py:384."""
    src = _ListSource(
        recommend_refresh_ms=100,
        retry_policy=RetryPolicy(base_ms=100, max_ms=1000, multiplier=2.0,
                                 jitter="none"))
    src.first_load()
    assert src.last_success_ms == time_util.current_time_millis()
    t_good = src.last_success_ms
    injector.arm("datasource.read", "error")
    frozen_time.advance_time(500)
    waits = [src._poll_once() for _ in range(4)]
    assert src.consecutive_failures == 4
    assert waits == [100, 200, 400, 800]
    assert src.last_success_ms == t_good
    injector.disarm("datasource.read")
    assert src._poll_once() == 100
    assert src.consecutive_failures == 0
    assert src.last_success_ms == time_util.current_time_millis()
    h = src.health()
    assert h["consecutiveFailures"] == 0 and h["lastSuccessMs"] > t_good


def test_datasource_probe_registered_while_running(frozen_time):
    """test_chaos.py:408."""
    src = _ListSource(recommend_refresh_ms=60_000)
    src.start()
    try:
        names = [n for n in health_snapshot() if n.startswith("datasource.")]
        assert any("_ListSource" in n for n in names)
    finally:
        src.close()
    assert not any("_ListSource" in n for n in health_snapshot())


# -- the socket scenarios ------------------------------------------------------


def _cluster_rule(flow_id: int, local_count: float) -> FlowRule:
    return FlowRule(
        resource="shared", count=local_count, cluster_mode=True,
        cluster_config={"flowId": flow_id, "thresholdType": THRESHOLD_GLOBAL,
                        "fallbackToLocalWhenFail": True})


def _connected_client(port):
    client = ClusterTokenClient(
        "127.0.0.1", port, request_timeout_s=1.0,
        retry_policy=RetryPolicy(base_ms=50, max_ms=200, seed=SEED),
        health_gate=None)
    client.start()
    deadline = time.monotonic() + 5
    while not client.is_connected() and time.monotonic() < deadline:
        time.sleep(0.01)
    return client


def _recovers(client):
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if client.is_connected() \
                and client.request_token(900).status == TokenResultStatus.OK:
            return True
        time.sleep(0.02)
    return False


def test_reactor_conn_drop_seam_kills_and_recovers(live_engine, injector):
    """test_chaos.py:231."""
    rules = ClusterFlowRuleManager()
    rules.load_rules("default", [_cluster_rule(900, local_count=1000.0)])
    service = DefaultTokenService(rules=rules, device="cpu")
    service.request_tokens([(None, 0, False)])
    server = ClusterTokenServer(service=service, host="127.0.0.1").start()
    client = _connected_client(server.bound_port)
    try:
        assert client.request_token(900).status == TokenResultStatus.OK
        injector.arm("cluster.reactor.conn.drop", "error", times=1)
        tr = client.request_token(900)
        assert tr.status == TokenResultStatus.FAIL
        assert injector.fires("cluster.reactor.conn.drop") == 1
        assert _recovers(client), \
            "client never recovered after the injected conn drop"
    finally:
        client.stop()
        server.stop()


def test_garbage_frames_never_kill_the_reader(live_engine, injector):
    """test_chaos.py:651."""
    rules = ClusterFlowRuleManager()
    rules.load_rules("default", [_cluster_rule(900, local_count=1000.0)])
    server = ClusterTokenServer(
        service=DefaultTokenService(rules=rules, device="cpu"),
        host="127.0.0.1").start()
    client = _connected_client(server.bound_port)
    try:
        assert client.request_token(900).status == TokenResultStatus.OK
        injector.arm("cluster.server.frame", "garbage", times=2,
                     garbage=b"\x00\x01\xff")
        tr = client.request_token(900)
        assert tr.status == TokenResultStatus.FAIL
        assert injector.fires("cluster.server.frame") >= 1
        assert _recovers(client), "client never recovered after garbage frames"
        names = [t.name for t in threading.enumerate()]
        assert "sentinel-token-reader" in names
    finally:
        client.stop()
        server.stop()


class _Blackhole:
    """Accepts token-client connections, reads, never replies: a
    connected-but-partitioned token server."""

    def __init__(self):
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._conns = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        self._srv.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                continue
            conn.settimeout(0.1)
            self._conns.append(conn)
            threading.Thread(target=self._drain, args=(conn,),
                             daemon=True).start()

    def _drain(self, conn):
        while not self._stop.is_set():
            try:
                if not conn.recv(4096):
                    return
            except socket.timeout:
                continue
            except OSError:
                return

    def close(self):
        self._stop.set()
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._srv.close()
        self._thread.join(timeout=1.0)


def _entry_once(eng):
    t0 = time.monotonic()
    try:
        with eng.entry("shared"):
            pass
        return False, time.monotonic() - t0
    except BlockException:
        return True, time.monotonic() - t0


def test_partition_mid_traffic_bounded_fallback_and_heal(live_engine):
    """test_chaos.py:509: healthy remote grants; a partition bounded by
    the entry budget, then the breaker's wire-free fast path with local
    enforcement; the heal closes the breaker."""
    eng = live_engine
    eng.cluster_entry_budget_ms = 250
    rules = ClusterFlowRuleManager()
    rules.load_rules("default", [_cluster_rule(900, local_count=1000.0)])
    service = DefaultTokenService(rules=rules, device="cpu")
    server = ClusterTokenServer(service=service, host="127.0.0.1").start()
    blackhole = _Blackhole()
    try:
        st.load_flow_rules([_cluster_rule(900, local_count=3.0)])
        eng.cluster.set_to_client("127.0.0.1", server.bound_port,
                                  request_timeout_s=2.0)
        client = eng.cluster.token_client
        client.health_gate = HealthGate(failure_threshold=2, open_ms=400)
        deadline = time.monotonic() + 5
        while eng.cluster.client_if_active() is None \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.cluster.client_if_active() is not None
        deadline = time.monotonic() + 10
        while client.request_token(900).status != TokenResultStatus.OK \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        client.health_gate.record_success()
        fallbacks0 = eng.cluster_fallback_count

        for _ in range(6):
            blocked, _ = _entry_once(eng)
            assert not blocked
        assert eng.cluster_fallback_count == fallbacks0

        client.port = blackhole.port
        client._drop_connection()
        deadline = time.monotonic() + 5
        while not client.is_connected() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert client.is_connected()
        time.sleep(1.1)

        for _ in range(2):
            blocked, elapsed = _entry_once(eng)
            assert not blocked
            assert elapsed < 1.0, f"entry took {elapsed:.3f}s (budget 250ms)"
        assert client.health_gate.state == STATE_OPEN

        blocked, elapsed = _entry_once(eng)
        assert not blocked and elapsed < 0.1
        blocked, elapsed = _entry_once(eng)
        assert blocked and elapsed < 0.1
        stats = eng.resilience_stats()
        assert stats["clusterFallbackCount"] >= 4
        assert stats["tokenClientBreaker"]["state"] == "OPEN"

        client.port = server.bound_port
        client._drop_connection()
        deadline = time.monotonic() + 5
        while not client.is_connected() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert client.is_connected()
        time.sleep(0.45)
        tr = client.request_token(900)
        assert tr.status == TokenResultStatus.OK
        assert client.health_gate.state == STATE_CLOSED
        blocked, elapsed = _entry_once(eng)
        assert not blocked and elapsed < 1.0
        assert eng.resilience_stats()["tokenClientBreaker"]["state"] \
            == "CLOSED"
    finally:
        blackhole.close()
        eng.cluster.stop()
        server.stop()
