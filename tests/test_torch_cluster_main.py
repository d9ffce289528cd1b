"""The standalone token server (``python -m sentinel_tpu_torch.cluster``,
``sentinel_tpu_torch/cluster/__main__.py``), the datasource seams of the
fault injector, and the device policy of what a connector feeds, on the
CPU.

- ``datasource.read`` is a fault point of the port, fired where the JAX
  package fires it: one seeded schedule armed in both packages fails the
  same reads with the same errors, through ``AbstractDataSource`` and the
  poll connectors' content-dedup read, and backs the poll loop off alike.
- The two scenarios that waited for this module:
  ``tests/test_chaos_campaign.py:358`` (the datasource flap seam) and
  ``tests/test_cluster_ha.py:730`` (the standalone HA participant's
  map-file flip), on the port.
- ``StandaloneTokenServer`` of each package, fed the same rules file and
  the same edits, answers a client's acquires with the same
  ``TokenResult``s (``tests/test_cluster.py:372`` on both packages, each
  on its own package's frozen clock).
- The module entry point: with ``--device cpu`` it serves an acquire over
  the wire; with no card and no ``--device`` it exits non-zero with the
  device error. An engine that a connector feeds raises the same way.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests.test_torch_support import ds_pkgs, tr_tuple, wait_for

J, P = ds_pkgs()
NOW0 = 1_700_000_000_000
SEED = 1234
REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture()
def clocks():
    for M in (J, P):
        M.tu.freeze_time(NOW0)
    yield
    for M in (J, P):
        M.tu.unfreeze_time()


# ---------------------------------------------------------------------------
# The datasource.read fault point
# ---------------------------------------------------------------------------


def list_source(M, **kw):
    class ListSource(M.base.AutoRefreshDataSource):
        def read_source(self):
            return ["a"]

    return ListSource(converter=lambda s: s, **kw)


def dedup_source(M):
    class DedupSource(M.base.ContentDedupPollMixin,
                      M.base.AutoRefreshDataSource):
        n = 0

        def read_source(self):
            self.n += 1
            return json.dumps([{"resource": f"r{self.n // 2}"}])

    return DedupSource(converter=M.conv.flow_rules_from_json)


def test_datasource_read_fault_point_parity(clocks):
    """One seeded ``datasource.read`` schedule in both packages: the same
    reads fail, with the same error and point, through the plain and the
    content-dedup ``load_config``; the poll loop's backoff and
    ``last_success_ms`` follow the same failures."""
    seen = []
    for M in (J, P):
        assert "datasource.read" in M.faults.FAULT_POINTS
        plain, dedup = list_source(M), dedup_source(M)
        looped = list_source(M, recommend_refresh_ms=100,
                             retry_policy=M.resilience.RetryPolicy(
                                 base_ms=100, max_ms=1000, multiplier=2.0,
                                 jitter="none"))
        looped.first_load()
        log = []
        with M.resilience.FaultInjector(seed=SEED) as inj:
            inj.arm("datasource.read", "error", probability=0.5, after=1,
                    times=6)
            for _ in range(10):
                for src in (plain, dedup):
                    try:
                        got = src.load_config()
                        log.append(("ok", None if got is None else len(got)))
                    except M.resilience.FaultInjected as ex:
                        log.append(("err", type(ex).__name__, str(ex),
                                    ex.point))
                log.append(("wait", looped._poll_once(),
                            looped.consecutive_failures,
                            looped.last_success_ms))
            fires = inj.fires("datasource.read")
        seen.append((log, fires))
    assert seen[0] == seen[1]
    assert seen[1][1] == 6
    assert any(e[0] == "err" for e in seen[1][0])


def test_datasource_flap_seam_backs_off_like_a_failure(clocks):
    """tests/test_chaos_campaign.py:358 on the port: a flap fails the
    poll with no read; the next cadence tick catches up."""

    class Src(P.base.AutoRefreshDataSource):
        def __init__(self):
            super().__init__(converter=lambda s: s, recommend_refresh_ms=100)
            self.reads = 0

        def read_source(self):
            self.reads += 1
            return ["v"]

    src = Src()
    src.first_load()
    reads_before = src.reads
    with P.resilience.FaultInjector(seed=1) as inj:
        inj.arm("datasource.flap", "error", times=1)
        src._poll_once()
        assert src.reads == reads_before
        assert src.consecutive_failures == 1
        src._poll_once()
        assert src.reads == reads_before + 1
        assert src.consecutive_failures == 0


# ---------------------------------------------------------------------------
# The standalone HA participant (tests/test_cluster_ha.py:730)
# ---------------------------------------------------------------------------


def ok_with_retry(request, timeout_s: float = 15.0):
    t0 = time.monotonic()
    r = request()
    while r.status != P.CC.TokenResultStatus.OK \
            and time.monotonic() - t0 < timeout_s:
        time.sleep(0.05)
        r = request()
    return r


def test_standalone_ha_participant_file_map_flip(tmp_path, clocks):
    port = free_port()
    map_path = tmp_path / "map.json"
    rules_path = tmp_path / "rules.json"
    rules_path.write_text(json.dumps({
        "default": [{"resource": "r", "count": 4, "clusterMode": True,
                     "clusterConfig": {"flowId": 800, "thresholdType": 1}}]}))
    map_path.write_text(json.dumps({
        "epoch": 1,
        "servers": [{"machineId": "A", "host": "127.0.0.1", "port": port},
                    {"machineId": "B", "host": "127.0.0.1",
                     "port": free_port()}]}))
    part = P.main.StandaloneHAParticipant(
        map_path=str(map_path), machine_id="A", rules_path=str(rules_path),
        checkpoint_path=str(tmp_path / "ck.npz"), refresh_ms=3_600_000,
        host="127.0.0.1", device="cpu")
    part.start()
    try:
        stats = part.state.ha_stats()
        assert stats["roleName"] == "SERVER" and stats["epoch"] == 1
        assert part.state.token_server.service.device == torch.device("cpu")
        client = P.client.ClusterTokenClient("127.0.0.1", port,
                                             health_gate=None).start()
        try:
            assert wait_for(client.is_connected)
            r = ok_with_retry(lambda: client.request_token(800))
            assert r.status == P.CC.TokenResultStatus.OK
        finally:
            client.stop()
        map_path.write_text(json.dumps({
            "epoch": 2, "leader": "B",
            "servers": [{"machineId": "A", "host": "127.0.0.1", "port": port},
                        {"machineId": "B", "host": "127.0.0.1",
                         "port": free_port()}]}))
        part.refresh()
        stats = part.state.ha_stats()
        assert stats["roleName"] == "CLIENT" and stats["epoch"] == 2
    finally:
        part.stop()


# ---------------------------------------------------------------------------
# StandaloneTokenServer: the port against the JAX package
# ---------------------------------------------------------------------------


RULES_V1 = {
    "ns-a": [{"resource": "getUser", "count": 3, "clusterMode": True,
              "clusterConfig": {"flowId": 900, "thresholdType": 1}}],
    "ns-b": [{"resource": "getItem", "count": 1, "clusterMode": True,
              "clusterConfig": {"flowId": 901, "thresholdType": 1}}],
}
RULES_V2 = {
    "ns-a": [{"resource": "getUser", "count": 5, "clusterMode": True,
              "clusterConfig": {"flowId": 900, "thresholdType": 1}}],
}


def standalone_run(M, tmp_path):
    """tests/test_cluster.py:372 on package ``M``: what a client of the
    ``ns-a`` namespace is answered before and after the rules file drops
    ``ns-b`` and raises ``ns-a``'s count."""
    path = tmp_path / f"rules-{M.name}.json"
    path.write_text(json.dumps(RULES_V1))
    srv = M.main.StandaloneTokenServer(port=0, host="127.0.0.1",
                                       rules_path=str(path),
                                       refresh_ms=3_600_000, **M.kw)
    srv.start()
    # Warm the width-1 acquire off the wire (the JAX service compiles it).
    srv.service.request_tokens([(None, 0, False)])
    client = M.client.ClusterTokenClient("127.0.0.1", srv.bound_port,
                                         "ns-a").start()
    out = []
    try:
        assert wait_for(client.is_connected, 3.0)
        out += [tr_tuple(client.request_token(900)) for _ in range(4)]
        out.append(tr_tuple(client.request_token(901)))
        path.write_text(json.dumps(RULES_V2))
        srv.refresh()
        out.append(tr_tuple(client.request_token(901)))
        M.tu.advance_time(1100)
        out += [tr_tuple(client.request_token(900)) for _ in range(6)]
        loaded = {ns: len(srv.service.rules.get_rules(ns))
                  for ns in srv.service.rules.namespaces()}
    finally:
        client.stop()
        srv.stop()
    return out, loaded


def test_standalone_server_matches_the_reference(tmp_path, clocks):
    (jout, jloaded), (pout, ploaded) = (standalone_run(M, tmp_path)
                                        for M in (J, P))
    assert pout == jout and ploaded == jloaded
    S = P.CC.TokenResultStatus
    statuses = [t[0] for t in pout]
    assert statuses[:4].count(S.OK) == 3 and statuses[3] == S.BLOCKED
    assert statuses[4] == S.OK and statuses[5] == S.NO_RULE_EXISTS
    assert statuses[6:].count(S.OK) == 5


def test_standalone_server_rejects_bad_rules_file(tmp_path):
    """tests/test_cluster.py:420 and :430 on the port: the parser refuses
    a malformed document, and ``start()`` fails fast on a missing or bad
    file."""
    parse = P.main.parse_namespace_rules
    with pytest.raises(ValueError):
        parse("[1, 2]")
    with pytest.raises(ValueError):
        parse('{"ns": 5}')
    assert parse('{"ns": []}') == {"ns": []}
    missing = P.main.StandaloneTokenServer(
        port=0, host="127.0.0.1", rules_path=str(tmp_path / "nope.json"),
        device="cpu")
    with pytest.raises(OSError):
        missing.start()
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    srv = P.main.StandaloneTokenServer(port=0, host="127.0.0.1",
                                       rules_path=str(bad), device="cpu")
    with pytest.raises(ValueError):
        srv.start()


# ---------------------------------------------------------------------------
# The module entry point and the device policy
# ---------------------------------------------------------------------------


def module_env(**extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(extra)
    return env


def test_module_entry_point_serves_on_cpu(tmp_path):
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(RULES_V1))
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sentinel_tpu_torch.cluster", "--device",
         "cpu", "--rules", str(rules), "--port", str(port), "--host",
         "127.0.0.1"], cwd=REPO, env=module_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    client = None
    try:
        line = proc.stdout.readline()
        assert line.startswith(f"token server listening on 127.0.0.1:{port}")
        assert "'ns-a': 1" in line and "'ns-b': 1" in line
        client = P.client.ClusterTokenClient("127.0.0.1", port,
                                             "ns-a").start()
        assert wait_for(client.is_connected)
        r = ok_with_retry(lambda: client.request_token(900))
        assert r.status == P.CC.TokenResultStatus.OK
    finally:
        if client is not None:
            client.stop()
        proc.terminate()
        proc.communicate(timeout=30)


def test_module_entry_point_without_a_card_exits_with_the_device_error(
        tmp_path):
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(RULES_V1))
    proc = subprocess.run(
        [sys.executable, "-m", "sentinel_tpu_torch.cluster", "--rules",
         str(rules), "--port", str(free_port())], cwd=REPO,
        env=module_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "listening" not in proc.stdout


def test_an_engine_fed_by_a_connector_has_no_cpu_fallback(tmp_path,
                                                          monkeypatch):
    """With no card and no device given, the default engine a connector
    pushes into raises on its construction; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(P.st, "_default_engine", None)
    path = tmp_path / "flow.json"
    path.write_text(json.dumps([{"resource": "r", "count": 1}]))
    src = P.base.FileRefreshableDataSource(str(path),
                                           P.conv.flow_rules_from_json)
    P.ds.bind(src, P.st.load_flow_rules)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        src.refresh(force=True)
    assert P.st._default_engine is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main.StandaloneTokenServer(port=0, rules_path=str(path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main.StandaloneHAParticipant(map_path=str(path), machine_id="A")
