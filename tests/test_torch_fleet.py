"""Fleet telemetry federation in the port (``sentinel_tpu_torch/telemetry/
fleet.py``) against the JAX package's.

Module level: ``FleetView`` of each package federates the same scripted
pages from three fake leaders (seeded cells, a straggler older than the
retention window, a second too fat for a frame, an epoch regression, a
leader that goes quiet); series, status, the settled frontier and fleet
health must be equal, and every fleet cell must be the arithmetic sum of
its leaders' cells.

Engine level: the leader page (``leader_fleet_payload``, its paging, its
fat-second skip, and the population page) encodes to the same bytes from
a JAX engine and a port engine fed the same entries on frozen clocks
(one small engine each). Then three port leaders (engine + token server
each) on loopback: a port ``FleetView`` and a JAX ``FleetView`` over the
same leaders give the same series, and every fleet sum equals the sum of
each leader's own ``timeseries_view`` cell (the reference's contract,
``fleet.py:22-27``). Closing the engine that watches the view stops its
clients.
"""

from __future__ import annotations

import json
import threading
import types

import numpy as np
import pytest

from sentinel_tpu.cluster import codec as jcodec
from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.core.exceptions import BlockException as JBlock
from sentinel_tpu.datasource import converters as JCV
from sentinel_tpu.telemetry import fleet as JF
from sentinel_tpu.utils import time_util as jtu

from sentinel_tpu_torch.cluster import codec as pcodec
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.core.exceptions import BlockException as PBlock
from sentinel_tpu_torch.datasource import converters as PCV
from sentinel_tpu_torch.telemetry import fleet as PF
from sentinel_tpu_torch.utils import time_util as ptu

NOW0 = 1_700_000_000_000
SUM_FIELDS = PF._SUM_FIELDS


class _FakeClient:
    """Serves scripted pages: one list of payload dicts per poll."""

    def __init__(self, pages):
        self.pages = list(pages)

    def is_connected(self):
        return True

    def request_fleet_telemetry(self, since_ms=0, max_seconds=16):
        if not self.pages:
            return None
        return json.loads(json.dumps(self.pages.pop(0)))

    def stop(self):
        pass


def _script(seed, n_polls=6):
    """Per leader, per poll: one page of fresh complete seconds."""
    rng = np.random.default_rng(seed)
    scripts = {}
    for li, name in enumerate(("L1", "L2", "L3")):
        stamp = NOW0
        epoch = 3
        pages = []
        for poll in range(n_polls):
            secs = []
            for _ in range(int(rng.integers(0, 4))):
                stamp += 1000 * int(rng.integers(1, 3))
                res = {}
                for r in ("shared", f"only{li}"):
                    if rng.random() < 0.8:
                        res[r] = {
                            "pass": int(rng.integers(0, 50)),
                            "block": int(rng.integers(0, 20)),
                            "success": int(rng.integers(0, 40)),
                            "exception": int(rng.integers(0, 3)),
                            "rtSumMs": int(rng.integers(0, 900)),
                            "occupiedPass": int(rng.integers(0, 2)),
                            "blockByReason": {"FLOW": int(
                                rng.integers(0, 9))},
                            "rtBuckets": [int(x) for x in rng.integers(
                                0, 5, int(rng.integers(3, 15)))],
                        }
                secs.append({"timestamp": stamp, "resources": res})
            if name == "L2" and poll == 3:
                epoch = 1                      # a restarted leader
            page = {"v": 1, "leader": f"remote-{name}",
                    "nowMs": NOW0 + 1000 * poll + 37 * li,
                    "epoch": epoch, "shard": None,
                    "health": {"instance": int(rng.integers(40, 101))},
                    "lastStampMs": stamp, "seconds": secs,
                    "moreAfterMs": None}
            if name == "L3" and poll == 2:
                page["skippedSecondMs"] = stamp + 1000
                stamp += 1000
            if name == "L1" and poll == 4:
                page["seconds"].append({"timestamp": NOW0 - 900_000,
                                        "resources": {"late": {"pass": 1}}})
            pages.append(page)
        if name == "L3":
            pages = pages[:3]                  # goes quiet after poll 3
        scripts[name] = pages
    return scripts


def _view(mod, scripts, clock):
    return mod.FleetView(
        [(n, "127.0.0.1", 9000 + i) for i, n in enumerate(scripts)],
        clock=clock, stale_ms=2_500, history_seconds=24, max_seconds=4,
        client_factory=lambda h, p, it=iter(scripts.values()):
            _FakeClient(next(it)))


def _assert_sums(series):
    for sec in series:
        for res, cell in sec["resources"].items():
            for f in SUM_FIELDS:
                assert cell["fleet"][f] == sum(
                    int(c.get(f, 0)) for c in cell["leaders"].values())
            buckets = cell["fleet"]["rtBuckets"]
            for i, v in enumerate(buckets):
                assert v == sum(int((c.get("rtBuckets") or [])[i])
                                if i < len(c.get("rtBuckets") or []) else 0
                                for c in cell["leaders"].values())


@pytest.mark.parametrize("seed", [2, 9])
def test_federation_matches_the_reference(seed):
    scripts = _script(seed)
    now = {"ms": NOW0}
    views = [_view(mod, scripts, lambda: now["ms"]) for mod in (JF, PF)]
    for poll in range(6):
        now["ms"] = NOW0 + 1000 * poll
        got = [v.poll() for v in views]
        assert got[1] == got[0]
        outs = [(v.series(), v.series(resource="shared", limit=5),
                 v.status(), v.settled_through_ms(), v.fleet_health())
                for v in views]
        assert outs[1] == outs[0], poll
        _assert_sums(outs[1][0])
    status = views[1].status()
    assert status["leaders"]["L2"]["epochRegressed"] is True
    assert status["leaders"]["L3"]["secondsSkipped"] == 1
    assert status["staleLeaders"] >= 1
    assert status["retainedSeconds"] <= 24
    assert all(s["timestamp"] != NOW0 - 900_000 for s in views[1].series())
    for v in views:
        v.stop()


def test_bad_leader_specs_are_refused_alike():
    for mod in (JF, PF):
        with pytest.raises(ValueError):
            mod.FleetView([], clock=lambda: 0,
                          client_factory=lambda h, p: _FakeClient([]))
        with pytest.raises(ValueError):
            mod.FleetView([("a", "h", 1), {"name": "a", "host": "h",
                                           "port": 2}],
                          clock=lambda: 0,
                          client_factory=lambda h, p: _FakeClient([]))


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


def _fresh_contexts():
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()


@pytest.fixture
def frozen():
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    _fresh_contexts()
    yield
    for tu in (jtu, ptu):
        tu.unfreeze_time()
    _fresh_contexts()


def _drive(eng, block, res, n):
    for _ in range(n):
        try:
            h = eng.entry(res)
        except block:
            continue
        h.exit()


def _rules(cv, *pairs):
    return cv.flow_rules_from_json(json.dumps(
        [{"resource": r, "count": c, "grade": 1} for r, c in pairs]))


def test_leader_pages_encode_the_same_bytes(frozen, monkeypatch):
    """Three recorded seconds on a JAX and a port engine: every page (full,
    paged one second at a time, a fat second skipped, the population
    page) is byte-equal."""
    leaders = []
    for Eng, cv, block, kw in ((JEngine, JCV, JBlock, {"journal_path": ""}),
                               (PEngine, PCV, PBlock, {"device": "cpu"})):
        eng = Eng(capacity=64, **kw)
        eng.flow_rules.load_rules(_rules(cv, ("rA", 3), ("rB", 100)))
        leaders.append((eng, block))
    try:
        for n in (5, 2, 7):
            for eng, block in leaders:
                _drive(eng, block, "rA", n)
                _drive(eng, block, "rB", n + 1)
            for tu in (jtu, ptu):
                tu.advance_time(1000)
        pages = []
        for (eng, _), mod in zip(leaders, (JF, PF)):
            srv = types.SimpleNamespace(
                engine=eng, service=types.SimpleNamespace(epoch=7))
            got = [mod.leader_fleet_payload(srv, 0, 16),
                   mod.leader_fleet_payload(srv, 0, 1),
                   mod.leader_population_payload(srv)]
            view = eng.timeseries_view()
            cursor = view["seconds"][0]["timestamp"]
            got.append(mod.leader_fleet_payload(srv, cursor, 1))
            monkeypatch.setattr(mod, "MAX_ENTITY_BYTES", 400)
            got.append(mod.leader_fleet_payload(srv, 0, 16))
            monkeypatch.undo()
            pages.append((got, view))
        assert pages[1][0] == pages[0][0]
        full, _ = pcodec.decode_json_entity(pages[1][0][0])
        assert full["seconds"] == pages[1][1]["seconds"]
        assert len(full["seconds"]) == 3 and full["epoch"] == 7
        one, _ = pcodec.decode_json_entity(pages[1][0][1])
        assert one["moreAfterMs"] == full["seconds"][0]["timestamp"]
        fat, _ = pcodec.decode_json_entity(pages[1][0][4])
        assert fat["seconds"] == [] and fat["skippedSecondMs"] == \
            full["seconds"][0]["timestamp"]
        pop, _ = jcodec.decode_json_entity(pages[0][0][2])
        assert "population" in pop
    finally:
        for eng, _ in leaders:
            eng.close()


def test_three_port_leaders_federate_exactly(frozen):
    """Three port leaders on loopback; a port FleetView (watched by the
    first leader's engine) and a JAX FleetView over the same sockets:
    the same federated series, every fleet sum the sum of the leaders'
    own cells, and closing the watching engine stops its clients."""
    mesh = {"L1": [("only1", 2), ("shared", 3)],
            "L2": [("only2", 4), ("shared", 2)],
            "L3": [("only3", 1)]}
    engines, servers = {}, {}
    before = set(threading.enumerate())
    views = []
    try:
        for name, rules in mesh.items():
            eng = PEngine(capacity=64, device="cpu")
            eng.flow_rules.load_rules(_rules(PCV, *rules))
            engines[name] = eng
            servers[name] = ClusterTokenServer(
                engine=eng, host="127.0.0.1", port=0).start()
        for t in range(3):
            _drive(engines["L1"], PBlock, "only1", 4)
            _drive(engines["L1"], PBlock, "shared", 5)
            _drive(engines["L2"], PBlock, "only2", 6 + t)
            _drive(engines["L2"], PBlock, "shared", 4)
            _drive(engines["L3"], PBlock, "only3", 3)
            ptu.advance_time(1000)
        specs = [(n, "127.0.0.1", servers[n].bound_port) for n in mesh]
        clock = engines["L1"].now_ms
        views = [mod.FleetView(specs, clock=clock, stale_ms=10_000)
                 for mod in (PF, JF)]
        engines["L1"].fleet = views[0]
        for v in views:
            assert v.wait_connected()
        polled = [v.poll() for v in views]
        assert polled[0] == polled[1] and all(n > 0 for n in
                                              polled[0].values())
        series = [v.series() for v in views]
        assert series[0] == series[1]
        truth = {n: {s["timestamp"]: s["resources"]
                     for s in e.timeseries_view()["seconds"]}
                 for n, e in engines.items()}
        shared_twice = 0
        for sec in series[0]:
            for res, cell in sec["resources"].items():
                for f in SUM_FIELDS:
                    assert cell["fleet"][f] == sum(
                        int(truth[n][sec["timestamp"]][res].get(f, 0))
                        for n in cell["leaders"])
                for n, c in cell["leaders"].items():
                    assert c == truth[n][sec["timestamp"]][res]
                if res == "shared" and len(cell["leaders"]) == 2:
                    shared_twice += 1
        assert shared_twice == 3
        st = views[0].status()
        assert st["leaderCount"] == 3 and st["staleLeaders"] == 0
        assert st["settledThroughMs"] >= series[0][-1]["timestamp"]
        assert all(v == 0 for v in views[0].poll().values())
    finally:
        for eng in engines.values():
            eng.close()
        for srv in servers.values():
            srv.stop()
        for v in views[1:]:
            v.stop()
    assert engines["L1"].fleet is None
    for ls in views[0]._leaders.values():
        assert not ls.client.is_connected()
    leftover = [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
    for t in leftover:
        t.join(timeout=5)
    assert not [t.name for t in leftover if t.is_alive()]
