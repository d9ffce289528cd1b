"""The SLO engine in the port (``sentinel_tpu_torch/slo/``) against the JAX
package's.

Module level (no engine): ``tests/test_slo.py``'s randomized gappy series
(availability and latency objectives, a storm phase, an anomaly spike on
an objective-less resource) goes through one manager of each package;
after every second the status (burn values, firing flags, EWMA baselines,
health) and the alert store must be equal, and the run must fire burn and
anomaly alerts. The health composition, the converters (round trips and
validation errors) and the webhook (the same POST bodies to a loopback
server, a failed first attempt retried, the bounded queue) are held the
same way.

Engine level (one JAX engine and one port engine on one injected clock,
``tests/test_torch_rollout.py``'s twin): a flow-limited burst burns an
availability objective end to end (``test_slo.py:307``), and the
page-severity alert aborts a staged candidate on the next guardrail tick
(``test_slo.py:475``). Every batch's decisions and state are compared.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from sentinel_tpu.datasource import converters as JCV
from sentinel_tpu.slo import manager as JM
from sentinel_tpu.slo import objectives as JO
from sentinel_tpu.slo import webhook as JW
from sentinel_tpu.utils import time_util as jtu

from sentinel_tpu_torch.datasource import converters as PCV
from sentinel_tpu_torch.slo import manager as PM
from sentinel_tpu_torch.slo import objectives as PO
from sentinel_tpu_torch.slo import webhook as PW
from sentinel_tpu_torch.telemetry.attribution import (NUM_RT_BUCKETS,
                                                      RT_BUCKET_EDGES_MS)
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_rollout import Twin

BASE_MS = 1_700_000_000_000
_EDGES = np.asarray(RT_BUCKET_EDGES_MS, np.int64)
SIDES = ((JM, JO, JCV, JW), (PM, PO, PCV, PW))


@pytest.fixture
def frozen():
    for tu in (jtu, ptu):
        tu.freeze_time(BASE_MS)
    yield
    for tu in (jtu, ptu):
        tu.unfreeze_time()


def _rand_buckets(rng, n):
    buckets = np.zeros(NUM_RT_BUCKETS, np.int64)
    for _ in range(n):
        rt = int(rng.integers(1, 5000))
        buckets[int(np.sum(rt > _EDGES))] += 1
    return buckets


def _series(seed, seconds=400):
    """``tests/test_slo.py``'s stream: (stamp, cells) with idle gaps, a
    storm on "api" and a full-block spike on objective-less "free"."""
    rng = np.random.default_rng(seed)
    stamp = BASE_MS
    out = []
    for k in range(seconds):
        stamp += 1000 * int(rng.integers(1, 3))
        storm = 150 <= k < 200
        cells = {}
        total = int(rng.integers(0, 30))
        if total:
            block = int(rng.binomial(total, 0.4 if storm else 0.02))
            cells["api"] = {
                "pass": total - block, "block": block,
                "rtBuckets": _rand_buckets(
                    rng, int(rng.integers(0, 20))).tolist(),
            }
        ftotal = 30 if k == 350 else int(rng.integers(5, 40))
        fblock = ftotal if k == 350 else int(rng.binomial(ftotal, 0.05))
        cells["free"] = {
            "pass": ftotal - fblock, "block": fblock,
            "rtBuckets": _rand_buckets(
                rng, int(rng.integers(1, 15))).tolist(),
        }
        out.append((stamp, cells))
    return out


def _objectives(O):
    return [
        O.SloObjective(resource="api", objective=0.95, min_events=5,
                       windows=(O.BurnWindow(30, 5, 3.0, "page"),
                                O.BurnWindow(120, 30, 1.5, "ticket"))),
        O.SloObjective(resource="api", sli="latency", objective=0.9,
                       latency_ms=8, min_events=5, name="api-rt",
                       windows=(O.BurnWindow(20, 4, 2.0, "page"),)),
    ]


def _view(slo):
    status = slo.status()
    return status, slo.alerts_snapshot()


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_burn_baselines_and_alerts_match_the_reference(frozen, seed):
    """Every evaluated second: the same burn values, firing flags, EWMA
    state, health and alert transitions."""
    managers = []
    for M, O, _, _ in SIDES:
        slo = M.SloManager()
        slo.load_objectives(_objectives(O))
        managers.append(slo)
    fired = set()
    for stamp, cells in _series(seed):
        views = []
        for slo in managers:
            slo.ingest(stamp, json.loads(json.dumps(cells)))
            slo.evaluate(stamp + 1000)
            views.append(_view(slo))
        assert views[1] == views[0], stamp
        fired.update(a["kind"] for a in views[1][1]["active"])
    assert fired == {"burn_rate", "anomaly"}
    final = managers[1].alerts_snapshot()
    assert final["counters"] == managers[0].alerts_snapshot()["counters"]
    assert final["counters"]["fired"] > 0 and final["counters"]["resolved"] > 0


def test_objective_reload_and_timebase_reset_match(frozen):
    """Reloads keep unchanged objectives' series, resolve removed ones'
    alerts; a timebase reset clears the stamp-bearing state and keeps the
    transition log."""
    managers = []
    for M, O, _, _ in SIDES:
        slo = M.SloManager()
        slo.load_objectives(_objectives(O))
        managers.append(slo)
    stream = _series(7, seconds=220)
    out = [[], []]
    for i, (stamp, cells) in enumerate(stream):
        for side, slo in enumerate(managers):
            O = SIDES[side][1]
            if i == 180:
                slo.load_objectives(_objectives(O)[:1])
            if i == 200:
                slo.reset_timebase()
            slo.ingest(stamp, json.loads(json.dumps(cells)))
            slo.evaluate(stamp + 1000)
            if i in (179, 181, 199, 201, 219):
                out[side].append(_view(slo))
    assert out[1] == out[0]


def test_health_scores_compose_alike():
    res = []
    for M, _, _, _ in SIDES:
        slo = M.SloManager()
        with slo._lock:
            slo._transition("p", True, 0, {
                "key": "p", "kind": "burn_rate", "severity": "page",
                "resource": "a"})
            slo._transition("t", True, 0, {
                "key": "t", "kind": "burn_rate", "severity": "ticket",
                "resource": "a"})
            slo._transition("z", True, 0, {
                "key": "z", "kind": "anomaly", "severity": "anomaly",
                "resource": "b", "signal": "blockRate"})
        steps = [slo.health_scores()]
        for rate in (0.25, 0.9):
            slo.shed_rate = rate
            steps.append(slo.health_scores())
        with slo._lock:
            slo._transition("p", False, 1, {})
        slo.shed_rate = 0.0
        steps.append(slo.health_scores())
        steps.append(slo.alerts_snapshot())
        steps.append(slo.abort_signal())
        steps.append(slo.active_alerts_on({"b"}))
        res.append(steps)
    assert res[1] == res[0]
    assert res[1][0]["resources"] == {"a": 40, "b": 85}


GOOD = [
    {"resource": "a", "objective": 0.999},
    {"resource": "a", "sli": "latency", "objective": 0.99,
     "latencyMs": 5, "name": "a-rt",
     "windows": [{"longSeconds": 30, "shortSeconds": 5,
                  "burnRate": 2, "severity": "ticket"}]},
    {"resource": "b", "sli": "latency", "objective": 0.5,
     "latencyMs": 100000, "minEvents": 0},
]
BAD = [
    [{"resource": "", "objective": 0.9}],
    [{"resource": "r", "objective": 1.0}],
    [{"resource": "r", "sli": "weird"}],
    [{"resource": "r", "windows": []}],
    [{"resource": "r", "windows": [
        {"longSeconds": 5, "shortSeconds": 9, "burnRate": 1}]}],
    [{"resource": "r", "windows": [
        {"longSeconds": 9, "shortSeconds": 5, "burnRate": 1,
         "severity": "nope"}]}],
    [{"resource": "r", "sli": "latency", "latencyMs": 0}],
    [{"resource": "r", "minEvents": -1}],
    [{"resource": "r", "windows": [
        {"longSeconds": 9, "shortSeconds": 5, "burnRate": 0}]}],
    ["not an object"],
    {"resource": "r"},
]


def test_slo_converters_round_trip_and_reject_alike():
    outs = []
    for _, _, CV, _ in SIDES:
        objs = CV.slo_objectives_from_json(json.dumps(GOOD))
        text = CV.slo_objectives_to_json(objs)
        assert CV.slo_objectives_from_json(text) == objs
        errors = []
        for bad in BAD:
            with pytest.raises(ValueError) as ex:
                CV.slo_objectives_from_json(json.dumps(bad))
            errors.append(str(ex.value))
        outs.append((text, [CV.slo_objective_to_dict(o) for o in objs],
                     errors))
    assert outs[1] == outs[0]
    assert outs[1][1][1]["effectiveLatencyMs"] == 8
    for M, _, CV, _ in SIDES:
        with pytest.raises(ValueError):
            M.SloManager().load_objectives(CV.slo_objectives_from_json(
                json.dumps([{"resource": "r"}, {"resource": "r"}])))


class _Hook(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n)
        code = self.server.responses.pop(0) if self.server.responses else 200
        if 200 <= code < 300:
            self.server.received.append(body)
        self.send_response(code)
        self.end_headers()

    def log_message(self, fmt, *args):
        pass


def _hook_server(responses=None):
    srv = HTTPServer(("127.0.0.1", 0), _Hook)
    srv.received = []
    srv.responses = list(responses or [])
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _wait(pred, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_webhook_posts_the_same_bodies_and_retries():
    """Both packages' webhooks deliver byte-equal bodies to a loopback
    endpoint, the first attempt answered 503 and retried; the bounded
    queue drops its oldest events alike. The worker thread stops."""
    got = []
    for _, _, _, W in SIDES:
        hook = _hook_server(responses=[503, 200])
        wh = W.AlertWebhook(
            urls=[f"http://127.0.0.1:{hook.server_port}/hook"],
            timeout_ms=2000, retries=2)
        try:
            for i in range(3):
                wh.submit({"seq": i + 1, "type": "fired",
                           "timestamp": BASE_MS + i,
                           "alert": {"key": f"k{i}", "resource": "r"},
                           "source": "app"})
            assert _wait(lambda: len(hook.received) == 3)
            assert _wait(lambda: wh.stats()["delivered"] == 3)
            stats = wh.stats()
        finally:
            wh.stop()
            hook.shutdown()
            hook.server_close()
        assert not wh._thread.is_alive()
        got.append((hook.received, stats))
        full = W.AlertWebhook(urls=["http://127.0.0.1:1/x"], retries=0,
                              timeout_ms=50)
        full._thread = threading.Thread(target=lambda: None)
        for i in range(W.QUEUE_CAPACITY + 5):
            full.submit({"seq": i})
        got.append(full.stats())
    assert got[2] == got[0] and got[3] == got[1]
    assert got[3]["dropped"] == 5


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    tw = Twin(capacity=128)
    yield tw
    tw.close()


@pytest.fixture
def twin(pair):
    pair.fresh()
    for eng in pair.engines:
        eng.slo.load_objectives([])
        eng.slo.rollout_abort_enabled = True
    return pair


def _load_objective(twin):
    for eng, O in ((twin.j, JO), (twin.p, PO)):
        eng.slo.load_objectives([O.SloObjective(
            resource="drill", objective=0.9, min_events=1,
            windows=(O.BurnWindow(10, 2, 2.0, "page"),))])


def _drive_breach(twin, seconds=6, per_sec=6):
    """Flow-limit "drill" to 1 QPS, drive per_sec entries a second, then
    refresh judgement past the last complete second on both engines."""
    twin.load("flow", [{"resource": "drill", "count": 1}])
    start = twin.clock.now
    for s in range(seconds):
        twin.clock.now = start + 1000 * s
        twin.check([("drill", "", None)] * per_sec)
    twin.clock.now = start + 1000 * seconds
    for eng in twin.engines:
        eng.slo_refresh(now_ms=twin.clock.now)
    return twin.clock.now


def _alerts(eng):
    snap = eng.slo.alerts_snapshot()
    snap.pop("webhook")
    return snap, eng.slo.status(), eng.journal.tail(kind="sloTransition")


def test_alert_fires_end_to_end(twin):
    """One induced breach: the same active page alert, transitions,
    health, burn snapshot and journal mirror on both engines."""
    _load_objective(twin)
    _drive_breach(twin)
    j, p = (_alerts(eng) for eng in twin.engines)
    assert p == j
    snap = p[0]
    assert len(snap["active"]) == 1
    alert = snap["active"][0]
    assert alert["kind"] == "burn_rate" and alert["severity"] == "page"
    assert alert["resource"] == "drill"
    assert snap["events"][-1]["type"] == "fired"
    assert snap["health"]["resources"]["drill"] == 60


def test_slo_breach_aborts_rollout(twin):
    """A page-severity burn alert on a touched resource aborts the
    candidate at the next tick on both engines; an untouched one rides
    on; the kill switch disables the gate."""
    _load_objective(twin)
    cand = {"flow": [{"resource": "drill", "count": 50}]}
    twin.candidate("cand", cand, stage="shadow")
    now = _drive_breach(twin)
    outs = [eng.rollout.tick(now_ms=now) for eng in twin.engines]
    assert outs[1] == outs[0]
    assert outs[1]["status"] == "aborted"
    assert outs[1]["sloBreaches"][0]["resource"] == "drill"
    for eng in twin.engines:
        assert eng.rollout.active_name is None
        assert "slo:" in eng.rollout._sets["cand"].ended_reason
    twin.candidate("other", {"flow": [
        {"resource": "unrelated", "count": 5}]}, stage="shadow")
    outs = [eng.rollout.tick(now_ms=now) for eng in twin.engines]
    assert outs[1] == outs[0] and outs[1].get("status") != "aborted"
    for eng in twin.engines:
        eng.rollout.abort("other")
        eng.slo.rollout_abort_enabled = False
    twin.candidate("cand2", cand, stage="shadow")
    outs = [eng.rollout.tick(now_ms=now) for eng in twin.engines]
    assert outs[1] == outs[0] and outs[1].get("status") != "aborted"
    assert [r["kind"] for r in twin.p.journal.tail()] == \
        [r["kind"] for r in twin.j.journal.tail()]
