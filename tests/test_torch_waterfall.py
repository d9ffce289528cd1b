"""The latency waterfall in the port (``sentinel_tpu_torch/telemetry/
waterfall.py``) against the JAX package's.

Module level (no engine): the O(1) bucketer against both packages' linear
scans on every edge and a dense sweep (``tests/test_waterfall.py:41``);
``test_waterfall.py:108``'s scripted stream of wire and pipeline
observations folds into one recorder of each package on one injected
clock, and the sealed seconds, cumulative histograms, exemplars,
reconciliation and sentry state must be equal; the regression sentry's
fire / resolve cycle and its min-events floor give the same transitions.

Engine level (one JAX engine and one port engine, both clocks frozen): a
sustained ``wire.device`` breach fed through ``engine.waterfall`` pages
through the SLO store (``test_waterfall.py:306``) on both, and removing
the budget resolves it; ``set_clock`` drops the staged seconds. The
port's own paths: traced wire requests through its token server reconcile
(stage sums = RTT sums) and their exemplars resolve to the service's
stitched spans; the pipeline's harvests land one per cycle in the
pipeline lane. Lint: no wall-clock read in the port's ``waterfall.py``,
and its keys read only in ``core/config.py``.
"""

from __future__ import annotations

import re
import socket
import threading
from pathlib import Path

import numpy as np
import pytest

from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.telemetry import attribution as JA
from sentinel_tpu.telemetry import waterfall as JWF
from sentinel_tpu.utils import time_util as jtu

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.cluster import codec
from sentinel_tpu_torch.cluster.constants import MSG_FLOW, TokenResultStatus
from sentinel_tpu_torch.cluster.rules import ClusterFlowRuleManager
from sentinel_tpu_torch.cluster.server import ClusterTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.telemetry import attribution as PA
from sentinel_tpu_torch.telemetry import waterfall as PWF
from sentinel_tpu_torch.telemetry.spans import new_trace_context
from sentinel_tpu_torch.utils import time_util as ptu

from tests.test_torch_journal import WALL, _code_lines

REPO = Path(__file__).resolve().parents[1]
BASE_MS = 1_700_000_100_000
FLOW_ID = 8400
MODS = (JWF, PWF)


def test_fast_bucket_matches_both_linear_scans():
    assert PA.WF_BUCKET_EDGES_MS == JA.WF_BUCKET_EDGES_MS
    assert PA.NUM_WF_BUCKETS == JA.NUM_WF_BUCKETS
    rng = np.random.default_rng(7)
    probes = [0.0, -1.0, 1e-9, 1e9]
    for e in PA.WF_BUCKET_EDGES_MS:
        probes += [e, np.nextafter(e, 0), np.nextafter(e, np.inf)]
    probes += list(rng.uniform(0.0, PA.WF_BUCKET_EDGES_MS[-1] * 4, 20_000))
    probes += list(np.exp(rng.uniform(np.log(1e-4), np.log(1e5), 20_000)))
    for v in probes:
        v = float(v)
        want = JA.bucket_index_of(v)
        assert PWF._fast_bucket(v) == want, v
        assert PA.bucket_index_of(v) == want, v
        assert JWF._fast_bucket(v) == want, v


def _scripted_stream(seed, n_secs, max_rps):
    """``tests/test_waterfall.py``'s stream: [(sec_ms, kind, durations,
    trace id or None)], with negative durations on the clamp path."""
    rng = np.random.default_rng(seed)
    events = []
    for si in range(n_secs):
        sec = BASE_MS + si * 1000
        for _ in range(int(rng.integers(1, max_rps + 1))):
            durs = np.exp(rng.uniform(np.log(1e-3), np.log(500.0), 8))
            if rng.random() < 0.05:
                durs[int(rng.integers(0, 8))] = -1.0
            tid = (f"{int(rng.integers(1 << 62)):032x}"
                   if rng.random() < 0.3 else None)
            events.append((sec, "wire", [float(d) for d in durs], tid))
        for _ in range(int(rng.integers(0, max_rps // 2 + 1))):
            events.append((sec, "pipeline",
                           [float(np.exp(rng.uniform(-5, 5))),
                            float(np.exp(rng.uniform(-5, 5)))], None))
        for _ in range(int(rng.integers(0, 4))):
            events.append((sec, "batch", [float(rng.uniform(0, 30))],
                           int(rng.integers(1, 64))))
    return events


def _replay(mod, events, n_secs, sink):
    clock = {"now": BASE_MS}
    wf = mod.WaterfallRecorder(now_ms=lambda: clock["now"], transition=sink)
    for sec, kind, durs, extra in events:
        clock["now"] = sec + 137
        if kind == "wire":
            wf.observe_wire(durs, trace_id=extra)
        elif kind == "pipeline":
            wf.observe_pipeline(durs[0], durs[1])
        else:
            wf.observe_batch(durs[0], extra)
        if sec > BASE_MS:
            wf.roll(sec)
    clock["now"] = BASE_MS - 5_000            # a late observation
    wf.observe_wire([1.0] * 8)
    clock["now"] = BASE_MS + (n_secs + 1) * 1000
    wf.roll(clock["now"])
    return wf


@pytest.mark.parametrize("seed,n_secs,max_rps", [(5, 20, 40), (17, 30, 80)])
def test_fold_and_exemplars_match_the_reference(seed, n_secs, max_rps):
    events = _scripted_stream(seed, n_secs, max_rps)
    out = []
    for mod in MODS:
        trans = []
        wf = _replay(mod, events, n_secs,
                     lambda *a, t=trans: t.append(a))
        out.append((wf.snapshot(limit=n_secs + 5), wf.export_state(), trans))
    assert out[1] == out[0]
    snap = out[1][0]
    n_wire = sum(1 for e in events if e[1] == "wire")
    assert snap["observedRequests"] == n_wire
    assert snap["lateDrops"] == 1
    assert snap["exemplarsCaptured"] > 0
    assert snap["reconciliation"]["relativeError"] <= 1e-9


def _sentry_feed(wf, clock, secs, device_ms, per_sec=60):
    for _ in range(secs):
        for _ in range(per_sec):
            wf.observe_wire([0.1, 0.1, 0.1, 0.1, device_ms, 0.1, 0.1, 0.1])
        clock["now"] += 1000
        wf.roll(clock["now"])


@pytest.mark.parametrize("per_sec", [60, 5])
def test_sentry_transitions_match(per_sec):
    """A sustained breach pages (at 60 requests a second; 5 stay under
    the min-events floor), the recovery resolves: same transitions."""
    out = []
    for mod in MODS:
        trans = []
        clock = {"now": BASE_MS}
        wf = mod.WaterfallRecorder(now_ms=lambda: clock["now"],
                                   transition=lambda *a: trans.append(a))
        budget = wf.sentry.budgets["wire.device"]
        _sentry_feed(wf, clock, 8, budget * 4, per_sec)
        if per_sec == 60:
            _sentry_feed(wf, clock, 70, 0.5, per_sec)
        out.append((trans, wf.sentry.snapshot()))
    assert out[1] == out[0]
    fired = [t for t in out[1][0] if t[1]]
    if per_sec == 60:
        assert fired and fired[0][3]["kind"] == "waterfall_budget"
        assert out[1][0][-1][1] is False
    else:
        assert not fired


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    for tu in (jtu, ptu):
        tu.freeze_time(BASE_MS)
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()
    j = JEngine(capacity=64, journal_path="")
    p = PEngine(capacity=64, device="cpu")
    yield j, p
    for eng in (p, j):
        eng.close()
    for tu in (jtu, ptu):
        tu.unfreeze_time()


def _alerts(eng):
    snap = eng.slo.alerts_snapshot()
    snap.pop("webhook")
    return snap


def test_sentry_alert_lands_in_the_slo_store(engines):
    out = []
    for eng, tu in zip(engines, (jtu, ptu)):
        wf = eng.waterfall
        budget = wf.sentry.budgets["wire.device"]
        now = BASE_MS
        for _ in range(8):
            tu.freeze_time(now)
            for _ in range(60):
                wf.observe_wire([0.1, 0.1, 0.1, 0.1, budget * 4,
                                 0.1, 0.1, 0.1])
            now += 1000
            tu.freeze_time(now)
            eng.slo_refresh(now_ms=now)
        fired = _alerts(eng)
        health = eng.slo.health_scores()
        wf.sentry.set_budgets({"wire.device": -1})
        resolved = _alerts(eng)
        out.append((fired, health, resolved, wf.snapshot(),
                    eng.journal.tail(kind="sloTransition")))
    assert out[1] == out[0]
    fired, health, resolved = out[1][:3]
    active = [a for a in fired["active"] if a["kind"] == "waterfall_budget"]
    assert active and active[0]["resource"] == "waterfall:wire.device"
    assert "waterfall:wire.device" in health["resources"]
    assert not [a for a in resolved["active"]
                if a["kind"] == "waterfall_budget"]
    assert resolved["counters"]["resolved"] > 0


def test_set_clock_resets_the_waterfall_timebase(engines):
    out = []
    for eng in engines:
        wf = eng.waterfall
        wf.observe_wire([1.0] * 8)
        eng.slo_refresh(now_ms=eng.now_ms() + 2000)
        sealed = wf.snapshot()["sealedSeconds"]
        wf.observe_wire([1.0] * 8)
        eng.set_clock(lambda: 5_000_000)
        snap = wf.snapshot()
        wf.observe_wire([1.0] * 8)
        wf.roll(5_000_000 + 2000)
        out.append((sealed, snap, wf.snapshot()["recent"]))
        eng.set_clock(None)
    assert out[1] == out[0]
    assert out[1][1]["stagedSeconds"] == 0 and not out[1][1]["recent"]
    assert out[1][2][-1]["timestamp"] == 5_000_000


def test_traced_wire_requests_reconcile_and_join_spans():
    """Through the port's token server (the reactor): every admitted
    request's eight stages reconcile to its RTT, and every exemplar's
    trace id is in the service's stitched span store."""
    rules = ClusterFlowRuleManager()
    rules.load_rules("default", [pst.FlowRule(
        resource="wf-join", count=1e9, cluster_mode=True,
        cluster_config={"flowId": FLOW_ID, "thresholdType": 1})])
    svc = DefaultTokenService(rules, device="cpu")
    svc.request_tokens([(FLOW_ID, 1, False)] * 4)
    server = ClusterTokenServer(svc, host="127.0.0.1", port=0).start()
    wf = PWF.WaterfallRecorder()
    server.attach_waterfall(wf)
    n = 24
    ctxs = [new_trace_context() for _ in range(n)]
    try:
        with socket.create_connection(
                ("127.0.0.1", server.bound_port), timeout=10) as sock:
            sock.settimeout(10)
            for xid, ctx in enumerate(ctxs, start=1):
                body = codec.encode_flow_request(FLOW_ID, 1, False)
                body = codec.append_trace_tlv(body, ctx.traceparent())
                sock.sendall(codec.encode_request(xid, MSG_FLOW, body))
            reader = codec.FrameReader()
            got = []
            while len(got) < n:
                data = sock.recv(65536)
                assert data, "server closed early"
                got += [codec.decode_response(b) for b in reader.feed(data)]
        assert all(r.status == TokenResultStatus.OK for r in got)
    finally:
        server.stop()
    wf.roll(wf._now_ms() + 2000)
    snap = wf.snapshot()
    assert snap["observedRequests"] == n
    assert snap["reconciliation"]["relativeError"] <= 1e-6
    batches = sum(r["coalesce"]["batches"] for r in snap["recent"])
    assert batches >= 1
    assert sum(r["coalesce"]["requests"] for r in snap["recent"]) == n
    trace_ids = {t["traceId"] for t in svc.spans.traces()}
    assert {c.trace_id for c in ctxs} == trace_ids
    assert snap["exemplars"]
    assert all(ex["traceId"] in trace_ids for ex in snap["exemplars"])


def test_pipeline_harvests_feed_the_pipeline_lane():
    """Each pipeline harvest is one (queue, device) observation: the
    sealed pipeline lane's counts equal the pipeline's harvests."""
    for ctx in (pctx,):
        ctx.replace_context(None)
        ctx.bump_generation()
    ptu.freeze_time(BASE_MS)
    eng = PEngine(capacity=64, device="cpu")
    try:
        eng.flow_rules.load_rules([pst.FlowRule(resource="pl", count=1e9)])
        eng.start_pipeline(max_batch=8, linger_s=0.0)
        errors = []

        def caller():
            try:
                for _ in range(20):
                    with eng.entry("pl"):
                        pass
            except Exception as ex:  # noqa: BLE001 — surfaced below
                errors.append(ex)
            finally:
                pctx.replace_context(None)

        threads = [threading.Thread(target=caller) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        eng.stop_pipeline()
        assert not errors
        harvests = eng.pipeline_stats()["harvests"]
        ptu.advance_time(2000)
        eng.slo_refresh()
        snap = eng.waterfall.snapshot()
        lane = snap["cumulative"]["pipeline"]
        assert harvests > 0
        assert lane["queue"]["count"] == harvests
        assert lane["device"]["count"] == harvests
        assert sum(r["lanes"]["pipeline"]["queue"]["count"]
                   for r in snap["recent"]) == harvests
    finally:
        eng.close()
        ptu.unfreeze_time()
        pctx.replace_context(None)


def test_no_wall_clock_in_the_port_waterfall():
    path = REPO / "sentinel_tpu_torch" / "telemetry" / "waterfall.py"
    offenders = [n for n, code in _code_lines(path) if WALL.search(code)]
    assert not offenders, offenders


def test_port_waterfall_keys_only_in_config_and_documented():
    pattern = re.compile(r"[\"']csp\.sentinel\.waterfall\.[a-z.]+[\"']")
    keys, offenders = set(), []
    for path in sorted((REPO / "sentinel_tpu_torch").rglob("*.py")):
        for m in pattern.findall(path.read_text()):
            keys.add(m.strip("\"'"))
            if path.name != "config.py":
                offenders.append(f"{path}: {m}")
    assert not offenders, offenders
    ops = (REPO / "docs" / "OPERATIONS.md").read_text()
    assert keys and all(k in ops for k in keys), sorted(keys)
