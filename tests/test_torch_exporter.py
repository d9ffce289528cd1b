"""The port's OpenMetrics exporter (``sentinel_tpu_torch/telemetry/exporter.py``,
``telemetry/openmetrics.py``) held to the JAX package's on the CPU.

One JAX engine and one port engine for the module (capacity 128, both
clocks frozen at the same epoch, the lease fast path off so every entry
and exit is one width-1 step in call order, the adaptive knobs of
``tests/test_adaptive.py`` set on both configs before they are built)
are driven alike by each case, in file order, through ``entry`` and
``exit`` (one case through ``check_batch`` and ``complete_batch``, which
neither package's step timer counts), and their full
``render_engine_metrics`` pages must be byte-equal, except the values of
the named timing families below (host wall times of steps, enqueues,
pipeline waits, folds and wire RTTs), whose names, types and label sets
are still compared line for line. The cases are the exporter cases of
``test_telemetry.py``, ``test_adaptive.py:669``,
``test_chaos_campaign.py:385``, ``test_cluster_ha.py:783``,
``test_fleet.py:746`` and ``test_llm.py:460``, whose own assertions then
run on the port's page. Process-wide state the exporter reads (the
simulator lab's and chaos campaigns' counters and last reports, the
health probe registry) is set the same in both packages for each case:
other test files in the same worker may have run campaigns on one
package only.

Then ``render_dashboard_metrics`` against a stub dashboard,
``OpenMetricsBuilder``'s bytes and escapes, and the port's lint rule:
every ``sentinel_tpu_*`` family is declared exactly once in
``sentinel_tpu_torch/telemetry/``, and the port declares the reference's
families.
"""

from __future__ import annotations

import json
import re
import urllib.request
from pathlib import Path

import pytest

from tests.test_torch_support import ops_pkgs

BASE_MS = 1_700_000_000_000
REPO = Path(__file__).resolve().parent.parent

# Families whose sample VALUES are host wall times (compared by name,
# type and label set only).
TIMING_FAMILIES = (
    "sentinel_tpu_step_ms", "sentinel_tpu_enqueue_ms",
    "sentinel_tpu_step_duration_ms", "sentinel_tpu_pipeline_queue_wait_ms",
    "sentinel_tpu_pipeline_device_wait_ms",
    "sentinel_tpu_waterfall_stage_ms", "sentinel_tpu_waterfall_rtt_ms",
    "sentinel_tpu_wire_rtt_ms", "sentinel_tpu_population_fold_ms",
)

ADAPTIVE_KNOBS = {
    "csp.sentinel.lease.enabled": "false",
    "csp.sentinel.adaptive.interval.seconds": "2",
    "csp.sentinel.adaptive.shadow.seconds": "2",
    "csp.sentinel.adaptive.canary.seconds": "2",
    "csp.sentinel.adaptive.cooldown.seconds": "4",
    "csp.sentinel.adaptive.abort.backoff.seconds": "30",
    "csp.sentinel.adaptive.step.pct": "1.0",
    "csp.sentinel.adaptive.increase.pct": "1.0",
    "csp.sentinel.adaptive.freeze.stale.seconds": "5",
}


def masked(text: str):
    """The page's lines, with the values of TIMING_FAMILIES' samples
    replaced by a placeholder."""
    out, family = [], None
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            family = line.split()[2]
        elif family in TIMING_FAMILIES and not line.startswith("#"):
            head, _, _ = line.split(" # ", 1)[0].rpartition(" ")
            line = head + " <t>"
        out.append(line)
    return out


def assert_pages_equal(jax_text: str, port_text: str) -> None:
    assert port_text.endswith("# EOF\n") and jax_text.endswith("# EOF\n")
    want, got = masked(jax_text), masked(port_text)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"line {i}: port {g!r} != jax {w!r}"
    assert len(got) == len(want)


# -- the shared pair ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pkgs = ops_pkgs()
    saved = []
    for P in pkgs:
        cfg = P.config.config
        saved.append({k: cfg._config.get(k) for k in ADAPTIVE_KNOBS})
        for k, v in ADAPTIVE_KNOBS.items():
            cfg.set(k, v)
        P.tu.freeze_time(BASE_MS)
        P.ctx.replace_context(None)
        P.ctx.bump_generation()
    engines = {P.name: P.engine(capacity=128) for P in pkgs}
    yield pkgs, engines
    for P, values in zip(pkgs, saved):
        engines[P.name].close()
        P.tu.unfreeze_time()
        P.ctx.replace_context(None)
        for k, v in values.items():
            if v is None:
                P.config.config._config.pop(k, None)
            else:
                P.config.config.set(k, v)


@pytest.fixture()
def case(pair, monkeypatch):
    """Both clocks a whole second at least 100 s on; the process-wide
    state the exporter reads set the same in both packages."""
    pkgs, engines = pair
    for P in pkgs:
        now = P.tu.current_time_millis()
        P.tu.advance_time((now // 1000 + 100) * 1000 - now)
        monkeypatch.setattr(P.lab, "_counters",
                            {"labRuns": 0, "replayedSeconds": 0})
        monkeypatch.setattr(P.lab, "_last_report", None)
        monkeypatch.setattr(P.chaos, "_counters", {
            "episodes": 0, "violations": 0, "faultsFired": 0,
            "shrinkSteps": 0})
        monkeypatch.setattr(P.chaos, "_last_report", None)
        monkeypatch.setattr(P.resilience, "_probes", {})
        P.ctx.replace_context(None)
    yield pkgs, engines


def render_both(pkgs, engines):
    """Both pages, each after its trace pump has processed every queued
    batch (the pump counts blocked entries off the caller's thread)."""
    pages = []
    for P in pkgs:
        engines[P.name].traces.drain()
        pages.append(P.exporter.render_engine_metrics(engines[P.name]))
    return pages


def drive(P, eng, resource, per_sec, seconds=1, rt_ms=(0,)):
    """Each second: ``per_sec`` entries of ``resource`` on the frozen
    clock, then the passed ones exit ``rt_ms`` later (newest first, one
    RT each, the last repeated); the clock ends a second after the
    second began. The trace pump is drained after every entry step, so
    its bounded queue drops nothing (a drop would follow thread timing)."""
    for _ in range(seconds):
        start = P.tu.current_time_millis()
        handles = []
        for _ in range(per_sec):
            try:
                handles.append(eng.entry(resource))
            except P.st.BlockException:
                pass
            eng.traces.drain()
        elapsed = 0
        for i, h in enumerate(reversed(handles)):
            rt = rt_ms[min(i, len(rt_ms) - 1)]
            P.tu.advance_time(rt - elapsed)
            elapsed = rt
            h.exit()
        P.ctx.replace_context(None)
        P.tu.advance_time(start + 1000 - P.tu.current_time_millis())


# -- the exporter cases ---------------------------------------------------------

def test_metrics_endpoint_parses_as_openmetrics(case):
    """``GET /metrics`` on each package's command center: the same
    content type and the same page; the reference parser reads the port's
    and its attribution series match the device counters."""
    from prometheus_client.openmetrics import parser as om_parser

    pkgs, engines = case
    pages = []
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules([P.flow.FlowRule(resource="scrape",
                                                   count=2)])
        drive(P, eng, "scrape", 5, rt_ms=(5, 9))
        eng.traces.drain()
        center = P.cc.CommandCenter(eng, port=0).start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{center.bound_port}/metrics",
                    timeout=30) as r:
                pages.append((r.headers["Content-Type"], r.read().decode()))
        finally:
            center.stop()
    (jct, jtext), (pct, ptext) = pages
    assert pct == jct == pkgs[1].om.OPENMETRICS_CONTENT_TYPE
    assert "openmetrics-text" in pct
    assert_pages_equal(jtext, ptext)

    families = {f.name: f
                for f in om_parser.text_string_to_metric_families(ptext)}
    for fam in ("sentinel_tpu_pass", "sentinel_tpu_block_reason",
                "sentinel_tpu_rt_ms", "sentinel_tpu_fail_open",
                "sentinel_tpu_rollout_active"):
        assert fam in families

    def sample(fam, name, match):
        return [s for s in families[fam].samples if s.name == name
                and all(s.labels.get(k) == v for k, v in match.items())]

    blocks = sample("sentinel_tpu_block_reason",
                    "sentinel_tpu_block_reason_total",
                    {"resource": "scrape", "reason": "FLOW"})
    assert len(blocks) == 1 and blocks[0].value == 3
    assert sample("sentinel_tpu_pass", "sentinel_tpu_pass_total",
                  {"resource": "scrape"})[0].value == 2
    assert sample("sentinel_tpu_rt_ms", "sentinel_tpu_rt_ms_count",
                  {"resource": "scrape"})[0].value == 2
    assert sample("sentinel_tpu_rt_ms", "sentinel_tpu_rt_ms_bucket",
                  {"resource": "scrape", "le": "+Inf"})[0].value == 2
    # parse_families (the port's fallback parser) reads the same totals
    # as telemetry_counts() for every resource
    eng = engines["port"]
    parsed = pkgs[1].om.parse_families(ptext)
    counts = eng.telemetry_counts()["totals"]
    rows = pkgs[1].exporter._active_rows(eng, eng.telemetry_counts())
    C = pkgs[1].C
    for fam, ev in (("sentinel_tpu_pass", C.MetricEvent.PASS),
                    ("sentinel_tpu_block", C.MetricEvent.BLOCK)):
        got = {lab["resource"]: v for _, lab, v in parsed[fam]}
        assert got == {res: float(counts[int(ev), row])
                       for res, row in rows.items()}


def test_hostile_resource_names_round_trip_openmetrics(case):
    """Names holding the three ABNF-escaped label characters survive
    rule load -> device step -> page -> the OpenMetrics parser, and both
    packages escape them to the same bytes."""
    from prometheus_client.openmetrics import parser as om_parser

    pkgs, engines = case
    hostile = 'evil"res\\with\nnewline'
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules([P.flow.FlowRule(resource=hostile,
                                                   count=1)])
        drive(P, eng, hostile, 3)
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    families = {f.name: f
                for f in om_parser.text_string_to_metric_families(ptext)}
    got = [s for s in families["sentinel_tpu_block_reason"].samples
           if s.labels.get("reason") == "FLOW"
           and s.labels.get("resource") == hostile]
    assert len(got) == 1 and got[0].value == 2
    passes = [s for s in families["sentinel_tpu_pass"].samples
              if s.labels.get("resource") == hostile]
    assert passes[0].value == 1


def test_exporter_renders_adaptive_families(case):
    pkgs, engines = case
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules([P.flow.FlowRule(resource="mx", count=4)])
        eng.adaptive.load_targets([P.adaptive_ctl.AdaptiveTarget(
            resource="mx", max_block_rate=0.05, floor=1.0, ceiling=64.0,
            min_entries=8)])
        eng.adaptive.enable()
        drive(P, eng, "mx", 16, 3)
        eng.adaptive.tick(now_ms=P.tu.current_time_millis(), force=True)
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    for line in ("sentinel_tpu_adaptive_enabled 1",
                 "sentinel_tpu_adaptive_frozen 0",
                 "sentinel_tpu_adaptive_proposals_total 1",
                 "sentinel_tpu_adaptive_promotions_total 0",
                 "sentinel_tpu_adaptive_aborts_total 0",
                 'sentinel_tpu_adaptive_target_delta{resource="mx"}'):
        assert line in ptext, line
    ad = engines["port"].resilience_stats()["adaptive"]
    assert ad["enabled"] and ad["proposals"] == 1
    for P in pkgs:  # end the drill: later cases render no candidate
        engines[P.name].adaptive.disable()


def test_chaos_counters_reach_exporter(case, monkeypatch):
    pkgs, engines = case
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    for family in ("sentinel_tpu_chaos_episodes",
                   "sentinel_tpu_chaos_violations",
                   "sentinel_tpu_chaos_faults_fired",
                   "sentinel_tpu_chaos_shrink_steps"):
        assert family in ptext
    # counted campaigns land in both pages alike
    for P in pkgs:
        P.chaos._count(episodes=12, violations=1, faultsFired=30,
                       shrinkSteps=4)
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    assert "sentinel_tpu_chaos_episodes_total 12" in ptext
    assert "sentinel_tpu_chaos_shrink_steps_total 4" in ptext


def test_resilience_stats_and_exporter_carry_ha_block(case):
    pkgs, engines = case
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules([P.flow.FlowRule(
            resource="shared", count=50, cluster_mode=True,
            cluster_config={"flowId": 900,
                            "thresholdType": P.CC.THRESHOLD_GLOBAL,
                            "windowIntervalMs": 2000})])
        # the degraded-share base tracks the LOCAL copies of cluster rules
        assert eng.cluster_degraded_thresholds() == {900: (50.0, 2000)}
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    ha = engines["port"].resilience_stats()["clusterHA"]
    assert ha["roleName"] == "NOT_STARTED" and ha["failoverCount"] == 0
    for line in ("sentinel_tpu_cluster_ha_role -1",
                 "sentinel_tpu_cluster_ha_epoch 0",
                 "sentinel_tpu_cluster_ha_failovers_total 0",
                 "sentinel_tpu_cluster_ha_stale_epoch_rejected_total 0",
                 "sentinel_tpu_cluster_ha_degraded 0",
                 "sentinel_tpu_cluster_ha_degraded_seconds_total 0"):
        assert line in ptext, line


def test_exporter_renders_journal_and_fleet_families(case):
    pkgs, engines = case
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules(P.conv.flow_rules_from_json(json.dumps(
            [{"resource": "rX", "count": 5, "grade": 1}])))
        drive(P, eng, "rX", 8, 2, rt_ms=(12,))
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    assert "sentinel_tpu_journal_last_seq" in ptext
    assert "sentinel_tpu_journal_records_total" in ptext
    assert "sentinel_tpu_fleet_leaders -1" in ptext  # no collector
    assert "sentinel_tpu_fleet_polls_total 0" in ptext
    assert 'sentinel_tpu_second_pass{resource="rX"} 5' in ptext


def test_exporter_llm_families(case):
    pkgs, engines = case
    for P in pkgs:
        eng = engines[P.name]
        eng.tps_rules.load_rules([P.llm.TpsRule(model="m",
                                                tokens_per_second=50)])
        eng.stream_open("e1", "m", 10)
        eng.stream_tick("e1", 4)
        eng.stream_close("e1")
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    assert "sentinel_tpu_llm_rules 1" in ptext
    assert "sentinel_tpu_llm_tokens_streamed_total 4" in ptext
    assert "sentinel_tpu_llm_streams_opened_total 1" in ptext
    for P in pkgs:
        engines[P.name].tps_rules.load_rules([])


def test_exporter_renders_the_sim_lab_report(case):
    """The process-wide lab report and counters (the ``sentinel_tpu_sim_*``
    families) render alike from the same report."""
    pkgs, engines = case
    report = {"secondsPerWallSecond": 123.5, "replayedSeconds": 600,
              "results": {"flash_crowd": {"aimd": {"score": 0.75},
                                          "static": {"score": -1.25}}}}
    for P in pkgs:
        P.lab.set_last_report(dict(report))
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    assert "sentinel_tpu_sim_lab_runs_total 1" in ptext
    assert "sentinel_tpu_sim_replayed_seconds_total 600" in ptext
    assert ('sentinel_tpu_sim_policy_score{scenario="flash_crowd",'
            'policy="static"} -1.25') in ptext


def test_timing_families_are_present_and_masked_only_by_value(case):
    """Every masked family renders in both pages with the same label sets
    (what ``masked`` keeps), after traffic that samples step walls."""
    pkgs, engines = case
    for P in pkgs:
        drive(P, engines[P.name], "rX", 4, rt_ms=(3,))
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    for fam in TIMING_FAMILIES:
        assert f"# TYPE {fam} " in ptext, fam
    assert any(line.startswith("sentinel_tpu_step_ms{")
               for line in ptext.splitlines())


def batch_lanes(P, eng, resource, n):
    """A width-``n`` staging pair for ``resource`` in context ``ctx``:
    the entry batch as this package's ``check_batch`` takes it, and the
    numpy entry columns."""
    buf = P.batch.make_entry_batch_np(n)
    reg = eng.registry
    cr, dn, orow, oid = reg.resolve_entry(resource, "ctx", "",
                                          reg.entrance_row("ctx"),
                                          int(P.C.EntryType.OUT))
    buf["cluster_row"][:] = cr
    buf["dn_row"][:] = dn
    buf["origin_row"][:] = orow
    buf["origin_id"][:] = oid
    buf["context_id"][:] = reg.context_id("ctx")
    buf["count"][:] = 1
    return (P.batch.EntryBatch(**buf) if P.name == "jax" else buf), buf


def test_batch_api_pages_are_byte_equal(case):
    """Both engines driven through ``check_batch`` and ``complete_batch``
    (two seconds of width-8 batches against a count-3 rule, the passed
    lanes completed 7 ms later) render equal pages: neither package's
    step timer counts the batch API's dispatches."""
    import numpy as np

    pkgs, engines = case
    for P in pkgs:
        eng = engines[P.name]
        eng.flow_rules.load_rules([P.flow.FlowRule(resource="bX", count=3)])
        for _ in range(2):
            now = P.tu.current_time_millis()
            batch, buf = batch_lanes(P, eng, "bX", 8)
            reason = np.asarray(eng.check_batch(batch, now_ms=now).reason)
            eng.traces.drain()
            ok = reason == 0
            ebuf = P.batch.make_exit_batch_np(8)
            for f in ("cluster_row", "dn_row", "origin_row", "count"):
                ebuf[f][:] = buf[f]
            ebuf["cluster_row"][~ok] = -1
            ebuf["dn_row"][~ok] = -1
            ebuf["success"][:] = ok
            ebuf["rt_ms"][:] = 7
            eng.complete_batch(P.batch.ExitBatch(**ebuf) if P.name == "jax"
                               else ebuf, now_ms=now + 7)
            P.tu.advance_time(1000)
    jtext, ptext = render_both(pkgs, engines)
    assert_pages_equal(jtext, ptext)
    assert 'sentinel_tpu_pass_total{resource="bX"} 6' in ptext
    assert 'sentinel_tpu_block_total{resource="bX"} 10' in ptext


# -- the dashboard's page ---------------------------------------------------------

class _Apps:
    def app_names(self):
        return ["shop", "auth"]

    def healthy_machines(self, app):
        return ["m1", "m2"] if app == "shop" else ["m3"]


class _Repository:
    def apps(self):
        return ["shop"]

    def resources_of(self, app):
        return ["checkout", "cart", 'odd"name']

    def query(self, app, res, start_ms, end_ms):
        if res == "cart":
            return []
        return [{"passQps": 1.0, "blockQps": 0.0},
                {"passQps": 12.5, "blockQps": 3.0}]


class _Dashboard:
    apps = _Apps()
    repository = _Repository()
    sse_clients = 2


def test_render_dashboard_metrics_against_a_stub():
    pages = [P.exporter.render_dashboard_metrics(_Dashboard())
             for P in ops_pkgs()]
    assert pages[1] == pages[0]
    text = pages[1]
    assert 'sentinel_tpu_dashboard_machines{app="auth"} 1' in text
    assert 'sentinel_tpu_dashboard_machines{app="shop"} 2' in text
    assert ('sentinel_tpu_dashboard_resource_pass_qps{app="shop",'
            'resource="checkout"} 12.5') in text
    assert 'resource="odd\\"name"' in text
    assert "cart" not in text  # no series in the window
    assert "sentinel_tpu_dashboard_sse_clients 2" in text
    assert text.endswith("# EOF\n")


def test_render_dashboard_metrics_without_sse_counter():
    class Bare:
        apps = _Apps()
        repository = _Repository()

    pages = [P.exporter.render_dashboard_metrics(Bare()) for P in ops_pkgs()]
    assert pages[1] == pages[0]
    assert "sentinel_tpu_dashboard_sse_clients 0" in pages[1]


# -- OpenMetricsBuilder ------------------------------------------------------------

def _build(om):
    b = om.OpenMetricsBuilder()
    b.family("x_total_req", "counter", 'say "hi"\\ and\nbye')
    b.sample("x_total_req_total", {"k": 'v"a\\l\nue'}, 3)
    b.counter("x_plain", "", 2.5)
    b.family("x_hist", "histogram", "h")
    b.histogram("x_hist", {"r": "a"}, [1.0, 2.0, 4.0], [1, 0, 2, 5], 99.25,
                exemplars={2: ({"trace_id": "abc"}, 3.5, 1700000000.25),
                           3: ({"trace_id": "def"}, 9.0, None)})
    b.histogram("x_hist", {}, [1.0], [0], 0.0)
    b.family("x_info", "info", "")
    b.sample("x_info_info", {"name": "n"}, 1)
    b.sample("x_big", None, 1e16)
    b.sample("x_neg", None, -0.5)
    return b.render()


def test_openmetrics_builder_bytes_match_reference():
    pages = [_build(P.om) for P in ops_pkgs()]
    assert pages[1] == pages[0]
    text = pages[1]
    # HELP escapes backslash and newline only; labels escape all three
    assert '# HELP x_total_req say "hi"\\\\ and\\nbye' in text
    assert 'x_total_req_total{k="v\\"a\\\\l\\nue"} 3' in text
    assert 'x_hist_bucket{r="a",le="4"} 3 # {trace_id="abc"} 3.5 ' \
        '1700000000.25' in text
    assert 'x_hist_bucket{r="a",le="+Inf"} 8 # {trace_id="def"} 9' in text
    assert "x_hist_count{r=\"a\"} 8" in text
    assert text.endswith("# EOF\n")
    parsed = [P.om.parse_families(text) for P in ops_pkgs()]
    assert parsed[1] == parsed[0]
    assert parsed[1]["x_hist"][-1] == ("x_hist_sum", {}, 0.0)


def test_openmetrics_help_escaping_follows_abnf():
    """A strict parser reads the port's HELP line with a quote verbatim."""
    from prometheus_client.openmetrics import parser as om_parser

    om = ops_pkgs()[1].om
    b = om.OpenMetricsBuilder()
    b.counter("sentinel_tpu_quoted", 'a "quoted" help \\ with\nnewline', 1)
    fams = list(om_parser.text_string_to_metric_families(b.render()))
    assert fams[0].documentation == 'a "quoted" help \\ with\nnewline'


# -- the port's lint rule ----------------------------------------------------------

_DECL = re.compile(
    r"(?:b\.(?:family|counter)\(\s*|^\s*\()\"(sentinel_tpu_[a-z0-9_]+)\"")


def _declarations(root: Path):
    seen, dupes = {}, []
    for path in sorted(root.rglob("*.py")):
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            for name in _DECL.findall(line.split("#", 1)[0]):
                where = f"{path.relative_to(REPO)}:{lineno}"
                if name in seen:
                    dupes.append(f"{name} ({seen[name]} and {where})")
                else:
                    seen[name] = where
    return seen, dupes


def test_port_metric_names_declared_exactly_once():
    """``tests/test_lint.py``'s rule on ``sentinel_tpu_torch/telemetry/``:
    a family declared twice renders duplicate ``# TYPE`` lines, which
    strict OpenMetrics parsers reject; and the port declares exactly the
    reference's families."""
    seen, dupes = _declarations(REPO / "sentinel_tpu_torch" / "telemetry")
    assert seen, "no exported metric declarations found (regex rot?)"
    assert not dupes, "metric family declared twice: " + ", ".join(dupes)
    for name in ("sentinel_tpu_pass", "sentinel_tpu_second_pass",
                 "sentinel_tpu_slo_burn_rate", "sentinel_tpu_alert_active"):
        assert name in seen
    ref, _ = _declarations(REPO / "sentinel_tpu" / "telemetry")
    assert sorted(seen) == sorted(ref)
