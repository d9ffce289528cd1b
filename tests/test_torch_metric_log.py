"""The port's metric log (``sentinel_tpu_torch/metrics/writer.py``,
``searcher.py``, ``timer.py``) and its rule converters
(``sentinel_tpu_torch/datasource/converters.py``) against the JAX
package's: the scenarios of ``tests/test_observability.py``, each run on
the port, with every file the port writes byte-equal to what the JAX
package's writer makes of the same calls (data files and their ``.idx``
index alike). The end-to-end seal drives a JAX engine and a port engine
(``device="cpu"``) on one injected clock and compares the files their
timers write. Exact everywhere: bytes, int64 stamps, integer counters.
"""

from __future__ import annotations

import datetime
import json
import os
import time

import pytest

from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.core.exceptions import BlockException as JBlock
from sentinel_tpu.datasource import converters as JCV
from sentinel_tpu.metrics.metric_node import MetricNode as JNode
from sentinel_tpu.metrics.timer import MetricTimerListener as JTimer
from sentinel_tpu.metrics.writer import MetricWriter as JWriter

import sentinel_tpu_torch as pst
from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.core.exceptions import BlockException as PBlock
from sentinel_tpu_torch.datasource import converters as PCV
from sentinel_tpu_torch.metrics.metric_node import MetricNode
from sentinel_tpu_torch.metrics.searcher import MetricSearcher
from sentinel_tpu_torch.metrics.timer import MetricTimerListener
from sentinel_tpu_torch.metrics.writer import MetricWriter, metric_file_name

BASE = 1_700_000_000_000


def tree(path):
    """{file name: bytes} of a directory."""
    return {n: open(os.path.join(path, n), "rb").read()
            for n in sorted(os.listdir(path))}


def both(tmp_path, calls, **kw):
    """Run ``calls(writer, node_cls)`` through the JAX writer and the
    port's, each in its own directory; the two trees must be byte-equal.
    Returns the port's directory."""
    out = {}
    for name, writer_cls, node_cls in (("jax", JWriter, JNode),
                                       ("port", MetricWriter, MetricNode)):
        d = tmp_path / name
        d.mkdir()
        writer = writer_cls(app="appA", base_dir=str(d), **kw)
        calls(writer, node_cls)
        writer.close()
        out[name] = tree(d)
    assert out["port"] == out["jax"]
    assert any(n.endswith(".idx") for n in out["port"])
    return str(tmp_path / "port")


def write_seconds(writer, base_ms, per_second):
    for k, nodes in enumerate(per_second):
        writer.write(base_ms + 1000 * k, nodes)


def test_writer_searcher_range_and_identity(tmp_path):
    """``test_observability.py:58``."""
    def calls(w, N):
        write_seconds(w, BASE, [
            [N(BASE, "a", pass_qps=1), N(BASE, "b", pass_qps=2)],
            [N(BASE, "a", pass_qps=3)],
            [N(BASE, "b", pass_qps=4)],
        ])

    d = both(tmp_path, calls)
    s = MetricSearcher(d, "appA")
    assert len(s.find(BASE)) == 4
    only_a = s.find_by_time_and_resource(BASE, BASE + 2000, "a")
    assert [n.pass_qps for n in only_a] == [1, 3]
    later = s.find_by_time_and_resource(BASE + 1000, BASE + 2000, None)
    assert [n.pass_qps for n in later] == [3, 4]
    assert [n.timestamp for n in s.find(BASE + 1000)] == [BASE + 1000,
                                                           BASE + 2000]


def test_writer_is_idempotent_per_second(tmp_path):
    """``test_observability.py:77``."""
    def calls(w, N):
        w.write(BASE, [N(BASE, "a", pass_qps=1)])
        w.write(BASE, [N(BASE, "a", pass_qps=9)])  # dup second: dropped
        w.write(BASE - 1000, [N(BASE, "a", pass_qps=8)])  # older: dropped

    d = both(tmp_path, calls)
    assert [n.pass_qps for n in MetricSearcher(d, "appA").find(BASE)] == [1]


def test_writer_rolls_at_midnight_boundary(tmp_path):
    """``test_observability.py:87``: a date change starts a fresh ``.1``."""
    before = datetime.datetime(2023, 11, 14, 23, 59, 59)
    after = datetime.datetime(2023, 11, 15, 0, 0, 1)

    def calls(w, N):
        w.write(int(before.timestamp() * 1000), [N(0, "r", pass_qps=1)])
        w.write(int(after.timestamp() * 1000), [N(0, "r", pass_qps=2)])

    d = both(tmp_path, calls)
    names = sorted(n for n in os.listdir(d) if not n.endswith(".idx"))
    assert names == [
        metric_file_name("appA", before.strftime("%Y-%m-%d"), 1),
        metric_file_name("appA", after.strftime("%Y-%m-%d"), 1),
    ]
    assert [n.pass_qps for n in MetricSearcher(d, "appA").find(0)] == [1, 2]


def test_writer_index_rolls_at_size_cap(tmp_path):
    """``test_observability.py:116``."""
    day = datetime.datetime(2023, 11, 14, 12, 0, 0)
    base = int(day.timestamp() * 1000)

    def calls(w, N):
        for k in range(6):
            w.write(base + 1000 * k, [N(0, f"res{k}", pass_qps=k)])

    d = both(tmp_path, calls, single_file_size=120, total_file_count=10)
    data = sorted(n for n in os.listdir(d) if not n.endswith(".idx"))
    indices = [int(n.rsplit(".", 1)[1]) for n in data]
    assert all(day.strftime("%Y-%m-%d") in n for n in data)
    assert indices == list(range(1, len(data) + 1)) and len(data) >= 2
    for n in data:
        assert os.path.getsize(os.path.join(d, n + ".idx")) > 0
    nodes = MetricSearcher(d, "appA").find(0)
    assert [n.pass_qps for n in nodes] == list(range(6))


def test_writer_trim_keeps_exactly_file_keep(tmp_path):
    """``test_observability.py:141``."""
    base = int(datetime.datetime(2023, 11, 14, 12, 0, 0).timestamp() * 1000)

    def calls(w, N):
        for k in range(9):
            w.write(base + 1000 * k, [N(0, f"res{k}", pass_qps=k)])

    d = both(tmp_path, calls, single_file_size=1, total_file_count=3)
    data = sorted((n for n in os.listdir(d) if not n.endswith(".idx")),
                  key=lambda n: int(n.rsplit(".", 1)[1]))
    assert [int(n.rsplit(".", 1)[1]) for n in data] == [7, 8, 9]
    idx = sorted(n for n in os.listdir(d) if n.endswith(".idx"))
    assert idx == sorted(n + ".idx" for n in data)


def test_writer_rolls_by_size_and_trims(tmp_path):
    """``test_observability.py:162``."""
    def calls(w, N):
        for k in range(20):
            w.write(BASE + 1000 * k, [N(0, f"res{k}", pass_qps=k)])

    d = both(tmp_path, calls, single_file_size=200, total_file_count=2)
    data_files = [n for n in os.listdir(d) if not n.endswith(".idx")]
    assert 0 < len(data_files) <= 2
    nodes = MetricSearcher(d, "appA").find(BASE)
    assert nodes and nodes[-1].resource == "res19"


def test_writer_resumes_the_newest_same_date_file(tmp_path):
    """A new writer appends to the newest file of the same date, as the
    reference's does (``_ensure_open``), and the bytes stay equal."""
    base = int(datetime.datetime(2023, 11, 14, 12, 0, 0).timestamp() * 1000)

    def calls(w, N):
        w.write(base, [N(0, "a", pass_qps=1)])
        w.close()
        w2 = type(w)(app="appA", base_dir=w.base_dir)
        w2.write(base + 1000, [N(0, "a", pass_qps=2)])
        w2.close()

    d = both(tmp_path, calls)
    assert len([n for n in os.listdir(d) if not n.endswith(".idx")]) == 1
    assert [n.pass_qps for n in MetricSearcher(d, "appA").find(0)] == [1, 2]


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def test_engine_seal_end_to_end_writes_equal_files(tmp_path):
    """``test_observability.py:176`` on both engines at the same simulated
    seconds: the timers' files are byte-equal, the searcher reads the
    sealed second back, and sealing is monotonic."""
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()
    clock = Clock(BASE + 250)
    jeng = JEngine(capacity=512, clock=clock, journal_path="")
    peng = PEngine(capacity=512, device="cpu", clock=clock)
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    try:
        for eng, cv in ((jeng, JCV), (peng, PCV)):
            eng.flow_rules.load_rules(cv.flow_rules_from_json(
                [{"resource": "sealed", "count": 3},
                 {"resource": "other", "count": 1}]))
        verdicts = {}
        for side, eng in (("jax", jeng), ("port", peng)):
            out = []
            for res in ["sealed"] * 5 + ["other"] * 2:
                try:
                    eng.entry(res).exit()
                    out.append("P")
                except (JBlock, PBlock):
                    out.append("B")
            verdicts[side] = out
        assert verdicts["port"] == verdicts["jax"]
        # Leased commits land at flush time: flush inside the second they
        # were served in (the reference's advance_time does the same).
        for eng in (jeng, peng):
            eng._flush_committer()
        clock.now += 2000  # the active second becomes sealed
        written = {}
        for side, eng, timer_cls, writer_cls in (
                ("jax", jeng, JTimer, JWriter),
                ("port", peng, MetricTimerListener, MetricWriter)):
            dirs[side].mkdir()
            writer = writer_cls(app="appS", base_dir=str(dirs[side]))
            timer = timer_cls(eng, writer)
            written[side] = [timer.tick(clock.now), timer.tick(clock.now)]
            writer.close()
        assert written["port"] == written["jax"] == [2, 0]
        assert tree(dirs["port"]) == tree(dirs["jax"])
        nodes = MetricSearcher(str(dirs["port"]), "appS") \
            .find_by_time_and_resource(0, 2**62, "sealed")
        assert len(nodes) == 1
        n = nodes[0]
        assert (n.pass_qps, n.block_qps, n.success_qps) == (3, 2, 3)
        assert n.timestamp == BASE
    finally:
        peng.close()
        jeng.close()
        for ctx in (jctx, pctx):
            ctx.replace_context(None)


def test_timer_thread_writes_sealed_seconds_of_its_engine(tmp_path):
    """``start()`` ticks ``seal_metrics`` on its own thread at its period;
    ``stop()`` joins it and closes the writer."""
    pctx.replace_context(None)
    clock = Clock(BASE)
    eng = PEngine(capacity=512, device="cpu", clock=clock)
    writer = MetricWriter(app="appT", base_dir=str(tmp_path))
    timer = MetricTimerListener(eng, writer, period_s=0.02).start()
    try:
        for _ in range(4):
            for _ in range(3):
                eng.entry("ticked").exit()
            eng._flush_committer()
            clock.now += 1000
            time.sleep(0.1)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            nodes = MetricSearcher(str(tmp_path), "appT").find(0)
            if len({n.timestamp for n in nodes}) >= 3:
                break
            time.sleep(0.02)
    finally:
        timer.stop()
        eng.close()
        pctx.replace_context(None)
    assert timer._thread is None and writer._data is None
    seconds = sorted({n.timestamp for n in nodes})
    assert len(seconds) >= 3
    assert all(n.pass_qps == 3 for n in nodes if n.resource == "ticked")


def test_timer_follows_the_default_engine():
    """With no engine given, the listener reads the module's default
    engine, the one ``reset()`` installed last."""
    timer = MetricTimerListener(writer=MetricWriter(app="x", base_dir="."))
    first = pst.reset(capacity=256, device="cpu")
    try:
        assert timer.engine is first
        second = pst.reset(capacity=256, device="cpu")
        assert timer.engine is second
    finally:
        pst.get_engine().close()
        pctx.replace_context(None)


# -- converters ---------------------------------------------------------------


def test_flow_rule_json_round_trip():
    """``test_observability.py:238``."""
    src = json.dumps([{
        "resource": "getUser", "count": 20, "grade": 1, "limitApp": "appB",
        "strategy": 1, "refResource": "other", "controlBehavior": 2,
        "maxQueueingTimeMs": 250, "clusterMode": True,
        "clusterConfig": {"flowId": 42, "thresholdType": 1},
    }])
    rules = PCV.flow_rules_from_json(src)
    assert len(rules) == 1
    r = rules[0]
    assert r.count == 20 and r.limit_app == "appB"
    assert r.ref_resource == "other" and r.max_queueing_time_ms == 250
    assert r.cluster_mode and r.cluster_config["flowId"] == 42
    back = PCV.flow_rules_from_json(PCV.flow_rules_to_json(rules))
    assert back == rules
    assert PCV.flow_rules_to_json(rules) == \
        JCV.flow_rules_to_json(JCV.flow_rules_from_json(src))


def test_degrade_param_rule_json_round_trip():
    """``test_observability.py:255``."""
    dsrc = json.dumps([{
        "resource": "r", "grade": 0, "count": 50, "timeWindow": 10,
        "slowRatioThreshold": 0.5, "minRequestAmount": 8,
        "statIntervalMs": 2000}])
    d = PCV.degrade_rules_from_json(dsrc)
    assert d[0].slow_ratio_threshold == 0.5 and d[0].stat_interval_ms == 2000
    assert PCV.degrade_rules_from_json(PCV.degrade_rules_to_json(d)) == d
    assert PCV.degrade_rules_to_json(d) == \
        JCV.degrade_rules_to_json(JCV.degrade_rules_from_json(dsrc))

    psrc = json.dumps([{
        "resource": "r", "paramIdx": 1, "count": 5, "durationInSec": 2,
        "paramFlowItemList": [
            {"object": "7", "classType": "int", "count": 100},
            {"object": "vip", "classType": "String", "count": 200},
            {"object": "true", "classType": "boolean", "count": 3},
            {"object": "2.5", "classType": "double", "count": 4},
        ],
    }])
    p = PCV.param_rules_from_json(psrc)
    assert p[0].items[0].object == 7       # classType re-typing
    assert p[0].items[1].object == "vip"
    assert p[0].items[2].object is True
    assert p[0].items[3].object == 2.5
    assert PCV.param_rules_from_json(PCV.param_rules_to_json(p)) == p
    assert PCV.param_rules_to_json(p) == \
        JCV.param_rules_to_json(JCV.param_rules_from_json(psrc))


def test_system_authority_rule_json_and_refusals():
    src = json.dumps([{"highestSystemLoad": 4.5, "qps": 100, "avgRt": None}])
    s = PCV.system_rules_from_json(src)
    assert s[0].highest_system_load == 4.5 and s[0].avg_rt == -1.0
    assert PCV.system_rules_to_json(s) == \
        JCV.system_rules_to_json(JCV.system_rules_from_json(src))
    asrc = [{"resource": "r", "limitApp": "a,b", "strategy": 1}]
    a = PCV.authority_rules_from_json(asrc)
    assert a[0].limit_app == "a,b" and a[0].strategy == 1
    assert PCV.authority_rules_to_json(a) == \
        JCV.authority_rules_to_json(JCV.authority_rules_from_json(asrc))
    assert PCV.flow_rules_from_json(None) == []
    assert PCV.flow_rules_from_json("null") == []
    with pytest.raises(ValueError, match="JSON array"):
        PCV.flow_rules_from_json('{"resource": "r"}')
