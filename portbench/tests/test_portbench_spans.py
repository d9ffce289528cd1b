"""The span reading: a traced run of the cell with the program's recorder
on (``portbench/spans.py``), and the naming of a slice's idle gaps."""

import json

from portbench import spans


def test_trace_line_carries_the_span_metrics(tmp_path, capsys):
    res = spans.SpannedRun("mesh10k.uniform", 2147483999, 0, True,
                           device="cpu", width=128, rounds=12,
                           log_dir=str(tmp_path / "logs")).run()
    assert res["correct"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    for name, unit in spans.METRICS.items():
        if name.startswith("seal_") and name not in metrics:
            continue  # no metric-timer tick began in a short window
        assert res["metrics"][name]["unit"] == unit
        assert metrics[name] >= 0
    assert metrics["fixpoint_sweeps_per_step"] == 3.0
    assert metrics["entry_step_ms"] > 0 and metrics["exit_step_ms"] > 0
    line = next(json.loads(x) for x in capsys.readouterr().out.splitlines()
                if x.startswith('{"spans"'))["spans"]
    by_site = line["syncs_per_round_by_site"]
    assert sum(by_site.values()) == metrics["host_syncs_per_round"]
    assert by_site["sync.step.roll_second"] == 2.0
    assert line["dropped"] == 0
    pump = line["pump"]
    assert pump["items"] > 0
    assert metrics["trace_pump_busy_pct"] == pump["pct_of_window"]["python"]
    assert any(t["counters"].get("pump.items") == pump["items"]
               for t in line["other_threads"])


def _span(name, a, b, i, parent=None):
    return {"name": name, "start_ns": a, "end_ns": b, "id": i,
            "parent": parent, "step": 1}


def test_idle_gaps_named_by_the_innermost_span():
    loop = [_span("check_batch", 10, 60, 0), _span("step.entry", 20, 50, 1, 0),
            _span("slot.flow", 30, 40, 2, 1), _span("harvest", 70, 80, 3)]
    seal = {"tid": 2, "spans": [_span("seal.read", 0, 25, 0)]}
    pump = {"tid": 3, "spans": [_span("pump.process", 55, 75, 0),
                                _span("pump.wait", 56, 60, 1, 0),
                                _span("pump.row_stats", 70, 74, 2, 0)]}
    reading = spans.read_slice(
        {"lo_ns": 0, "hi_ns": 100,
         "busy_ns": [(12, 22), (32, 38), (44, 46), (62, 68), (82, 90)],
         "harness_check_batch_ns": [9]},
        loop, [seal, pump])
    named = {k: round(v * 1e9) for k, v in reading["idle_by_span"]}
    # Gaps by midpoint: [0,12) untraced, [22,32) step.entry, [38,44)
    # step.entry (slot.flow has closed), [46,62) check_batch, [68,82)
    # harvest, [90,100) untraced.
    assert named == {"untraced": 22, "step.entry": 16, "check_batch": 16,
                     "harvest": 14}
    # [0,12) and [22,25); the pump's idle [55,62) and [68,75) split as
    # wait [56,60), row_stats [70,74), its own Python the rest.
    assert round(reading["idle_beside_seal_s"] * 1e9) == 15
    assert {k: round(v * 1e9) for k, v in
            reading["idle_beside_pump_s"].items()} == {
        "python": 6, "wait": 4, "row_stats": 4}
    assert reading["check_batch_start_offset_ms"] == [1e-6, 1e-6]
    assert abs(reading["untraced_share"] - 22 / 68) < 1e-12


def test_innermost_segments_partition_nested_spans():
    segs = spans.innermost([_span("a", 0, 10, 0), _span("b", 2, 4, 1, 0),
                            _span("c", 4, 8, 2, 0), _span("d", 12, 14, 3)])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 8, "c"), (8, 10, "a"),
                    (12, 14, "d")]
