"""Discovery by name: every cell of BENCHMARK.json finds its configuration,
its traffic mix and its per-layer readers as files, and a new cell, mix
and metric are found as new files with no edit to an existing one."""

import json
import shutil

import pytest

from portbench import spec
from portbench.generator import Traffic


def test_every_cell_finds_its_files():
    bench = spec.load_benchmark()
    assert bench["paths"] == ["portbench"]
    for w in bench["workloads"]:
        cfg = spec.load_config(w["config"])
        mix = spec.load_traffic(w["traffic"])
        assert cfg["resources"] > 0 and mix["width"] > 0
        for m in spec.per_layer(bench, w["name"]):
            assert callable(spec.metric_reader(m["name"]))
        names = {m["name"].split(".", 1)[0]
                 for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in names and len(names) >= 2
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).is_file()


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    cfg = json.loads((root / "portbench/configs/param100k.json").read_text())
    cfg["resources"] = 500
    (root / "portbench/configs/param500.json").write_text(json.dumps(cfg))
    mix = spec.load_traffic("uniform")
    mix["width"] = 64
    (root / "portbench/traffic/narrow.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/rounds_seen.py").write_text(
        "def read(t):\n    return float(t.rounds)\n")
    bench["workloads"].append({"name": "param500.narrow", "config": "param500",
                               "traffic": "narrow", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "host engine",
                               "moves": "checks_per_s",
                               "workloads": ["param500.narrow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    b = spec.load_benchmark(root / "BENCHMARK.json")
    w = spec.cell(b, "param500.narrow")
    cfg = spec.load_config(w["config"])
    tr = Traffic(spec.load_traffic(w["traffic"]), cfg["resources"], 1)
    assert tr.entries(0).resource.max() < 500 and tr.width == 64
    names = [m["name"] for m in spec.per_layer(b, "param500.narrow")]
    assert names == ["rounds_seen"]

    class T:
        rounds = 7
    assert spec.metric_reader("rounds_seen")(T()) == 7.0
    with pytest.raises(KeyError):
        spec.cell(b, "no.such.cell")


def test_rule_layout_follows_the_configuration():
    rules = spec.rule_layout(spec.load_config("mesh10k"))
    assert [r["resource"] for r in rules["flow"]] == list(range(10000))
    assert [r["resource"] for r in rules["param"]] == list(range(10000))
    assert {r["count"] for r in rules["flow"]} == {20}
    assert {r["count"] for r in rules["param"]} == {5}
    assert rules["degrade"] == []
    assert rules["system"] == [{"qps": 1e12}]


def test_rule_layout_every_and_offset():
    cfg = {"resources": 50, "rules": {"degrade": [
        {"every": 20, "offset": 5, "grade": "RT", "count": 100},
        {"every": 20, "offset": 6, "grade": "EXCEPTION_RATIO",
         "count": 0.5}]}}
    rules = spec.rule_layout(cfg)["degrade"]
    assert [(r["resource"], r["grade"]) for r in rules] == [
        (5, "RT"), (25, "RT"), (45, "RT"), (6, "EXCEPTION_RATIO"),
        (26, "EXCEPTION_RATIO"), (46, "EXCEPTION_RATIO")]
    assert all("every" not in r and "offset" not in r for r in rules)
