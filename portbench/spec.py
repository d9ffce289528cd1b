"""Discovery by name: the benchmark's cells, configurations, traffic mixes
and per-layer metric readers.

Everything a cell needs is found from ``BENCHMARK.json`` at the checkout's
root and from files named after the entries there:

- a configuration ``<name>`` is ``portbench/configs/<name>.json``;
- a traffic mix ``<name>`` is ``portbench/traffic/<name>.json``, the
  parameters that :mod:`portbench.generator` reads;
- a per-layer metric ``<name>`` is ``portbench/metrics/<name>.py``, a
  module with ``read(trace) -> float | None``.

A later change adds a cell, a mix or a metric as new files and new entries
in ``BENCHMARK.json``; no file here changes. This module imports neither
the program nor the reference.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> Dict:
    with open(HERE / "configs" / f"{name}.json", encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["name"] = name
    return cfg


def load_traffic(name: str) -> Dict:
    with open(HERE / "traffic" / f"{name}.json", encoding="utf-8") as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def end_to_end(bench: Dict, workload: str) -> List[Dict]:
    """The cell's end-to-end metrics: those without a ``workloads`` key,
    and those that list the cell."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench: Dict, workload: str) -> List[Dict]:
    """The cell's per-layer metrics, by the same rule."""
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])]


def metric_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``, loaded
    from its file (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(name)}_{abs(hash(name))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resource_names(cfg: Dict) -> List[str]:
    return [f"{cfg['resource_prefix']}{i}" for i in range(cfg["resources"])]


def rule_layout(cfg: Dict) -> Dict[str, List[Dict]]:
    """The rules a configuration states, one dict per rule, in load
    order: ``{"flow": [...], "param": [...], "degrade": [...],
    "system": [...]}``. Each per-resource rule carries ``resource``, the
    index of its resource. Shared by the program's set-up and the
    reference, so both hold the same rules."""
    n = cfg["resources"]
    out: Dict[str, List[Dict]] = {"flow": [], "param": [], "degrade": [],
                                  "system": []}
    for fam in ("flow", "param", "degrade"):
        for spec in cfg["rules"].get(fam, []):
            every = int(spec["every"])
            for i in range(int(spec.get("offset", 0)), n, every):
                rule = {k: v for k, v in spec.items()
                        if k not in ("every", "offset")}
                rule["resource"] = i
                out[fam].append(rule)
    out["system"] = list(cfg["rules"].get("system", []))
    return out
