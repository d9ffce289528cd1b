"""The run's last line and what a run may import."""

import json
import subprocess
import sys

from portbench import run, spec

ROOT = str(spec.ROOT)


def test_result_line_shape(tmp_path):
    res = run.CellRun("mesh10k.uniform", 31, 0, False, device="cpu",
                      width=128, rounds=12,
                      log_dir=str(tmp_path / "logs")).run()
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"checks_per_s",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"]["mismatches"]["limit"] == 0


def test_trace_line_carries_per_layer_metrics(tmp_path):
    res = run.CellRun("mesh10k.uniform", 32, 0, True, device="cpu",
                      width=128, rounds=12,
                      log_dir=str(tmp_path / "logs")).run()
    names = {m["name"] for m in spec.per_layer(spec.load_benchmark(),
                                               "mesh10k.uniform")}
    assert set(res["metrics"]) <= names
    # The counters need no card; the trace's readers return nothing here.
    assert res["metrics"]["prefix_calls_per_step"]["value"] == 4.0
    assert res["metrics"]["host_syncs_per_round"]["value"] > 0


def test_without_a_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        return
    rc = run.main(["--workload", "mesh10k.uniform", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert "{" not in capsys.readouterr().out


def _top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax(tmp_path):
    code = (
        "import json, sys\n"
        "from portbench.run import CellRun\n"
        f"CellRun('mesh10k.uniform', 3, 0, True, device='cpu', width=64, "
        f"rounds=3, log_dir={str(tmp_path)!r}).run()\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _top_level_modules(code)
    assert "sentinel_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "sentinel_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import portbench.reference, portbench.judge, portbench.control\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    mods = _top_level_modules(code)
    assert not mods & {"jax", "jaxlib", "flax", "sentinel_tpu",
                       "sentinel_tpu_torch"}
