"""The comparison that decides ``correct``, on the CPU at a small width:
the port's CPU path agrees with the plain reference in every cell; the
lower-precision control, and each fault planted under the timed path,
come out as not correct."""

import copy
import json
import shutil

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.control import control_reading
from portbench.run import CellRun

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# Cells that PERF.md keeps for later, out of BENCHMARK.json while the
# program is at fault there: their files stay held to the port.
KEPT = [{"name": "mesh10k.zipf", "config": "mesh10k",
         "traffic": "hot_resources", "chips": 1, "why": "kept"},
        {"name": "param100k.zipf", "config": "param100k",
         "traffic": "hot_keys", "chips": 1, "why": "kept"}]
ALL = CELLS + [w["name"] for w in KEPT if w["name"] not in CELLS]
WIDTH = 256
ROUNDS = 30


@pytest.fixture
def kept_cells(monkeypatch):
    bench = spec.load_benchmark()
    bench["workloads"] += [w for w in KEPT if w["name"] not in CELLS]
    monkeypatch.setattr(spec, "load_benchmark", lambda path=None: bench)


def run_cpu(workload, seed, fault=None, tmp_path=None, width=WIDTH,
            rounds=ROUNDS):
    return CellRun(workload, seed, 0, False, device="cpu", width=width,
                   rounds=rounds, fault=fault,
                   log_dir=str(tmp_path / "logs")).run()


@pytest.mark.parametrize("workload", ALL)
def test_port_agrees_with_reference(workload, tmp_path, kept_cells):
    res = run_cpu(workload, 2**33 + 17, tmp_path=tmp_path)
    assert res["checks"]["mismatches"] == {"value": 0, "limit": 0}
    assert res["correct"] is True
    assert res["attempted"] == WIDTH * ROUNDS


@pytest.mark.parametrize("workload", ALL)
def test_lower_precision_control_is_rejected(workload, kept_cells):
    # At the cell's own width: at a small one every count a step commits
    # to a node is exact in bfloat16.
    reading = control_reading(workload, 2**32 + 5, rounds=30)
    assert reading["mismatches"] > reading["limit"]


def _stateless_entry(eng):
    step = eng._entry_step

    def broken(state, rules, batch, now, **kw):
        _, dec = step(copy.deepcopy(state), rules, batch, now, **kw)
        return state, dec
    eng._entry_step = broken


def _stateless_exit(eng):
    eng._exit_step = lambda state, rules, batch, now, **kw: state


def _half_batch(eng):
    step = eng._entry_step

    def broken(state, rules, batch, now, **kw):
        half = batch.size // 2
        rows = batch.cluster_row.clone()
        rows[half:] = -1
        state, dec = step(state, rules, batch._replace(cluster_row=rows),
                          now, **kw)
        reason = dec.reason.clone()
        reason[half:] = reason[:batch.size - half]
        return state, dec._replace(reason=reason)
    eng._entry_step = broken


def _altered_answer(eng):
    step = eng._entry_step
    calls = [0]

    def broken(state, rules, batch, now, **kw):
        state, dec = step(state, rules, batch, now, **kw)
        calls[0] += 1
        if calls[0] == 20:
            reason = dec.reason.clone()
            reason[3] = 1 if int(reason[3]) == 0 else 0
            dec = dec._replace(reason=reason)
        return state, dec
    eng._entry_step = broken


# The exchange between chips is not a fault these cells can have: each
# runs on one chip.
FAULTS = {"entry_state_unchanged": _stateless_entry,
          "exit_state_unchanged": _stateless_exit,
          "half_batch_left_out": _half_batch,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, tmp_path, kept_cells):
    res = run_cpu("mesh10k.zipf", 4242, fault=FAULTS[fault],
                  tmp_path=tmp_path)
    assert res["correct"] is False
    assert res["checks"]["mismatches"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_card_agrees_with_reference(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = CellRun(workload, 77, 0, False, device="cuda", rounds=20,
                  log_dir=str(tmp_path / "logs")).run()
    assert res["correct"] is True


def test_degrade_and_origin_paths_agree_with_reference(tmp_path,
                                                      monkeypatch):
    """The benchmark's cells hold no breakers and no origins, but a later
    cell may add them as data files alone: the reference's breakers and
    origin nodes are held to the port here, on a configuration made for
    the test, where breakers of all three grades trip."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = spec.load_config("mesh10k")
    cfg.update(resources=300, capacity=2048, origin="appA")
    breaker = {"time_window": 2, "min_request_amount": 5,
               "stat_interval_ms": 1000, "slow_ratio_threshold": 0.5}
    cfg["rules"] = {
        "flow": [{"every": 3, "count": 12}],
        "degrade": [dict(breaker, every=3, offset=i, grade=grade,
                         count=count)
                    for i, (grade, count) in enumerate(
                        (("RT", 100), ("EXCEPTION_RATIO", 0.25),
                         ("EXCEPTION_COUNT", 4)))],
        "system": [{"qps": 1e12}]}
    mix = dict(spec.load_traffic("uniform"), origin_share=0.2,
               rt_ms=[1, 249], error_share=0.2)
    (root / "portbench/configs/probe.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/probe.json").write_text(json.dumps(mix))
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "probe.mixed", "config": "probe",
                               "traffic": "probe", "chips": 1, "why": "x"})
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    monkeypatch.setattr(spec, "load_benchmark", lambda path=None: bench)
    run = CellRun("probe.mixed", 2**33 + 3, 0, False, device="cpu",
                  width=WIDTH, rounds=60, log_dir=str(tmp_path / "logs"))
    res = run.run()
    reasons = np.concatenate(run.verdicts)
    from portbench.reference import R_DEGRADE, R_FLOW
    assert np.any(reasons == R_DEGRADE) and np.any(reasons == R_FLOW)
    assert res["checks"]["mismatches"] == {"value": 0, "limit": 0}


def test_ring_may_hold_the_staged_second():
    from portbench.judge import compare

    cells = np.arange(12).reshape(6, 2)
    ref = {"totals": cells, "seconds": {1000: cells}, "threads": np.zeros(2),
           "breakers": np.zeros((0, 3)), "staging": (2000, cells + 1)}
    prog = dict(ref, seconds={1000: cells, 2000: cells + 1}, outside=0)
    assert sum(compare(prog, ref, 128).values()) == 0
    prog["seconds"][2000] = cells
    assert compare(prog, ref, 128)["seconds"] == 12
    prog["seconds"] = {1000: cells, 3000: cells}
    assert compare(prog, ref, 128)["seconds"] == 1
