"""The control-plane audit journal in the port
(``sentinel_tpu_torch/telemetry/journal.py``) against the JAX package's.

Module level (no engine): the same seeded stream of records, with
``acting`` / ``causing`` contexts and explicit causes, goes into one
journal of each package on one injected clock. Records, tails, chains,
``in_force`` answers, counters and the bytes of every file (rotated
segments included) must be equal. A directory written by either package
is byte-chopped (a torn record, or a record that lost only its newline)
and recovered by both: the recovered journals and the files after one more
append must be equal, in both directions. The ``journal.disk.full`` seam
degrades both to the in-memory tail.

Engine level (one JAX engine and one port engine, both clocks frozen at
the same instant): the ``ruleLoad`` / ``rolloutStage`` / ``rolloutPromote``
/ ``rolloutAbort`` / ``clockSwap`` record streams, ``why_query`` and
``explain_trace`` for a blocked resource must be equal (the trace's
window, read by each pump at its own time, apart). Port-side lint:
no wall-clock read in ``journal.py`` / ``fleet.py``, and the journal /
fleet keys read only in ``core/config.py``, exactly the set
``docs/OPERATIONS.md`` documents.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

from sentinel_tpu.core import context as jctx
from sentinel_tpu.core.config import config as jcfg
from sentinel_tpu.core.engine import SentinelEngine as JEngine
from sentinel_tpu.core.exceptions import BlockException as JBlock
from sentinel_tpu.datasource import converters as JCV
from sentinel_tpu.resilience import faults as jfaults
from sentinel_tpu.telemetry import journal as JJ
from sentinel_tpu.utils import time_util as jtu

from sentinel_tpu_torch.core import context as pctx
from sentinel_tpu_torch.core.config import config as pcfg
from sentinel_tpu_torch.core.engine import SentinelEngine as PEngine
from sentinel_tpu_torch.core.exceptions import BlockException as PBlock
from sentinel_tpu_torch.datasource import converters as PCV
from sentinel_tpu_torch.resilience import faults as pfaults
from sentinel_tpu_torch.telemetry import journal as PJ
from sentinel_tpu_torch.utils import time_util as ptu

REPO = Path(__file__).resolve().parents[1]
NOW0 = 1_700_000_000_000
KINDS = ("ruleLoad", "rolloutStage", "rolloutPromote", "sloTransition",
         "adaptiveDecision", "clockSwap", "haRoleFlip")
PACKAGES = {"jax": (JJ, jfaults), "port": (PJ, pfaults)}


class Clock:
    def __init__(self, now):
        self.now = now

    def __call__(self):
        return self.now


def _stream(mod, journal, clock, seed, n=80):
    """The seeded record stream: kinds, fields, clock steps, provenance
    and causes drawn from one rng, so both packages see the same calls."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        clock.now += int(rng.integers(0, 1500))
        kind = KINDS[int(rng.integers(len(KINDS)))]
        fields = {"family": ("flow", "param", "degrade")[
                      int(rng.integers(3))],
                  "count": int(rng.integers(0, 50)),
                  "pad": "x" * int(rng.integers(0, 60))}
        mode = int(rng.integers(4))
        if mode == 0:
            with mod.acting(f"datasource:src{int(rng.integers(3))}"):
                journal.record(kind, **fields)
        elif mode == 1 and journal.last_seq:
            with mod.causing(int(rng.integers(1, journal.last_seq + 1))):
                journal.record(kind, **fields)
        elif mode == 2 and journal.last_seq:
            journal.record(kind, cause_seq=journal.last_seq, **fields)
        else:
            journal.record(kind, actor="ops:test", **fields)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _state(j, clock):
    st = j.stats()
    st.pop("path")
    last = j.last_seq
    return {
        "stats": st,
        "tail": j.tail(),
        "replay": j.replay(),
        "chain": j.chain(last) if last else [],
        "inForce": [j.in_force(clock.now - back, KINDS[:3], family=fam)
                    for back in (0, 2_000, 20_000) for fam in
                    ("flow", "param")],
        "find": [j.find(s) for s in range(1, last + 1, 7)],
    }


@pytest.mark.parametrize("seed", [1, 5])
def test_record_stream_files_and_reads_match(tmp_path, seed):
    """Same calls, same records, same files (three rotations deep)."""
    out = {}
    for name, (mod, _) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        clock = Clock(NOW0)
        j = mod.ControlPlaneJournal(clock, path=str(d / "audit.jsonl"),
                                    capacity=16, rotate_bytes=1500)
        _stream(mod, j, clock, seed)
        out[name] = (_state(j, clock), _files(d))
        j.close()
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0]["stats"]["rotations"] >= 3
    assert len(out["port"][1]) == 1 + PJ.ROTATE_SEGMENTS


def test_memory_only_journal_matches():
    """No path: the bounded tail only, replay serves the tail."""
    out = []
    for mod, _ in PACKAGES.values():
        clock = Clock(NOW0)
        j = mod.ControlPlaneJournal(clock, path="", capacity=8)
        _stream(mod, j, clock, seed=3, n=30)
        out.append(_state(j, clock))
    assert out[1] == out[0]
    assert out[1]["stats"]["retained"] == 8


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("chop", ["torn", "newline"])
def test_byte_chopped_directory_recovers_alike_in_both(tmp_path, writer,
                                                      chop):
    """One package writes, the tail is chopped (mid-record, or only the
    final newline), then each package recovers its own copy: the same
    records, the same seq cursor, the same drop count, and the same
    bytes after one more append."""
    wmod = PACKAGES[writer][0]
    src = tmp_path / "src"
    src.mkdir()
    clock = Clock(NOW0)
    j = wmod.ControlPlaneJournal(clock, path=str(src / "audit.jsonl"),
                                 capacity=64, rotate_bytes=2500)
    _stream(wmod, j, clock, seed=9, n=40)
    j.close()
    live = src / "audit.jsonl"
    data = live.read_bytes()
    cut = 1 if chop == "newline" else 2 + len(data) % 17
    live.write_bytes(data[:len(data) - cut])
    out = {}
    for name, (mod, _) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        for f, b in _files(src).items():
            (d / f).write_bytes(b)
        rclock = Clock(clock.now + 1000)
        r = mod.ControlPlaneJournal(rclock, path=str(d / "audit.jsonl"),
                                    capacity=64, rotate_bytes=2500)
        before = _state(r, rclock)
        seq = r.record("after", n=1)
        r.close()
        out[name] = (before, seq, _files(d))
    assert out["port"] == out["jax"]
    before, seq, _ = out["port"]
    assert before["stats"]["droppedPartial"] == (1 if chop == "torn" else 0)
    assert seq == before["stats"]["lastSeq"] + 1


def test_disk_full_seam_degrades_both_to_the_tail(tmp_path):
    out = []
    for name, (mod, fmod) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        clock = Clock(NOW0)
        j = mod.ControlPlaneJournal(clock, path=str(d / "a.jsonl"),
                                    capacity=16)
        j.record("k", i=0)
        with fmod.FaultInjector(seed=1) as inj:
            inj.arm("journal.disk.full", "error", times=1)
            j.record("k", i=1)
        j.record("k", i=2)
        st = j.stats()
        st.pop("path")
        out.append((st, j.tail(), _files(d)))
        j.close()
    assert out[1] == out[0]
    assert out[1][0]["durable"] is False and out[1][0]["lastSeq"] == 3


# ---------------------------------------------------------------------------
# engine level: one JAX engine and one port engine
# ---------------------------------------------------------------------------

TRACE_EVERY = "csp.sentinel.telemetry.trace.sampleEvery"


def _fresh_contexts():
    for ctx in (jctx, pctx):
        ctx.replace_context(None)
        ctx.bump_generation()


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine on frozen clocks at the same instant, every
    blocked device entry traced."""
    saved = [(cfg, cfg._config.get(TRACE_EVERY)) for cfg in (jcfg, pcfg)]
    for cfg in (jcfg, pcfg):
        cfg.set(TRACE_EVERY, "1")
    for tu in (jtu, ptu):
        tu.freeze_time(NOW0)
    _fresh_contexts()
    j = JEngine(capacity=128, journal_path="")
    p = PEngine(capacity=128, device="cpu")
    yield j, p
    for eng in (p, j):
        eng.close()
    for tu in (jtu, ptu):
        tu.unfreeze_time()
    for cfg, old in saved:
        if old is None:
            cfg._config.pop(TRACE_EVERY, None)
        else:
            cfg.set(TRACE_EVERY, old)
    _fresh_contexts()


def _both(engines, fn):
    j, p = engines
    return fn(j, JJ, JCV, JBlock, jtu), fn(p, PJ, PCV, PBlock, ptu)


def _flow(cv, *pairs):
    return cv.flow_rules_from_json(json.dumps(
        [{"resource": r, "count": c, "grade": 1} for r, c in pairs]))


def _drive(eng, block, res, n):
    passed = 0
    for _ in range(n):
        try:
            h = eng.entry(res)
        except block:
            continue
        passed += 1
        h.exit()
    return passed


def _journal(eng):
    return eng.journal.tail()


def test_engine_record_streams_match(engines):
    """Rule loads with provenance, a promote's causality (the merged
    ruleLoad links to the promote, which links to the staging record), an
    abort, and clock swaps: the same record stream on both engines."""
    def scenario(eng, jm, cv, block, tu):
        with jm.acting("datasource:DrillSource"):
            eng.flow_rules.load_rules(_flow(cv, ("rA", 4)))
        eng.degrade_rules.load_rules(cv.degrade_rules_from_json(json.dumps(
            [{"resource": "rA", "count": 1, "timeWindow": 5}])))
        eng.rollout.load_candidate("c1", {"flow": [
            {"resource": "rA", "count": 8, "grade": 1}]})
        eng.rollout.set_stage("c1", "canary", canary_bps=500)
        eng.rollout.promote("c1")
        eng.rollout.load_candidate("c2", {"flow": [
            {"resource": "rA", "count": 2, "grade": 1}]})
        eng.rollout.abort("c2", reason="drill")
        eng.set_clock(lambda: NOW0 + 99_000)
        eng.set_clock(None)
        merged = eng.journal.tail(kind="ruleLoad")[-1]
        return _journal(eng), eng.journal.chain(merged["seq"])
    (jrec, jchain), (prec, pchain) = _both(engines, scenario)
    assert prec == jrec
    assert pchain == jchain
    assert [r["kind"] for r in pchain] == [
        "ruleLoad", "rolloutPromote", "rolloutStage"]
    assert {r["kind"] for r in prec} >= {
        "ruleLoad", "rolloutStage", "rolloutPromote", "rolloutAbort",
        "clockSwap"}


def test_why_query_and_explain_trace_match(engines):
    """A FLOW-blocked resource under a staged candidate: the forensic join
    (the blocking rule, its provenance and cause chain, the candidate in
    force) and the trace join are equal on both engines."""
    def scenario(eng, jm, cv, block, tu):
        with jm.acting("datasource:WhySource"):
            eng.flow_rules.load_rules(_flow(cv, ("rW", 3)))
        eng.rollout.load_candidate("canary-1", {"flow": [
            {"resource": "rW", "count": 5, "grade": 1}]})
        passed = _drive(eng, block, "rW", 8)
        stamp = eng.now_ms()
        tu.advance_time(1500)
        out = eng.why_query("rW")
        past = eng.why_query("rW", stamp_ms=1_000)
        explained = eng.explain_trace("rW")
        eng.rollout.abort("canary-1")
        return passed, stamp, out, past, explained
    jout, pout = _both(engines, scenario)
    # The trace's window is read by each pump when it processes the batch,
    # not at the step (the reference's own timing, C16): compared apart.
    for got in (jout[4], pout[4]):
        assert set(got["trace"].pop("window")) == {"passQps", "blockQps",
                                                   "curThreadNum"}
        assert got["occupancy"].pop("windowAtTrace") is not None
    assert pout == jout
    passed, stamp, out, past, explained = pout
    assert passed == 3
    assert out["second"]["timestamp"] == stamp - stamp % 1000
    assert out["verdict"]["reason"] == "FLOW"
    assert out["verdict"]["blockedThatSecond"] == 5
    assert out["verdict"]["provenance"]["actor"] == "datasource:WhySource"
    assert out["candidateInForce"]["name"] == "canary-1"
    assert past["second"] is None and past["verdict"] is None
    assert explained is not None
    assert explained["verdict"]["reason"] == "FLOW"
    assert explained["occupancy"]["blockThatSecond"] == 5


# ---------------------------------------------------------------------------
# port-side lint (the reference's pins on sentinel_tpu/, mirrored)
# ---------------------------------------------------------------------------

WALL = re.compile(r"\btime\.time\(|\bdatetime\.now\(|\btime\.monotonic\(|"
                  r"\btime_util\.current_time_millis\(")


def _code_lines(path):
    """(lineno, code) with comments and docstrings dropped."""
    import ast
    import io
    import tokenize

    src = path.read_text()
    lines = src.splitlines()
    doc = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            doc.update(range(node.lineno, node.end_lineno + 1))
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT:
            row, col = tok.start
            lines[row - 1] = lines[row - 1][:col]
    return [(i, line) for i, line in enumerate(lines, 1)
            if i not in doc and line.strip()]


@pytest.mark.parametrize("name", ["journal.py", "fleet.py"])
def test_no_wall_clock_in_port_journal_and_fleet(name):
    path = REPO / "sentinel_tpu_torch" / "telemetry" / name
    offenders = [n for n, code in _code_lines(path) if WALL.search(code)]
    assert not offenders, f"wall-clock read in {path}: lines {offenders}"


def test_port_journal_fleet_keys_only_in_config_and_documented():
    pattern = re.compile(
        r"[\"']csp\.sentinel\.(?:journal|fleet)\.[a-z.]+[\"']")
    keys, offenders = set(), []
    for path in sorted((REPO / "sentinel_tpu_torch").rglob("*.py")):
        for m in pattern.findall(path.read_text()):
            key = m.strip("\"'")
            keys.add(key)
            if path.relative_to(REPO).as_posix() != \
                    "sentinel_tpu_torch/core/config.py":
                offenders.append(f"{path}: {key}")
    assert not offenders, offenders
    ops = (REPO / "docs" / "OPERATIONS.md").read_text()
    documented = set(re.findall(r"csp\.sentinel\.(?:journal|fleet)\.[a-z.]+",
                                ops))
    assert keys == documented, (sorted(keys), sorted(documented))


def test_port_files_are_not_rewritten_in_place():
    """Append-only: the journal never seeks or truncates a file it wrote
    (rotation renames)."""
    path = REPO / "sentinel_tpu_torch" / "telemetry" / "journal.py"
    code = "\n".join(c for _, c in _code_lines(path))
    assert ".seek(" not in code and ".truncate(" not in code
    assert '"w"' not in code and "'w'" not in code
