"""Run one cell with the program's span recorder on, and read its spans.

    python3 -m portbench.spans --workload mesh10k.uniform --seed 7 \\
        --seconds 51 --trace 1

runs the cell exactly as ``portbench.run`` does, with the recorder of
``sentinel_tpu_torch/metrics/profiling.py`` started at the window's first
round: the batch path, the metric seal and the trace pump report spans and
counters from inside the program, on ``time.time_ns()``, the clock the
profiler stamps its events with. With ``--trace 0`` the window is not
profiled, so its ``checks_per_s`` set beside ``portbench.run``'s gives
the recorder's cost.

The last line is ``portbench.run``'s result, its ``metrics`` joined by
:data:`METRICS`, and with ``--trace 1`` its ``breakdown`` by
``idle_by_span``: each device-idle gap of the profiled slice named by the
innermost program span open on the admission thread at the gap's
midpoint, or ``untraced``. The line before it, ``{"spans": ...}``, holds
the syncs a round by site, each span's self time a round, the other
threads' counters, the trace pump's time split into its own Python, its
waits for copies and its reads of the engine, the slice's idle time
beside an open seal span and beside each part of the pump (each on its
own thread), and how far the program's ``check_batch`` spans start from
the harness's ``portbench.check_batch`` ranges.

Each ``_per_round`` metric and each span time is over the window's rounds
outside the profiled slice, as ``verdict_p99_ms.closed_loop`` is; the
seal's are means over the ticks that began in the window, as ``seal_ms``
is.
"""

from __future__ import annotations

import bisect
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run, tracing  # noqa: E402

# name -> unit; each should move checks_per_s.
METRICS = {
    "lock_wait_ms_per_round": "ms",
    "batch_staging_ms_per_round": "ms",
    "entry_step_ms": "ms",
    "exit_step_ms": "ms",
    "fixpoint_sweeps_per_step": "sweeps",
    "loop_telemetry_ms_per_round": "ms",
    "trace_pump_busy_pct": "%",
    "seal_read_ms": "ms",
    "seal_nodes_ms": "ms",
    "seal_write_ms": "ms",
}
SEAL_READ = ("seal.flush_committer", "seal.lock_wait", "seal.read")
# The trace pump's parts: a span of these names is innermost over them.
PUMP_PARTS = {"python": "pump.process", "wait": "pump.wait",
              "row_stats": "pump.row_stats"}
UNTRACED = "untraced"

Interval = Tuple[int, int]


class SpannedRun(run.CellRun):
    """A :class:`portbench.run.CellRun` with the span recorder on from the
    window's first round; ``run()`` returns the result with the span
    reading joined."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.rounds_ns: List[Tuple[int, int, bool]] = []  # window rounds
        self.counters: Dict[str, int] = {}  # the loop's, after the last
        self.profile = None  # the profiled slice's, read after the window

    def _round(self, r: int, profiling: bool = False) -> float:
        from sentinel_tpu_torch.metrics import profiling as prof

        window = r >= self.traffic.warm_rounds
        if window and prof.recorder is None:
            prof.start()
        t0 = time.time_ns()
        out = super()._round(r, profiling)
        if window:
            self.rounds_ns.append((t0, time.time_ns(), profiling))
            self.counters = prof.recorder.thread_counters()
        return out

    def _profile_slice(self, r: int, spans) -> object:
        self.profile = super()._profile_slice(r, spans)
        return self.profile

    def run(self) -> Dict:
        from sentinel_tpu_torch.metrics import profiling as prof

        loop_tid = threading.get_native_id()
        try:
            result = super().run()
        finally:
            rec = prof.stop()
        snap = rec.snapshot() if rec is not None else {"threads": []}
        # Read after the window: the profiler builds its events on first
        # use, which takes seconds.
        slice_ = slice_reading(self.profile) if self.profile else None
        self.profile = None
        metrics, extra = read_spans(snap, loop_tid, self.rounds_ns,
                                    self.counters, slice_)
        for name, value in metrics.items():
            if value is not None:
                result["metrics"][name] = {"value": value,
                                           "unit": METRICS[name]}
        if "idle_by_span" in extra and "breakdown" in result:
            result["breakdown"]["idle_by_span"] = extra["idle_by_span"]
        run.log({"spans": extra})
        return result


# -- the profiled slice -------------------------------------------------------

def slice_reading(prof) -> Optional[Dict]:
    """The slice's bounds, the device's busy intervals inside it and the
    starts of the harness's ``check_batch`` ranges, on ``time.time_ns()``:
    an event at ``t`` microseconds lies at ``trace_start_ns() + 1000 t``.
    None where the profiler does not give its clock's origin."""
    from torch.autograd import DeviceType

    kineto = prof.profiler.kineto_results
    if not hasattr(kineto, "trace_start_ns"):
        return None
    origin = kineto.trace_start_ns()

    def ns(us: float) -> int:
        return origin + int(round(us * 1000))

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    bounds = [e for e in cpu if e.name == tracing.SLICE_RANGE]
    if not bounds:
        return None
    lo, hi = bounds[0].time_range.start, bounds[0].time_range.end
    # The device operations reduce_profile counts.
    dev = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
           for e in events if e.device_type != DeviceType.CPU
           and not e.name.startswith("portbench.")
           and e.time_range.end > lo and e.time_range.start < hi]
    return {"lo_ns": ns(lo), "hi_ns": ns(hi),
            "busy_ns": [(ns(a), ns(b)) for a, b in tracing._union(dev)],
            "harness_check_batch_ns": sorted(
                ns(e.time_range.start) for e in cpu
                if e.name == "portbench.check_batch")}


# -- reading the spans --------------------------------------------------------

def _dur(s: Dict) -> int:
    return s["end_ns"] - s["start_ns"]


def innermost(spans: Sequence[Dict]) -> List[Tuple[int, int, str]]:
    """Disjoint, sorted segments of one thread's time, each named by the
    innermost span open over it (a thread's spans nest)."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    cursor = 0
    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        while stack and stack[-1][0] <= s["start_ns"]:
            end, name = stack.pop()
            segs.append((cursor, end, name))
            cursor = end
        if stack:
            segs.append((cursor, s["start_ns"], stack[-1][1]))
        stack.append((s["end_ns"], s["name"]))
        cursor = s["start_ns"]
    while stack:
        end, name = stack.pop()
        segs.append((cursor, end, name))
        cursor = end
    return [g for g in segs if g[1] > g[0]]


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _union(spans: Sequence[Dict]) -> List[Interval]:
    return [(a, b) for a, b in tracing._union(
        (s["start_ns"], s["end_ns"]) for s in spans)]


def read_spans(snap: Dict, loop_tid: int,
               rounds: Sequence[Tuple[int, int, bool]],
               counters: Dict[str, int], slice_: Optional[Dict]
               ) -> Tuple[Dict[str, Optional[float]], Dict]:
    """(:data:`METRICS` by name, the trace line's extra readings)."""
    metrics: Dict[str, Optional[float]] = {m: None for m in METRICS}
    extra: Dict = {"dropped": sum(t["dropped"] for t in snap["threads"])}
    if not rounds:
        return metrics, extra
    w0, w1 = rounds[0][0], rounds[-1][1]
    plain = [(a, b) for a, b, profiled in rounds if not profiled]
    starts = [a for a, _ in plain]

    def in_plain_round(t: int) -> bool:
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= plain[k][1]

    loop = next((t for t in snap["threads"] if t["tid"] == loop_tid),
                {"spans": [], "counters": {}})
    kept = [s for s in loop["spans"] if in_plain_round(s["start_ns"])]
    n = len(plain)

    def per_round(*names: str) -> Optional[float]:
        if not n:
            return None
        return sum(_dur(s) for s in kept if s["name"] in names) / n / 1e6

    def mean(name: str) -> Optional[float]:
        d = [_dur(s) for s in kept if s["name"] == name]
        return sum(d) / len(d) / 1e6 if d else None

    metrics["lock_wait_ms_per_round"] = per_round("lock_wait")
    metrics["batch_staging_ms_per_round"] = per_round("to_device")
    metrics["entry_step_ms"] = mean("step.entry")
    metrics["exit_step_ms"] = mean("step.exit")
    metrics["loop_telemetry_ms_per_round"] = per_round(
        "telemetry.traces_submit", "telemetry.population")
    metrics["fixpoint_sweeps_per_step"] = \
        counters.get("fixpoint.sweeps", 0) / len(rounds)
    extra["syncs_per_round_by_site"] = {
        k: v / len(rounds) for k, v in sorted(counters.items())
        if k.startswith("sync.")}
    extra["counters_per_round"] = {
        k: v / len(rounds) for k, v in sorted(counters.items())
        if not k.startswith("sync.")}

    others = [t for t in snap["threads"] if t["tid"] != loop_tid]
    extra["other_threads"] = [{"thread": t["thread"],
                               "counters": t["counters"]}
                              for t in others if t["counters"]]
    # The pump's own Python: its spans less their waits and engine reads.
    if w1 > w0:
        pump = pump_parts(others)
        share = {k: 100.0 * overlap(v, [(w0, w1)]) / (w1 - w0)
                 for k, v in pump.items()}
        metrics["trace_pump_busy_pct"] = share["python"]
        items = sum(t["counters"].get("pump.items", 0) for t in others)
        extra["pump"] = {"pct_of_window": share, "items": items}

    # The seal: each tick from its committer flush to the next tick's.
    ticks: List[Dict[str, int]] = []
    for t in others:
        seal = sorted((s for s in t["spans"] if s["name"].startswith("seal.")),
                      key=lambda s: s["start_ns"])
        cuts = [s["start_ns"] for s in seal
                if s["name"] == "seal.flush_committer"]
        for k, c in enumerate(cuts):
            if not w0 <= c <= w1:
                continue
            nxt = cuts[k + 1] if k + 1 < len(cuts) else None
            tick: Dict[str, int] = {}
            for s in seal:
                if s["start_ns"] >= c and (nxt is None or s["start_ns"] < nxt):
                    tick[s["name"]] = tick.get(s["name"], 0) + _dur(s)
            ticks.append(tick)
    if ticks:
        def seal_mean(names):
            return sum(sum(t.get(x, 0) for x in names)
                       for t in ticks) / len(ticks) / 1e6

        metrics["seal_read_ms"] = seal_mean(SEAL_READ)
        metrics["seal_nodes_ms"] = seal_mean(("seal.nodes",))
        metrics["seal_write_ms"] = seal_mean(("seal.write",))
    extra["seal_ticks"] = len(ticks)

    # Self time a round: a span less its children, over the plain rounds.
    if n:
        self_ns: Dict[str, int] = {}
        for t in snap["threads"]:
            spans = [s for s in t["spans"] if in_plain_round(s["start_ns"])]
            child = {}
            for s in t["spans"]:
                if s["parent"] is not None:
                    child[s["parent"]] = child.get(s["parent"], 0) + _dur(s)
            for s in spans:
                self_ns[s["name"]] = self_ns.get(s["name"], 0) + \
                    _dur(s) - child.get(s["id"], 0)
        extra["self_ms_per_round"] = {
            k: v / n / 1e6 for k, v in sorted(self_ns.items(),
                                              key=lambda kv: -kv[1])}

    if slice_ is not None:
        extra.update(read_slice(slice_, loop["spans"], others))
    return metrics, extra


def pump_parts(others: Sequence[Dict]) -> Dict[str, List[Interval]]:
    """The trace pump's time by :data:`PUMP_PARTS`, as sorted disjoint
    intervals: each instant goes to the innermost pump span open then."""
    out: Dict[str, List[Interval]] = {}
    for part, name in PUMP_PARTS.items():
        out[part] = [(a, b) for a, b in tracing._union(
            (a, b) for t in others
            for a, b, n in innermost([s for s in t["spans"]
                                      if s["name"].startswith("pump.")])
            if n == name)]
    return out


def read_slice(slice_: Dict, loop_spans: Sequence[Dict],
               others: Sequence[Dict]) -> Dict:
    """The slice's idle gaps named by the loop's innermost span, the idle
    time beside the seal's spans and each part of the pump, and the clock
    check."""
    lo, hi = slice_["lo_ns"], slice_["hi_ns"]
    edges = [lo] + [x for ab in slice_["busy_ns"] for x in ab] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    segs = innermost([s for s in loop_spans
                      if s["end_ns"] > lo and s["start_ns"] < hi])
    seg_starts = [g[0] for g in segs]
    by_span: Dict[str, float] = {}
    for a, b in idle:
        mid = (a + b) // 2
        k = bisect.bisect_right(seg_starts, mid) - 1
        name = segs[k][2] if k >= 0 and mid < segs[k][1] else UNTRACED
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-9
    idle_s = sum(b - a for a, b in idle) * 1e-9

    seal = _union([s for t in others for s in t["spans"]
                   if s["name"].startswith("seal.")])

    program = sorted(s["start_ns"] for s in loop_spans
                     if s["name"] == "check_batch"
                     and lo <= s["start_ns"] <= hi)
    harness = slice_["harness_check_batch_ns"]
    offsets = [(p - h) / 1e6 for p, h in zip(program, harness)]
    return {
        "idle_by_span": [[k, v] for k, v in sorted(by_span.items(),
                                                   key=lambda kv: -kv[1])],
        "slice_idle_s": idle_s,
        "untraced_share": by_span.get(UNTRACED, 0.0) / idle_s if idle_s
        else None,
        "idle_beside_seal_s": overlap(idle, seal) * 1e-9,
        "idle_beside_pump_s": {k: overlap(idle, v) * 1e-9
                               for k, v in pump_parts(others).items()},
        "check_batch_starts": [len(program), len(harness)],
        "check_batch_start_offset_ms": [min(offsets), max(offsets)]
        if offsets else None,
    }


def main(argv=None) -> int:
    """``portbench.run``'s command line, with :class:`SpannedRun` in place
    of its ``CellRun``."""
    cell_run = run.CellRun
    run.CellRun = SpannedRun
    try:
        return run.main(argv)
    finally:
        run.CellRun = cell_run


if __name__ == "__main__":
    sys.exit(main())
