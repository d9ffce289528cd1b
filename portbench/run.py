"""Run one cell of the port's benchmark.

    python3 -m portbench.run --workload mesh10k.uniform --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for. A cell is a closed loop with one batch in flight, as a gateway tier
that coalesces its callers' entries drives the batch API: each round
calls ``check_batch`` on one batch of the mix's width, brings the verdicts
to the host with ``harvest_decisions``, calls ``complete_batch`` with the
admitted lanes' exits, and advances the engine's clock by the mix's step
of trace time. Beside the loop, ``MetricTimerListener`` seals the metric
log once a second of wall time, as every upstream process does.

Set-up (counted in ``setup_s``): the engine, the configuration's rows and
rules, one warm-up step at the cell's width, the mix's warm-up rounds and
one seal. The window then runs rounds for ``--seconds``. Afterwards the
plain reference replays every round from the same seed and the comparison
decides ``correct``.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics; with ``--trace 1``, its per-layer metrics, each read
by ``portbench/metrics/<name>.py``, and a breakdown of the profiled slice.
Earlier lines say what ran; the last lines of standard error give each
number compared beside its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

T_IMPORT = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from portbench import judge, spec, tracing  # noqa: E402
from portbench.generator import Traffic  # noqa: E402

T0_MS = 1_700_000_000_000
# Fixed cache directories inside the checkout for any kernel build torch
# or triton would make; the port's own nvcc libraries live in
# sentinel_tpu_torch/_build/.
CACHE_ROOT = Path(__file__).resolve().parent.parent / "portbench_tmp"
PROFILED_ROUNDS = 40
PROFILE_AFTER_ROUNDS = 20
FORBIDDEN = ("jax", "jaxlib", "flax", "sentinel_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was imported where there is no ``/proc``."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin_threads(timer_tid: int) -> None:
    """Pins the admission loop's thread and the metric timer's thread each
    to a core of its own, among the cores the process may use (the first
    is left to the rest), so that the two threads, which hand the
    interpreter lock to each other, do not share or swap cores from run
    to run (PERF.md). Nothing is pinned on fewer than three cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) >= 3:
        os.sched_setaffinity(0, {cores[1]})
        os.sched_setaffinity(timer_tid, {cores[2]})


def smi_line() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


class CellRun:
    """One run of one cell. ``device`` is ``"cuda"`` in every benchmark
    run; the tests pass ``"cpu"`` with a small ``width`` and a fixed
    number of ``rounds`` in place of ``seconds``. ``fault`` (tests only)
    gets the engine after set-up, to break the timed path underneath."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 width: Optional[int] = None, rounds: Optional[int] = None,
                 fault: Optional[Callable] = None,
                 log_dir: Optional[str] = None):
        self.bench = spec.load_benchmark()
        self.cell = spec.cell(self.bench, workload)
        self.cfg = spec.load_config(self.cell["config"])
        self.mix = spec.load_traffic(self.cell["traffic"])
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.device = device
        self.max_rounds = rounds
        self.fault = fault
        if float(self.mix["origin_share"]) > 0 and not self.cfg.get("origin"):
            raise ValueError(f"{self.cell['traffic']} names an origin that "
                             f"{self.cell['config']} does not have")
        self.traffic = Traffic(self.mix, self.cfg["resources"], self.seed,
                               width=width)
        self.width = self.traffic.width
        tmp = os.environ.get("TMPDIR") or str(CACHE_ROOT)
        self.log_dir = log_dir or os.path.join(tmp, "portbench-logs")
        self.verdicts: List[np.ndarray] = []
        self.waits: List = []
        self.trace = tracing.Trace()

    # -- one round ------------------------------------------------------------

    def _round(self, r: int, profiling: bool = False) -> float:
        eng, dep, clock = self.engine, self.dep, self.clock
        with tracing.host_range("batch", profiling):
            lanes = self.traffic.entries(r)
            buf = dep.entry_batch(lanes)
        t0 = time.perf_counter()
        with tracing.host_range("check_batch", profiling):
            dec = eng.check_batch(buf)
        with tracing.host_range("harvest", profiling):
            reason, wait = eng.harvest_decisions(dec)
        t1 = time.perf_counter()
        self.verdicts.append(dep.reason_codes(reason))
        nz = np.flatnonzero(wait)
        self.waits.append((nz, np.asarray(wait[nz], np.int64)))
        with tracing.host_range("batch", profiling):
            xb = dep.exit_batch(lanes, reason, self.traffic.exits(r))
        with tracing.host_range("complete_batch", profiling):
            eng.complete_batch(xb)
        clock.now += self.traffic.step_ms
        return t1 - t0

    # -- the run --------------------------------------------------------------

    def run(self) -> Dict:
        import torch

        from portbench.deploy import Clock, Deployment

        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        os.makedirs(self.log_dir, exist_ok=True)
        from sentinel_tpu_torch.core import config as pconfig
        pconfig.config.set(pconfig.LOG_DIR, self.log_dir)
        from sentinel_tpu_torch.metrics.timer import MetricTimerListener
        from sentinel_tpu_torch.metrics.writer import MetricWriter
        from sentinel_tpu_torch.utils.device import SYNCS

        if self.device == "cuda":
            log({"card": smi_line(), "torch": torch.__version__,
                 "cuda": torch.version.cuda})
        stages = {"to_import": process_age_s()}
        self.clock = Clock(T0_MS)
        self.dep = Deployment(self.cfg, self.device, self.clock, self.width)
        self.engine = eng = self.dep.engine
        stages["engine_rows_rules"] = process_age_s()
        eng.warmup(widths=[self.width])
        stages["warmup_step"] = process_age_s()
        if self.fault is not None:
            self.fault(eng)
        for r in range(self.traffic.warm_rounds):
            self._round(r)
        stages["warm_rounds"] = process_age_s()
        timer = MetricTimerListener(
            eng, writer=MetricWriter(base_dir=self.log_dir), period_s=1.0)
        ticks: List = []
        window_open = [False]
        inner_tick = timer.tick

        def tick(now_ms=None):
            t = time.perf_counter()
            n = inner_tick(now_ms)
            t_end = time.perf_counter()
            self.trace.seal_spans.append((t, t_end))
            if window_open[0]:
                ticks.append((t_end - t, n))
            return n

        timer.tick = tick
        timer.tick()
        spans = per_thread = None
        if self.trace_on:
            spans = tracing.PrefixSpans(self.trace).install()
            per_thread = tracing.PerThreadCount(SYNCS).__enter__()
            if self.device == "cuda":
                # The profiler's first use loads CUPTI: pay it in set-up.
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]):
                    torch.zeros(1, device="cuda").add_(1)
        if self.device == "cuda":
            torch.cuda.synchronize()
        timer.start()
        if self.device == "cuda":
            pin_threads(timer._thread.native_id)
        setup_s = process_age_s()
        stages["seal_and_timer"] = setup_s
        log({"setup": {"workload": self.workload, "seed": self.seed,
                       "width": self.width, "setup_s": setup_s,
                       "warm_rounds": self.traffic.warm_rounds,
                       "done_at_s": stages}})

        # -- the window --------------------------------------------------------
        r = self.traffic.warm_rounds
        latencies: List[float] = []
        prof = None
        syncs0 = SYNCS.count
        if spans is not None:
            spans.counting = True
        window_open[0] = True
        t_start = time.perf_counter()
        deadline = t_start + self.seconds
        while True:
            if self.max_rounds is not None:
                if len(latencies) >= self.max_rounds:
                    break
            elif time.perf_counter() >= deadline:
                break
            k = len(latencies)
            if self.trace_on and k == PROFILE_AFTER_ROUNDS and \
                    self.device == "cuda":
                prof = self._profile_slice(r, spans)
                r += PROFILED_ROUNDS
                latencies.extend([np.nan] * PROFILED_ROUNDS)
                continue
            latencies.append(self._round(r))
            r += 1
        if self.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t_start
        window_open[0] = False
        if spans is not None:
            spans.counting = False
        rounds = len(latencies)
        self.trace.rounds = rounds
        self.trace.host_syncs = SYNCS.count - syncs0
        if per_thread is not None:
            per_thread.__exit__(None, None, None)
        if spans is not None:
            spans.uninstall()
        timer.stop()
        self.trace.seal_s = [s for s, _ in ticks]

        device = {"platform": "gpu" if self.device == "cuda" else "cpu",
                  "kind": (torch.cuda.get_device_name(0)
                           if self.device == "cuda" else "cpu"),
                  "count": 1,
                  "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                        if self.device == "cuda" else 0)}
        self.trace.peaks = {"kind": device["kind"]}
        if prof is not None:
            tracing.reduce_profile(prof, self.trace)
            del prof
        program = self.dep.snapshot()
        ring = (eng.state.flight.stamps.shape[0]
                if eng.state.flight is not None else 0)
        eng.close()
        del self.engine, self.dep, eng
        if self.device == "cuda":
            torch.cuda.empty_cache()

        # -- the comparison ------------------------------------------------------
        t = time.perf_counter()
        total_rounds = self.traffic.warm_rounds + rounds
        replay = judge.Replay(self.cfg, self.traffic, T0_MS)
        replay.run(total_rounds, self.verdicts, self.waits)
        parts = judge.compare(program, replay.model.snapshot(), ring)
        parts["verdicts"] = replay.verdicts_differ
        mismatches = sum(parts.values())
        reference_s = time.perf_counter() - t

        timed = [x for x in latencies if x == x]
        self.trace.verdict_s = timed
        counts = np.concatenate(self.verdicts[self.traffic.warm_rounds:]) \
            if rounds else np.zeros(0, np.int8)
        from portbench.reference import REASONS
        shares = {REASONS[c]: float(np.mean(counts == c)) for c in
                  range(len(REASONS)) if np.any(counts == c)}
        log({"window": {"rounds": rounds, "window_s": window_s,
                        "entries": rounds * self.width,
                        "shares_by_reason": shares,
                        "verdict_ms_p50_p90_p99_max": (
                            [float(np.percentile(timed, q,
                                                 method="inverted_cdf"))
                             * 1e3 for q in (50, 90, 99, 100)]
                            if timed else None),
                        "seals": len(ticks),
                        "seal_lines": int(sum(n for _, n in ticks)),
                        "reference_s": reference_s,
                        "mismatch_parts": parts}})
        if self.trace_on:
            log({"trace": {"slice_rounds": self.trace.slice_rounds,
                           "slice_s": self.trace.slice_s,
                           "busy_s": self.trace.busy_s,
                           "prefix_calls_profiled":
                               len(self.trace.prefix_shapes),
                           "prefix_sources": self.trace.prefix_sources}})
        result = {
            "correct": mismatches <= judge.LIMIT,
            "attempted": int(rounds * self.width),
            "failed": 0,
            "metrics": {},
            "device": device,
        }
        if self.trace_on:
            for m in spec.per_layer(self.bench, self.workload):
                value = spec.metric_reader(m["name"])(self.trace)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
            if self.trace.busy_s is not None:
                device["busy_s"] = self.trace.busy_s
                device["window_s"] = self.trace.slice_s
                result["breakdown"] = tracing.breakdown(self.trace)
        else:
            values = {
                "checks_per_s": rounds * self.width / window_s,
                "setup_s": setup_s,
            }
            for m in spec.end_to_end(self.bench, self.workload):
                v = values.get(m["name"].split(".", 1)[0])
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
        result["checks"] = {"mismatches": {"value": int(mismatches),
                                           "limit": judge.LIMIT}}
        return result

    def _profile_slice(self, r: int, spans) -> object:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        spans.profiling = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tracing.SLICE_RANGE):
                self.trace.slice_t0 = time.perf_counter()
                for i in range(PROFILED_ROUNDS):
                    self._round(r + i, profiling=True)
                torch.cuda.synchronize()
        self.trace.slice_rounds = PROFILED_ROUNDS
        spans.profiling = False
        return prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(CACHE_ROOT / sub))

    import torch

    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = CellRun(args.workload, args.seed, args.seconds,
                     bool(args.trace)).run()
    # Checked last, so that it covers the reference and every metric
    # reader loaded after the window.
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
