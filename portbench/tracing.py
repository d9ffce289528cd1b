"""Spans and counters the benchmark takes around the program, and the
reduction of a ``torch.profiler`` trace to device busy time, device
operations and idle gaps.

Nothing here is inside the program: the host-sync counter is the
program's own (``utils/device.py:SYNCS``), read per thread so that the
metric timer's syncs are not counted against the admission loop; the
prefix spans wrap the names the rule slots call, where the slots bind
them.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

# Host ranges the harness opens, by the name the breakdown gives them.
HOST_RANGES = ("batch", "check_batch", "harvest", "complete_batch")
PREFIX_RANGE = "portbench.prefix"
SLICE_RANGE = "portbench.slice"


class Trace:
    """What a traced run gathers; the per-layer readers take it whole."""

    def __init__(self):
        self.rounds = 0            # rounds (one entry step each) in the window
        self.host_syncs = 0        # the admission thread's, in the window
        self.seal_s: List[float] = []  # each metric-timer tick in the window
        self.verdict_s: List[float] = []  # each unprofiled round's wait
        self.prefix_calls = 0      # wrapped prefix calls in the window
        self.prefix_shapes: List[Tuple[int, int, int]] = []  # (K, N, M)
        self.prefix_device_s: Optional[float] = None
        self.peaks: Dict = {}
        # The profiled slice of the window.
        self.slice_rounds = 0
        self.slice_s = 0.0
        self.busy_s: Optional[float] = None
        self.device_ops = 0
        self.device_by_name: Dict[str, float] = {}
        self.idle_by_host: Dict[str, float] = {}
        # Host wall times (perf_counter) of the metric timer's ticks, and
        # of the profiled slice's start, to place the ticks in the trace.
        self.seal_spans: List[Tuple[float, float]] = []
        self.slice_t0: Optional[float] = None
        self.prefix_sources: Dict[str, float] = {}


class PerThreadCount:
    """Makes the program's ``SYNCS`` counter count per thread while
    installed: ``SYNCS.count`` reads and writes the calling thread's
    count, so ``SYNCS.count += 1`` from any thread lands on its own."""

    def __init__(self, counter):
        self.counter = counter
        self.cls = type(counter)
        local = threading.local()

        class _PerThread(self.cls):
            __slots__ = ()

            @property
            def count(self):
                return getattr(local, "n", 0)

            @count.setter
            def count(self, v):
                local.n = v

        self._per_thread = _PerThread

    def __enter__(self):
        self.counter.__class__ = self._per_thread
        return self

    def __exit__(self, *exc):
        self.counter.__class__ = self.cls
        return False


class PrefixSpans:
    """Counts the rule slots' segmented-prefix calls and records their
    shapes; while ``profiling`` each call runs inside a
    ``record_function`` range, so the device time of its kernels can be
    read from the trace."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.counting = False
        self.profiling = False
        self._patched = []

    def install(self):
        from sentinel_tpu_torch.models import flow, param_flow

        for mod, name in ((flow, "segmented_prefix_dense_multi"),
                          (flow, "segmented_prefix_dense"),
                          (param_flow, "segmented_prefix_dense")):
            orig = getattr(mod, name)
            setattr(mod, name, self._wrap(orig, name.endswith("multi")))
            self._patched.append((mod, name, orig))
        return self

    def uninstall(self):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)
        self._patched = []

    def _wrap(self, fn, multi: bool):
        import torch

        def shape(args):
            pairs = args[0] if multi else [(args[0], args[1])]
            n = int(pairs[0][0].shape[0])
            v = pairs[0][1]
            return len(pairs), n, (1 if v.dim() == 1 else int(v.shape[1]))

        def wrapped(*args, **kw):
            if not self.counting:
                return fn(*args, **kw)
            self.trace.prefix_calls += 1
            if not self.profiling:
                return fn(*args, **kw)
            self.trace.prefix_shapes.append(shape(args))
            with torch.profiler.record_function(PREFIX_RANGE):
                return fn(*args, **kw)

        return wrapped


@contextmanager
def host_range(name: str, on: bool):
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(f"portbench.{name}"):
        yield


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _overlap(busy, lo, hi) -> float:
    """Length of the merged intervals ``busy`` inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in busy)


def reduce_profile(prof, trace: Trace) -> None:
    """Fill ``trace``'s slice fields from a finished profile that holds one
    ``portbench.slice`` range around the profiled rounds."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not e.name.startswith("portbench.")]
    slices = [e for e in cpu if e.name == SLICE_RANGE]
    if not slices:
        return
    lo = slices[0].time_range.start
    hi = slices[0].time_range.end
    trace.slice_s = (hi - lo) * 1e-6
    inside = [e for e in dev if e.time_range.end > lo and
              e.time_range.start < hi]
    trace.device_ops = len(inside)
    by_name: Dict[str, float] = {}
    for e in inside:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) * 1e-6
    trace.device_by_name = by_name
    busy = _union((max(e.time_range.start, lo), min(e.time_range.end, hi))
                  for e in inside)
    trace.busy_s = sum(b - a for a, b in busy) * 1e-6
    # Idle gaps, each named by the host range its midpoint falls in (the
    # metric timer's seal first, as it holds the engine lock). The seal
    # runs on the timer's thread, which the profiler does not follow: its
    # spans come from the harness's own clock, placed by the slice's start.
    steps = [(e.time_range.start, e.time_range.end, e.name[len("portbench."):])
             for e in cpu if e.name.startswith("portbench.")
             and e.name[len("portbench."):] in HOST_RANGES]
    seals = [(lo + (a - trace.slice_t0) * 1e6, lo + (b - trace.slice_t0) * 1e6,
              "seal") for a, b in trace.seal_spans] \
        if trace.slice_t0 is not None else []
    idle: Dict[str, float] = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((r[2] for r in seals if r[0] <= mid < r[1]), None) or \
            next((r[2] for r in steps if r[0] <= mid < r[1]), "between_steps")
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    trace.idle_by_host = idle
    # Device time of the prefix calls: the device's busy time inside the
    # device-side spans of their ranges (``record_function`` marks on the
    # device timeline the first to the last operation a range launched).
    marks = [e for e in events if e.device_type != DeviceType.CPU
             and e.name == PREFIX_RANGE]
    via_marks = sum(_overlap(busy, e.time_range.start, e.time_range.end)
                    for e in marks) * 1e-6
    trace.prefix_sources = {"device_marks_s": via_marks, "marks": len(marks)}
    trace.prefix_device_s = via_marks if marks else None


def short_name(kernel: str) -> str:
    """A device operation's name without the template boilerplate."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::TensorIteratorBase&", "std::array<char*, 1ul>",
                 "unsigned int", "c10::"):
        kernel = kernel.replace(junk, "")
    return kernel[:120]


def breakdown(trace: Trace) -> Dict:
    merged: Dict[str, float] = {}
    for n, s in trace.device_by_name.items():
        merged[short_name(n)] = merged.get(short_name(n), 0.0) + s
    top = sorted(merged.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}

