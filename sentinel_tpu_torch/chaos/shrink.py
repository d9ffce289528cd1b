"""Delta-debugging (ddmin) over fault schedules (port of
``sentinel_tpu/chaos/shrink.py``).

A violating episode's schedule is minimized to the smallest subset that
STILL violates, by re-running the (fully deterministic) episode with
candidate subsets: split into n chunks, try each chunk and each
complement, refine granularity when nothing smaller fails. Because the
predicate re-runs are bit-deterministic, the minimal schedule is a pure
function of the failing schedule.
"""

from __future__ import annotations

from typing import Callable, List, Tuple


def _chunks(items: List, n: int) -> List[List]:
    n = max(2, min(n, len(items)))
    size = len(items) / n
    out = []
    start = 0.0
    for _ in range(n):
        chunk = items[int(start):int(start + size)]
        if chunk:
            out.append(chunk)
        start += size
    return out


def ddmin(failing: Callable[[List], bool], items: List,
          max_runs: int = 96) -> Tuple[List, int]:
    """Minimize ``items`` to a small still-failing subset.

    ``failing(subset)`` re-runs the episode under ``subset`` and returns
    whether any invariant violated. ``items`` itself must be failing
    (the caller just observed it). Returns ``(minimal, runs_spent)``;
    ``max_runs`` bounds the shrink cost — on exhaustion the smallest
    failing subset found so far is returned (still a valid repro, just
    possibly not 1-minimal)."""
    items = list(items)
    runs = 0
    n = 2
    while len(items) >= 2 and runs < max_runs:
        chunks = _chunks(items, n)
        reduced = False
        candidates = [c for c in chunks if len(c) < len(items)]
        candidates += [
            [x for x in items if not any(x is y for y in c)]
            for c in chunks if 0 < len(c) < len(items)]
        for cand in candidates:
            if not cand:
                continue
            runs += 1
            if failing(cand):
                items = cand
                n = 2
                reduced = True
                break
            if runs >= max_runs:
                break
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), n * 2)
    return items, runs
