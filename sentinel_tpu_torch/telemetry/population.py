"""Namespace telescope (port of ``sentinel_tpu/telemetry/population.py``):
population sensing over the unbounded (resource, flowId) key space.

A slot table must be sized against the population it faces: how
concentrated the hot set is, how fast it churns, how heavy the cold tail
is, how many distinct keys exist. The device tensor only sees the
resident rows, so this module answers it on the host with three
mergeable summaries plus a churn series, riding the once-per-second
``_spill_flight`` fold (no device work):

``SpaceSaving``
    Exact-error-bounded top-k heavy hitters (Metwally et al.): every
    entry carries (count, err) with ``true <= count <= true + err``; any
    key whose true count exceeds ``total / k`` is present; entries that
    never went through an eviction have ``err == 0`` and exact counts.

``CountMinSketch``
    Cold-tail frequency queries: ``true <= estimate <= true + (e / width)
    * total`` with probability ``1 - e^-depth`` per query.

``HyperLogLog``
    Cardinality: one global register set, one per hash slice, one per
    churn window (the growth rate the cardinality alarm watches).
    Standard error ``1.04 / sqrt(2^p)``.

All three merge exactly (CMS cell-wise add, HLL register max,
Space-Saving union with summed floors). Every sketch consumes the same
64-bit ``sketch_hash`` (BLAKE2b, independent of ``PYTHONHASHSEED``), so
this package and the JAX package map a key to the same cells and produce
bit-identical pages for the same stream. Keys without a flowId derive a
slice from the sketch hash through :func:`slice_of` (a copy of
``cluster/sharding.py:slice_of``).

Clock: the tracker stamps with the engine timebase only; ``perf_counter``
is a duration source for the fold-overhead measurement alone.

A CUDA engine that dispatched a batch of device tensors (no host staging
dict) stages that batch's rows and counts by a non-blocking copy into
pinned memory behind a CUDA event (:meth:`PopulationTracker.
observe_rows_staged`); the fold waits on the event, never the dispatch
path. Observations made after a staged batch queue behind it, so the
fold sees every key in the order it was observed.
"""

from __future__ import annotations

import base64
import math
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

import heapq

_MASK64 = 0xFFFFFFFFFFFFFFFF

# 64-bit golden-ratio (Fibonacci) multiplier of ``slice_of``.
_SLICE_MIX = 0x9E3779B97F4A7C15

# Finalizer constant (splitmix64's first multiplier) used to derive the
# per-row CMS indices from the one sketch hash.
_SKETCH_MIX = 0xBF58476D1CE4E5B9

_PAGE_VERSION = 1

# Windows shipped per population page: enough for the fleet view to
# chart recent churn without blowing the 64 KB entity budget.
_PAGE_WINDOWS = 8


def slice_of(flow_id: int, n_slices: int) -> int:
    """flowId -> slice in ``[0, n_slices)`` by Fibonacci hashing (stable
    across processes and Python versions; no ``hash()``)."""
    x = (int(flow_id) * _SLICE_MIX) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return int(x % int(n_slices))


def sketch_hash(key) -> int:
    """The ONE 64-bit key hash every sketch consumes.

    BLAKE2b (C speed, cryptographic mixing) rather than Python's
    ``hash()``: stable across processes, Python versions, and
    ``PYTHONHASHSEED`` — merge exactness requires every leader to map a
    key to the same registers."""
    import hashlib

    if isinstance(key, str):
        key = key.encode("utf-8", "surrogatepass")
    return int.from_bytes(
        hashlib.blake2b(key, digest_size=8).digest(), "big")


def _row_hash(h: int, row: int) -> int:
    """Derive the CMS row-``row`` index hash from the base hash —
    splitmix64 finalizer over ``h`` xor a row-salted odd constant."""
    x = (h ^ ((row + 1) * _SKETCH_MIX)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class SpaceSaving:
    """Exact-error-bounded top-k heavy hitters.

    Invariants (the differential oracle pins them):
    - ``true(key) <= count(key) <= true(key) + err(key)`` for members;
    - ``err(key) <= floor`` where ``floor`` is the minimum count at the
      moment of the key's admission;
    - any absent key's true count is ``<= floor`` (current min count);
    - any key with ``true > total / k`` is present.

    Eviction picks the minimum (count, key) pair — the key tiebreak
    makes the summary a pure function of the update sequence, which the
    replay-determinism and merge-associativity tests rely on.
    """

    __slots__ = ("k", "counts", "errs", "_heap")

    def __init__(self, k: int):
        self.k = max(1, int(k))
        self.counts: Dict[str, int] = {}
        self.errs: Dict[str, int] = {}
        self._heap: List[Tuple[int, str]] = []  # lazy: stale entries ok

    def update(self, key: str, inc: int = 1) -> None:
        c = self.counts.get(key)
        if c is not None:
            self.counts[key] = c + inc
            heapq.heappush(self._heap, (c + inc, key))
        elif len(self.counts) < self.k:
            self.counts[key] = inc
            self.errs[key] = 0
            heapq.heappush(self._heap, (inc, key))
        else:
            c_min, k_min = self._valid_min()
            del self.counts[k_min]
            del self.errs[k_min]
            self.counts[key] = c_min + inc
            self.errs[key] = c_min
            heapq.heappush(self._heap, (c_min + inc, key))
        if len(self._heap) > 8 * self.k:
            self._heap = sorted(
                (c, k) for k, c in self.counts.items())

    def _valid_min(self) -> Tuple[int, str]:
        heap, counts = self._heap, self.counts
        while True:
            c, k = heap[0]
            if counts.get(k) == c:
                heapq.heappop(heap)
                return c, k
            heapq.heappop(heap)  # stale (count moved on or evicted)

    def floor(self) -> int:
        """Upper bound on any ABSENT key's true count."""
        if len(self.counts) < self.k:
            return 0
        c, _k = self._valid_min()
        heapq.heappush(self._heap, (c, _k))  # peek, not pop
        return c

    def top(self, n: Optional[int] = None) -> List[Tuple[str, int, int]]:
        """``[(key, count, err)]`` sorted by count desc, key asc."""
        rows = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if n is not None:
            rows = rows[:n]
        return [(k, c, self.errs[k]) for k, c in rows]


class CountMinSketch:
    """``depth x width`` counter grid; overestimate-only point queries;
    merge == cell-wise add (same geometry required)."""

    __slots__ = ("depth", "width", "rows")

    def __init__(self, depth: int, width: int,
                 rows: Optional[List[List[int]]] = None):
        self.depth = max(1, int(depth))
        self.width = max(8, int(width))
        self.rows: List[List[int]] = (
            rows if rows is not None
            else [[0] * self.width for _ in range(self.depth)])

    def update(self, h: int, inc: int = 1) -> None:
        for r in range(self.depth):
            self.rows[r][_row_hash(h, r) % self.width] += inc

    def query(self, h: int) -> int:
        return min(self.rows[r][_row_hash(h, r) % self.width]
                   for r in range(self.depth))

    def epsilon_total(self, total: int) -> float:
        """The additive error bound ``(e / width) * total`` that holds
        per query with probability ``1 - e^-depth``."""
        return (math.e / self.width) * total


class HyperLogLog:
    """2^p registers, register max merge, linear-counting small-range
    correction; 64-bit hashes (no large-range correction needed)."""

    __slots__ = ("p", "m", "registers")

    def __init__(self, p: int, registers: Optional[bytearray] = None):
        self.p = min(16, max(4, int(p)))
        self.m = 1 << self.p
        self.registers = (bytearray(self.m) if registers is None
                          else bytearray(registers))

    def add(self, h: int) -> None:
        idx = h >> (64 - self.p)
        w = (h << self.p) & _MASK64
        rank = (64 - self.p + 1) if w == 0 else (64 - w.bit_length() + 1)
        if rank > self.registers[idx]:
            self.registers[idx] = rank

    @staticmethod
    def _alpha(m: int) -> float:
        if m >= 128:
            return 0.7213 / (1.0 + 1.079 / m)
        return {16: 0.673, 32: 0.697, 64: 0.709}[m]

    def estimate(self) -> float:
        m = self.m
        acc = 0.0
        zeros = 0
        for r in self.registers:  # fixed order: bit-reproducible float
            acc += 2.0 ** -r
            if r == 0:
                zeros += 1
        raw = self._alpha(m) * m * m / acc
        if raw <= 2.5 * m and zeros:
            return m * math.log(m / zeros)
        return raw

    def merge(self, other: "HyperLogLog") -> None:
        if other.p != self.p:
            raise ValueError("HLL precision mismatch")
        mine, theirs = self.registers, other.registers
        for i in range(self.m):
            if theirs[i] > mine[i]:
                mine[i] = theirs[i]

    def b64(self) -> str:
        return base64.b64encode(bytes(self.registers)).decode("ascii")

    @classmethod
    def from_b64(cls, p: int, s: str) -> "HyperLogLog":
        return cls(p, bytearray(base64.b64decode(s.encode("ascii"))))


def _hll_b64_max(a: str, b: str) -> str:
    """Register-max merge directly on the b64 wire form."""
    ra = bytearray(base64.b64decode(a.encode("ascii")))
    rb = base64.b64decode(b.encode("ascii"))
    if len(ra) != len(rb):
        raise ValueError("HLL register length mismatch")
    for i, v in enumerate(rb):
        if v > ra[i]:
            ra[i] = v
    return base64.b64encode(bytes(ra)).decode("ascii")


def _hll_b64_estimate(p: int, s: str) -> float:
    return HyperLogLog.from_b64(p, s).estimate()


# -- page algebra (pure functions; FleetView and the report share them) --


def merge_pages(pages: List[Dict]) -> Dict:
    """Exact merge of population pages into one page of the SAME
    schema. Associative and commutative bit-for-bit (the canonical
    orderings below make the output independent of merge grouping):

    - Space-Saving: key union; a page missing a key contributes its
      ``floor`` to BOTH the key's count and its err (the SS absent-key
      bound); floors sum. No truncation happens here — the union holds
      at most ``len(pages) * k`` entries, and truncating inside the
      merge would break associativity.
    - CMS: cell-wise integer add (geometry must match).
    - HLL (global, per-slice, per-window): register max.
    - Windows: aligned by ``windowMs`` stamp; observed/entered/exited
      sum, distinct re-estimated from the merged window registers.

    Raises ``ValueError`` on geometry mismatch — a mixed-geometry fleet
    must be surfaced, not silently mis-merged.
    """
    pages = [p for p in pages if p]
    if not pages:
        return {}
    geom = pages[0]["geom"]
    for p in pages[1:]:
        if p["geom"] != geom:
            raise ValueError(
                f"population geometry mismatch: {p['geom']} != {geom}")
    floors = [int(p["ss"]["floor"]) for p in pages]
    keys = sorted({e[0] for p in pages for e in p["ss"]["entries"]})
    entries = []
    for key in keys:
        cnt = 0
        err = 0
        for p, fl in zip(pages, floors):
            hit = next((e for e in p["ss"]["entries"] if e[0] == key), None)
            if hit is not None:
                cnt += int(hit[1])
                err += int(hit[2])
            else:
                cnt += fl
                err += fl
        entries.append([key, cnt, err])
    entries.sort(key=lambda e: (-e[1], e[0]))

    cms = [row[:] for row in pages[0]["cms"]]
    for p in pages[1:]:
        for r, row in enumerate(p["cms"]):
            dst = cms[r]
            for i, v in enumerate(row):
                dst[i] += v

    hll = pages[0]["hll"]
    for p in pages[1:]:
        hll = _hll_b64_max(hll, p["hll"])

    slice_hll: Dict[str, str] = {}
    for p in pages:
        for s, b in p.get("sliceHll", {}).items():
            slice_hll[s] = (_hll_b64_max(slice_hll[s], b)
                            if s in slice_hll else b)

    windows: Dict[int, Dict] = {}
    for p in pages:
        for w in p.get("windows", []):
            stamp = int(w["windowMs"])
            dst = windows.get(stamp)
            if dst is None:
                windows[stamp] = dict(w)
            else:
                dst["observed"] += w["observed"]
                dst["entered"] += w["entered"]
                dst["exited"] += w["exited"]
                dst["hll"] = _hll_b64_max(dst["hll"], w["hll"])
    win_list = [windows[s] for s in sorted(windows)]
    for w in win_list:
        w["distinct"] = round(
            _hll_b64_estimate(int(geom["winP"]), w["hll"]), 3)

    return {
        "v": _PAGE_VERSION,
        "geom": dict(geom),
        "leaders": sum(int(p.get("leaders", 1)) for p in pages),
        "observed": sum(int(p["observed"]) for p in pages),
        "foldedKeys": sum(int(p["foldedKeys"]) for p in pages),
        "enteredTotal": sum(int(p["enteredTotal"]) for p in pages),
        "exitedTotal": sum(int(p["exitedTotal"]) for p in pages),
        "ss": {"floor": sum(floors), "entries": entries},
        "cms": cms,
        "hll": hll,
        "sliceHll": {s: slice_hll[s] for s in sorted(slice_hll)},
        "windows": win_list,
    }


def page_summary(page: Dict) -> Dict:
    """Human-readable digest of a page: cardinalities + hot mass."""
    if not page:
        return {}
    geom = page["geom"]
    distinct = _hll_b64_estimate(int(geom["hllP"]), page["hll"])
    entries = page["ss"]["entries"]
    total = int(page["observed"])
    k = int(geom["k"])
    hot = sum(e[1] for e in entries[:k])
    slices = {
        s: round(_hll_b64_estimate(int(geom["sliceP"]), b), 2)
        for s, b in page.get("sliceHll", {}).items()}
    return {
        "observed": total,
        "distinct": round(distinct, 2),
        "distinctStdErr": round(1.04 / math.sqrt(1 << int(geom["hllP"])), 4),
        "hotMass": round(hot / total, 6) if total else 0.0,
        "topkEntries": len(entries),
        "ssFloor": int(page["ss"]["floor"]),
        "leaders": int(page.get("leaders", 1)),
        "sliceDistinct": slices,
        "windows": len(page.get("windows", [])),
    }


def _fit_power_law(entries: List) -> Tuple[float, float]:
    """Least-squares log-log fit ``count ~ C * rank^-s`` over the top-k
    ranks — the tail extrapolator for budgets beyond k. Returns (C, s);
    degenerate inputs fall back to a flat tail (s=0)."""
    xs: List[float] = []
    ys: List[float] = []
    for rank, e in enumerate(entries, start=1):
        c = int(e[1])
        if c > 0:
            xs.append(math.log(rank))
            ys.append(math.log(c))
    n = len(xs)
    if n < 3:
        return (float(entries[0][1]) if entries else 0.0), 0.0
    mx = sum(xs) / n
    my = sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den <= 0.0:
        return math.exp(my), 0.0
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
    return math.exp(my - slope * mx), max(0.0, -slope)


def report_from_page(page: Dict, slot_budget: int,
                     window_seconds: int = 1) -> Dict:
    """Admission-readiness projection for a hypothetical device slot
    budget ``N``: the sizing input of the slot table (``core/slots.py``).

    - ``hitRate``: projected fraction of traffic the top-``N`` keys
      absorb if each held a slot. For ``N <= k`` this is the Space-
      Saving top-N mass over the observed total — EXACT when those
      entries carry ``err == 0`` (the usual Zipf case), and always
      bracketed by ``[hitRateGuaranteed, hitRateUpper]`` from the
      per-entry error bounds.
    - ``N > k``: the tail beyond the summary is extrapolated from a
      power-law fit over the top-k ranks, capped by the HLL distinct
      count and the unaccounted mass — flagged ``extrapolated``.
    - ``coldMass``: ``1 - hitRate`` — the traffic share that would miss
      the slot table and fall back to the sketched cold path.
    - ``evictionsPerWindow``: projected top-``N`` ring turnover per
      churn window, scaled from the measured top-k entry rate.
    """
    n = max(0, int(slot_budget))
    entries = page["ss"]["entries"] if page else []
    total = int(page.get("observed", 0)) if page else 0
    geom = page.get("geom", {}) if page else {}
    if not total or not n:
        return {"slotBudget": n, "observed": total, "hitRate": 0.0,
                "hitRateGuaranteed": 0.0, "hitRateUpper": 0.0,
                "coldMass": 1.0, "distinct": 0.0, "extrapolated": False,
                "slotsCovered": 0, "evictionsPerWindow": 0.0,
                "stealsPerSecond": 0.0}
    distinct = _hll_b64_estimate(int(geom["hllP"]), page["hll"])
    head = entries[:n]
    hot_upper = sum(e[1] for e in head)
    hot_guaranteed = sum(max(0, e[1] - e[2]) for e in head)
    slots_covered = len(head)
    extrapolated = False
    if n > len(entries):
        c0, s = _fit_power_law(entries)
        lo = len(entries) + 1
        hi = min(n, int(max(distinct, len(entries))))
        tail = sum(c0 * r ** -s for r in range(lo, hi + 1))
        # The extrapolated tail can never claim more than the mass the
        # summary has not already accounted for.
        tail = min(tail, max(0.0, total - hot_upper))
        hot_upper = hot_upper + tail
        hot_guaranteed = hot_guaranteed + 0.0  # tail carries no guarantee
        slots_covered = hi
        extrapolated = True
    hit_upper = min(1.0, hot_upper / total)
    hit_guaranteed = min(1.0, hot_guaranteed / total)
    # Point estimate: the upper mass is the right projection when the
    # head is exact (err==0); with fleet-summed errors it stays the
    # consistent overestimate the SS semantics promise.
    hit = hit_upper
    windows = page.get("windows", [])
    k = int(geom.get("k", len(entries) or 1))
    if windows:
        mean_entered = sum(w["entered"] for w in windows) / len(windows)
    else:
        mean_entered = 0.0
    evictions = mean_entered * min(1.0, n / max(1, k))
    win_s = max(1, int(window_seconds))
    return {
        "slotBudget": n,
        "observed": total,
        "distinct": round(distinct, 2),
        "hitRate": round(hit, 6),
        "hitRateGuaranteed": round(hit_guaranteed, 6),
        "hitRateUpper": round(hit_upper, 6),
        "coldMass": round(1.0 - hit, 6),
        "coldMassUpper": round(1.0 - hit_guaranteed, 6),
        "evictionsPerWindow": round(evictions, 4),
        "stealsPerSecond": round(evictions / win_s, 4),
        "slotsCovered": slots_covered,
        "extrapolated": extrapolated,
    }


def projection_curve(page: Dict, budgets: Iterable[int],
                     window_seconds: int = 1) -> List[Dict]:
    """``report_from_page`` across a budget ladder (the dashboard's
    slot-budget projection curve)."""
    return [report_from_page(page, b, window_seconds)
            for b in sorted({max(0, int(b)) for b in budgets})]


def _row_pairs(rows, counts, metas) -> List[Tuple[str, int]]:
    """One batch's (row, tokens) lanes -> resource-keyed (key, tokens)
    pairs in row order; padded / pass-through rows (< 0) are skipped.
    ``numpy`` folds the batch to per-row sums first."""
    import numpy as np

    rows = np.asarray(rows)
    counts = np.asarray(counts)
    mask = rows >= 0
    if not mask.any():
        return []
    per_row = np.bincount(rows[mask], weights=np.maximum(counts[mask], 1))
    hot = np.nonzero(per_row)[0]
    n_meta = len(metas)
    return [(metas[row].resource, int(per_row[row]))
            for row in hot.tolist() if row < n_meta]


class PopulationTracker:
    """The per-engine (and, through ``engine.population``, per-leader)
    telescope. Hot paths stage raw (key, inc) pairs into a plain dict
    under a short lock; the once-per-second ``roll`` fold hashes and
    feeds the sketches, seals churn windows, and scores cardinality
    growth against an EWMA baseline — a blowup pages through
    ``slo.external_transition`` exactly like a burn-rate breach."""

    ALERT_KEY = "population:cardinality"

    def __init__(self, engine=None, now_ms: Optional[Callable[[], int]] = None,
                 transition: Optional[Callable] = None):
        from sentinel_tpu_torch.core.config import config as _cfg
        from sentinel_tpu_torch.slo.baseline import EwmaBaseline

        self._engine = engine
        if engine is not None:
            self._now_ms: Callable[[], int] = engine.now_ms
        elif now_ms is not None:
            self._now_ms = now_ms
        else:
            self._now_ms = lambda: int(time.perf_counter() * 1000)
        self._transition = transition
        self.enabled = _cfg.population_enabled()
        self.k = _cfg.population_topk()
        self.cms_depth = _cfg.population_cms_depth()
        self.cms_width = _cfg.population_cms_width()
        self.hll_p = _cfg.population_hll_precision()
        self.slice_p = _cfg.population_slice_precision()
        self.window_ms = _cfg.population_window_seconds() * 1000
        self.n_slices = _cfg.cluster_shard_slices()
        self._lock = threading.Lock()
        self._pending: Dict[str, int] = {}
        # Observations queued behind a staged (device-copied) batch, in
        # order: ("pairs", [(key, inc)]) or ("rows", rows, counts, event,
        # metas). Folded into _pending at the roll.
        self._staged: List[tuple] = []
        self._slice_hint: Dict[str, int] = {}
        self._hash_cache: Dict[str, int] = {}
        self._ss = SpaceSaving(self.k)
        self._cms = CountMinSketch(self.cms_depth, self.cms_width)
        self._hll = HyperLogLog(self.hll_p)
        self._slice_hll: Dict[int, HyperLogLog] = {}
        self._win_hll = HyperLogLog(self.slice_p)
        self._win_start: Optional[int] = None
        self._win_total = 0
        self._prev_topk: frozenset = frozenset()
        self._windows: Deque[Dict] = deque(
            maxlen=_cfg.population_churn_history())
        self._baseline = EwmaBaseline(
            alpha=_cfg.population_baseline_alpha(),
            zscore=_cfg.population_baseline_zscore(),
            warmup=10)
        self.alarm = False
        self.observed_total = 0
        self.folded_keys = 0
        self.fold_count = 0
        self.fold_ms_total = 0.0
        self.entered_total = 0
        self.exited_total = 0
        self.windows_sealed = 0

    # -- write side (hot paths: stage only, never hash) -----------------

    def observe(self, key: str, inc: int = 1,
                slice_hint: Optional[int] = None) -> None:
        if not self.enabled or inc <= 0:
            return
        with self._lock:
            if self._staged:
                self._staged.append(("pairs", [(key, int(inc))]))
            else:
                self._pending[key] = self._pending.get(key, 0) + int(inc)
            if slice_hint is not None and key not in self._slice_hint:
                self._slice_hint[key] = int(slice_hint)

    def observe_pairs(self, pairs: Iterable[Tuple[str, int]]) -> None:
        """Batch form of :meth:`observe` — one lock acquisition."""
        if not self.enabled:
            return
        with self._lock:
            if self._staged:
                self._staged.append(("pairs", list(pairs)))
                return
            pend = self._pending
            for key, inc in pairs:
                if inc > 0:
                    pend[key] = pend.get(key, 0) + int(inc)

    def observe_rows(self, rows, counts, metas) -> None:
        """One admission batch's (row, tokens) pairs, resource-keyed.

        Called next to the existing ``traces.submit`` on the entry
        paths — padded / pass-through rows (< 0) carry no identity and
        are skipped. ``numpy`` folds the batch to per-row sums first so
        the lock holds for O(distinct rows), not O(batch)."""
        if not self.enabled:
            return
        pairs = _row_pairs(rows, counts, metas)
        if pairs:
            self.observe_pairs(pairs)

    def observe_rows_staged(self, rows, counts, event, metas) -> None:
        """:meth:`observe_rows` for a batch whose columns are still on
        their way to the host: ``rows`` / ``counts`` are pinned host
        tensors filled by non-blocking copies recorded before ``event``.
        Nothing waits here; the fold waits on the event."""
        if not self.enabled:
            return
        with self._lock:
            self._staged.append(("rows", rows, counts, event, metas))
            # Fold whatever has already landed, so an engine whose fold
            # never runs does not pile up pinned copies.
            self._drain_staged_locked(wait=False)

    def _drain_staged_locked(self, wait: bool = True) -> None:
        """Fold staged observations into ``_pending`` in order. With
        ``wait=False`` stop at the first batch whose copies have not
        landed (``_pending`` only ever holds what precedes the queue)."""
        pend = self._pending
        done = 0
        for item in self._staged:
            if item[0] == "rows":
                _, rows, counts, event, metas = item
                if event is not None:
                    if not wait and not event.query():
                        break
                    event.synchronize()
                pairs = _row_pairs(rows.numpy(), counts.numpy(), metas)
            else:
                pairs = item[1]
            for key, inc in pairs:
                if inc > 0:
                    pend[key] = pend.get(key, 0) + int(inc)
            done += 1
        del self._staged[:done]

    def observe_flows(self, items: Iterable[Tuple[Optional[str], int, int]]
                      ) -> None:
        """Leader-side traffic: ``(namespace, flowId, count)`` triples
        from the token service's dispatch loop. Keys are
        ``<ns>#<flowId>`` and slice attribution uses the REAL routing
        ``slice_of`` — the fleet view's per-slice cardinality matches
        what the rebalancer actually moves."""
        if not self.enabled:
            return
        n = self.n_slices
        with self._lock:
            pend = self._pending
            hints = self._slice_hint
            for ns, flow_id, count in items:
                if count <= 0:
                    continue
                key = f"{ns or '?'}#{int(flow_id)}"
                pend[key] = pend.get(key, 0) + int(count)
                if key not in hints:
                    hints[key] = slice_of(int(flow_id), n)

    # -- fold (rides _spill_flight) -------------------------------------

    def _hash64(self, key: str) -> int:
        cache = self._hash_cache
        h = cache.get(key)
        if h is None:
            h = sketch_hash(key)
            if len(cache) >= 65536:
                cache.clear()
            cache[key] = h
        return h

    def roll(self, now_ms: int) -> None:
        """Fold staged pairs into the sketches and seal any completed
        churn window — called once per spill, strictly host-side."""
        if not self.enabled:
            return
        t0 = time.perf_counter()
        fired: Optional[Tuple[bool, int, Dict]] = None
        with self._lock:
            now = int(now_ms)
            cur_win = now - now % self.window_ms
            if self._win_start is None:
                self._win_start = cur_win
            elif cur_win > self._win_start:
                fired = self._seal_window_locked(self._win_start)
                self._win_start = cur_win
            if self._staged:
                self._drain_staged_locked()
            if self._pending:
                pending = self._pending
                hints = self._slice_hint
                self._pending = {}
                self._slice_hint = {}
                ss, cms = self._ss, self._cms
                hll, win_hll = self._hll, self._win_hll
                slices = self._slice_hll
                n = self.n_slices
                for key in pending:  # insertion order: deterministic
                    c = pending[key]
                    h = self._hash64(key)
                    ss.update(key, c)
                    cms.update(h, c)
                    hll.add(h)
                    win_hll.add(h)
                    s = hints.get(key)
                    if s is None:
                        s = slice_of(h & 0x7FFFFFFFFFFFFFFF, n)
                    sh = slices.get(s)
                    if sh is None:
                        sh = slices[s] = HyperLogLog(self.slice_p)
                    sh.add(h)
                    self.observed_total += c
                    self._win_total += c
                self.folded_keys += len(pending)
            self.fold_count += 1
            self.fold_ms_total += (time.perf_counter() - t0) * 1000.0
        if fired is not None:
            firing, stamp, fields = fired
            self._fire(firing, stamp, fields)

    def _seal_window_locked(self, win_start: int
                            ) -> Optional[Tuple[bool, int, Dict]]:
        distinct = round(self._win_hll.estimate(), 3)
        cur_top = [e[0] for e in self._ss.top(self.k)]
        cur_set = frozenset(cur_top)
        entered = len(cur_set - self._prev_topk)
        exited = len(self._prev_topk - cur_set)
        breached = self._baseline.update(float(distinct))
        z = round(self._baseline.last_z, 4)
        rec = {
            "windowMs": win_start,
            "distinct": distinct,
            "observed": self._win_total,
            "entered": entered,
            "exited": exited,
            "z": z,
            "alarm": breached,
            "topk": cur_top,
            "hll": self._win_hll.b64(),
        }
        self._windows.append(rec)
        self._prev_topk = cur_set
        self.entered_total += entered
        self.exited_total += exited
        self.windows_sealed += 1
        self._win_hll = HyperLogLog(self.slice_p)
        self._win_total = 0
        was = self.alarm
        self.alarm = breached
        end = win_start + self.window_ms
        if breached:
            return (True, end, {
                "key": self.ALERT_KEY, "kind": "population",
                "severity": "warn", "resource": "flowid-cardinality",
                "distinct": distinct, "z": z,
                "mean": round(self._baseline.mean, 3)})
        if was:
            return (False, end, {})
        return None

    def _fire(self, firing: bool, now_ms: int, fields: Dict) -> None:
        transition = self._transition
        if transition is None and self._engine is not None:
            slo = getattr(self._engine, "slo", None)
            transition = (slo.external_transition
                          if slo is not None else None)
        if transition is not None:
            transition(self.ALERT_KEY, firing, now_ms, fields)
        if firing and self._engine is not None:
            journal = getattr(self._engine, "journal", None)
            if journal is not None:
                journal.record("populationAlarm", **{
                    k: v for k, v in fields.items() if k != "key"})

    def reset_timebase(self) -> None:
        """Drop time-cursor state on a clock swap (series survive: they
        carry their own stamps; only the open window is discarded)."""
        with self._lock:
            self._win_start = None
            self._win_total = 0
            self._win_hll = HyperLogLog(self.slice_p)

    # -- read side -------------------------------------------------------

    def page(self, max_bytes: Optional[int] = None) -> Dict:
        """The compact wire page FleetView merges. ``max_bytes`` shrinks
        progressively (slice HLLs first, then windows, then the top-k
        tail) and records what was dropped — a truncated page is still
        exactly mergeable, just coarser."""
        import json

        with self._lock:
            page = {
                "v": _PAGE_VERSION,
                "geom": {"k": self.k, "cmsDepth": self.cms_depth,
                         "cmsWidth": self.cms_width, "hllP": self.hll_p,
                         "sliceP": self.slice_p, "winP": self.slice_p,
                         "slices": self.n_slices,
                         "windowMs": self.window_ms},
                "leaders": 1,
                "observed": self.observed_total,
                "foldedKeys": self.folded_keys,
                "enteredTotal": self.entered_total,
                "exitedTotal": self.exited_total,
                "ss": {"floor": self._ss.floor(),
                       "entries": [[k, c, e] for k, c, e in self._ss.top()]},
                "cms": [row[:] for row in self._cms.rows],
                "hll": self._hll.b64(),
                "sliceHll": {str(s): self._slice_hll[s].b64()
                             for s in sorted(self._slice_hll)},
                "windows": [
                    {"windowMs": w["windowMs"], "distinct": w["distinct"],
                     "observed": w["observed"], "entered": w["entered"],
                     "exited": w["exited"], "hll": w["hll"]}
                    for w in list(self._windows)[-_PAGE_WINDOWS:]],
            }
        if max_bytes:
            truncated = []
            for drop in ("sliceHll", "windows"):
                if len(json.dumps(page, separators=(",", ":"))) <= max_bytes:
                    break
                page[drop] = {} if drop == "sliceHll" else []
                truncated.append(drop)
            while (len(json.dumps(page, separators=(",", ":"))) > max_bytes
                   and len(page["ss"]["entries"]) > 8):
                page["ss"]["entries"] = (
                    page["ss"]["entries"][:len(page["ss"]["entries"]) // 2])
                if "topk" not in truncated:
                    truncated.append("topk")
            if truncated:
                page["truncated"] = truncated
        return page

    def report(self, slot_budget: int) -> Dict:
        """Admission-readiness projection (see :func:`report_from_page`)
        refined with the tracker's OWN per-window top-N turnover — the
        local report measures ring churn exactly for budgets <= k
        instead of scaling the k-level rate."""
        page = self.page()
        rep = report_from_page(page, slot_budget,
                               window_seconds=self.window_ms // 1000)
        n = max(0, int(slot_budget))
        with self._lock:
            wins = [w for w in self._windows if "topk" in w]
            if n and len(wins) >= 2:
                turns = []
                prev = None
                for w in wins:
                    cur = frozenset(w["topk"][:n])
                    if prev is not None:
                        turns.append(len(cur - prev))
                    prev = cur
                exact = sum(turns) / len(turns)
                rep["evictionsPerWindow"] = round(exact, 4)
                rep["stealsPerSecond"] = round(
                    exact / max(1, self.window_ms // 1000), 4)
            rep["alarm"] = self.alarm
            rep["baseline"] = self._baseline.snapshot()
        return rep

    def snapshot(self, topk: Optional[int] = None,
                 windows: int = 60) -> Dict:
        """The ``population op=status`` read: totals, top-k with error
        bars, churn series, baseline, fold-overhead self-measurement."""
        with self._lock:
            top = self._ss.top(topk if topk is not None else self.k)
            series = [{k: w[k] for k in ("windowMs", "distinct", "observed",
                                         "entered", "exited", "z", "alarm")}
                      for w in list(self._windows)[-max(1, int(windows)):]]
            return {
                "enabled": self.enabled,
                "geom": {"k": self.k, "cmsDepth": self.cms_depth,
                         "cmsWidth": self.cms_width, "hllP": self.hll_p,
                         "sliceP": self.slice_p, "slices": self.n_slices,
                         "windowMs": self.window_ms},
                "observed": self.observed_total,
                "foldedKeys": self.folded_keys,
                "distinct": round(self._hll.estimate(), 2),
                "distinctStdErr": round(1.04 / math.sqrt(1 << self.hll_p), 4),
                "ssFloor": self._ss.floor(),
                "topk": [{"key": k, "count": c, "err": e}
                         for k, c, e in top],
                "sliceDistinct": {
                    str(s): round(self._slice_hll[s].estimate(), 2)
                    for s in sorted(self._slice_hll)},
                "churn": series,
                "enteredTotal": self.entered_total,
                "exitedTotal": self.exited_total,
                "windowsSealed": self.windows_sealed,
                "alarm": self.alarm,
                "baseline": self._baseline.snapshot(),
                "foldCount": self.fold_count,
                "foldMsTotal": round(self.fold_ms_total, 3),
                "pendingKeys": len(self._pending),
            }

    def series(self, windows: Optional[int] = None) -> List[Dict]:
        """The sealed churn-window series (replay determinism surface):
        stamps, cardinalities, turnover — no registers, no floats beyond
        the rounded estimates."""
        with self._lock:
            recs = list(self._windows)
            if windows is not None:
                recs = recs[-max(1, int(windows)):]
            return [{k: w[k] for k in ("windowMs", "distinct", "observed",
                                       "entered", "exited", "z", "alarm")}
                    for w in recs]
