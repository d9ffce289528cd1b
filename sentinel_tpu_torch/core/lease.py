"""Token-lease fast path: host-side admission for simple hot resources
(port of ``sentinel_tpu/core/lease.py``).

A synchronous device dispatch costs far more than the admission
arithmetic of the dominant traffic classes (on the H100 the fused step
is host-bound at tens of milliseconds, PERF.md), so the host runs that
arithmetic directly against mirrored state ("the quota is leased from
the device view") and streams the decided outcomes to the device as
pre-decided statistic commits (``EntryBatch.pre_passed`` /
``pre_blocked``) from a background committer. Reference analog:
``FlowRuleChecker.passLocalCheck`` + ``DefaultController.canPass``; the
device stays the source of truth for statistics and every other family.

Eligibility is conservative; anything else takes the device path:

  * every flow rule on the resource: QPS grade, DIRECT strategy,
    ``limit_app`` default, local (no cluster mode), and behavior either
    DEFAULT or WARM_UP (the ``WarmUpController`` bucket is mirrored
    host-side; rate-limiter pacing keeps the device path, its waits need
    the step's leaky-bucket prefix machinery);
  * param-flow rules: at most ONE rule on the resource, QPS grade,
    DEFAULT behavior, local, mirrored as exact per-value windowed token
    buckets (tighter than the device's cold-tier CMS, which only
    over-estimates);
  * no degrade / authority rules on the resource;
  * no system rules active, no SPI host slots or device checkers.

Exactness: the mirror ring reproduces the device's DEFAULT math
(``window_sum x 1000/interval + count <= threshold``) under one lock, so
process-local admission is serially exact. Widened leases (warm-up /
param) run the same float32 arithmetic as the JAX package's mirrors,
checked family by family in the device chain's order (param-flow before
flow). Device-resident stats converge within one committer flush
(default 2 ms).

The plain ring of :class:`LocalLease` runs in C when the native extension
builds (``csrc/lease_ext.c`` via ``native.py``), else in Python; the two
make identical decisions (``tests/test_torch_lease.py``).
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    MAX_PARAMS,
    ladder_width,
    make_entry_batch_np,
    make_exit_batch_np,
)
from sentinel_tpu_torch.native import load_lease_ext

_FLOW_REASON = int(C.BlockReason.FLOW)
_PARAM_REASON = int(C.BlockReason.PARAM_FLOW)


class LocalLease:
    """Host mirror of one resource's instant window + thresholds.

    When the native lease extension builds (``csrc/lease_ext.c``) the
    ring lives in C with no separate lock (the GIL serializes the
    extension call). Identical admission math either way, bucket for
    bucket; the Python ring is the fallback and the oracle the tests
    compare the C ring against. The engine builds the extension at
    construction (``native.load_lease_ext``), so a lease built under the
    config lock on a rule push never waits on the C compiler."""

    __slots__ = ("thresholds", "interval_ms", "bucket_ms", "buckets",
                 "_counts", "_starts", "_lock", "_ring")

    def __init__(self, thresholds: List[float], interval_ms: int,
                 buckets: int, use_native: bool = True):
        self.thresholds = thresholds  # every rule must admit (AND)
        self.interval_ms = interval_ms
        self.buckets = buckets
        self.bucket_ms = interval_ms // buckets
        self._counts = [0] * buckets
        self._starts = [-1] * buckets
        self._lock = threading.Lock()
        # use_native=False: WideLease runs the Python ring (the C ring
        # only knows the plain-threshold compare) — don't build a
        # C-side ring just to throw it away on every rule push.
        ext = load_lease_ext() if use_native else None
        self._ring = (ext.LeaseRing(thresholds, interval_ms, buckets)
                      if ext is not None else None)

    @property
    def native(self) -> bool:
        """True when this lease's ring runs in the C extension."""
        return self._ring is not None

    def _rotate(self, now_ms: int) -> int:
        """Lazy bucket reset (caller holds the lock); returns current idx.

        Hot path: when the current bucket's start is already right, the
        whole ring is right — the full fix-up loop below establishes
        that invariant whenever it runs, and within one bucket window no
        other bucket can newly expire. High-rate admission then pays one
        compare instead of an O(buckets) loop per entry."""
        idx = (now_ms // self.bucket_ms) % self.buckets
        cur_start = now_ms - now_ms % self.bucket_ms
        if self._starts[idx] == cur_start:
            return idx
        for b in range(self.buckets):
            expected = cur_start - ((idx - b) % self.buckets) * self.bucket_ms
            if self._starts[b] != expected:
                self._starts[b] = expected
                self._counts[b] = 0
        return idx

    def _used(self) -> float:
        """Per-second QPS of the mirrored window (caller holds the lock) —
        the ONE site for the normalization admission and ops both use."""
        return sum(self._counts) * (1000.0 / self.interval_ms)

    def try_acquire(self, count: int, now_ms: int) -> bool:
        """Device-exact DEFAULT admission against the mirrored ring."""
        ring = self._ring
        if ring is not None:
            return ring.try_acquire(count, now_ms)
        with self._lock:
            idx = self._rotate(now_ms)
            used = self._used()
            for thr in self.thresholds:
                if used + count > thr:
                    return False
            self._counts[idx] += count
            return True

    def admit(self, count: int, now_ms: int, params=()) -> int:
        """The engine fast path's entry point: BlockReason int (0 = pass).
        Plain leases only ever block on FLOW; widened leases override
        with the full family chain."""
        ring = self._ring
        if ring is not None:
            return 0 if ring.try_acquire(count, now_ms) else _FLOW_REASON
        return 0 if self.try_acquire(count, now_ms) else _FLOW_REASON

    def add(self, count: int, now_ms: int, params=()) -> None:
        """Record a DEVICE-decided pass so the mirror tracks the window in
        every mode (pipeline / prioritized / occupy-granted entries).
        ``params`` is consumed by widened leases (param-bucket mirror);
        plain leases ignore it."""
        ring = self._ring
        if ring is not None:
            ring.add(count, now_ms)
            return
        with self._lock:
            idx = self._rotate(now_ms)
            self._counts[idx] += count

    def seed(self, starts, counts) -> None:
        """Adopt the device window's buckets wholesale (checkpoint warm
        restart: the restored stats are the truth the mirror must match).

        Geometry-mismatched seeds are dropped: a ring of the wrong length
        would index out of range on the next acquire, killing admission on
        the resource. The mirror then starts empty — over-admitting by at
        most one window, never crashing (the engine orders reset-then-seed
        so this is pure defense in depth)."""
        starts = [int(s) for s in starts]
        counts = [int(c) for c in counts]
        if len(starts) != self.buckets or len(counts) != self.buckets:
            return
        ring = self._ring
        if ring is not None:
            ring.seed(starts, counts)
            return
        with self._lock:
            self._starts = starts
            self._counts = counts

    def snapshot(self):
        """(starts, counts) under the lock — for mirror carry-over."""
        ring = self._ring
        if ring is not None:
            return ring.snapshot()
        with self._lock:
            return list(self._starts), list(self._counts)

    def usage(self, now_ms: int) -> float:
        """Current per-second QPS usage of the mirrored window (ops)."""
        ring = self._ring
        if ring is not None:
            return ring.usage(now_ms)
        with self._lock:
            self._rotate(now_ms)
            return self._used()


class _WarmUpMirror:
    """Host mirror of one WARM_UP flow rule's token bucket, in the same
    float32 arithmetic as the compiled step (``models/flow.py``):
    ``_sync_warmup`` refills once per second against the previous
    bucket's pass count, and admission compares the window's usage to
    the warning-zone throttled QPS. State starts exactly like the
    device's (stored=0, lastFilled=0 → first sync refills to maxToken =
    fully cold), and — like the device, which re-creates FlowState on
    every flow push — resets on every lease-table rebuild."""

    __slots__ = ("threshold", "warning_token", "max_token", "slope",
                 "stored", "last_filled_ms", "warm_up_period_sec")

    def __init__(self, count: float, warm_up_period_sec: int):
        # Same derivation as compile_flow_rules (Guava SmoothWarmingUp):
        # float64 params cast to float32 tensors.
        cnt = max(count, 1e-9)
        cold = C.COLD_FACTOR
        wt = (warm_up_period_sec * cnt) / (cold - 1)
        mt = wt + 2.0 * warm_up_period_sec * cnt / (1 + cold)
        self.threshold = np.float32(count)
        self.warning_token = np.float32(wt)
        self.max_token = np.float32(mt)
        self.slope = np.float32((cold - 1.0) / cnt / max(mt - wt, 1e-9))
        self.stored = np.float32(0.0)
        self.last_filled_ms = 0
        self.warm_up_period_sec = warm_up_period_sec

    def sync(self, now_ms: int, prev_bucket_pass: int) -> None:
        now_sec = now_ms // 1000 * 1000
        if now_sec <= self.last_filled_ms:
            return
        prev = np.float32(prev_bucket_pass)
        elapsed_s = np.float32(now_sec - self.last_filled_ms) \
            / np.float32(1000.0)
        stored = self.stored
        refill = stored + elapsed_s * self.threshold
        below = stored < self.warning_token
        above = stored > self.warning_token
        low_qps = prev < self.threshold / np.float32(C.COLD_FACTOR)
        new = refill if (below or (above and low_qps)) else stored
        new = min(new, self.max_token)
        new = max(new - prev, np.float32(0.0))
        self.stored = np.float32(new)
        self.last_filled_ms = now_sec

    def effective_threshold(self) -> np.float32:
        stored = self.stored
        wtok = self.warning_token
        if stored >= wtok:
            return np.float32(1.0) / (
                (stored - wtok) * self.slope
                + np.float32(1.0) / max(self.threshold, np.float32(1e-9)))
        return self.threshold


# A key whose bucket has been idle this many windows is provably full
# again (refill clamps at max_count within ceil(max/thr)+1 windows), so
# evicting it is EXACT — the next request sees a fresh full bucket
# either way. The cap bounds the mirror's memory under key churn.
_PARAM_MAX_KEYS = 4096


class _ParamLeaseMirror:
    """Host mirror of ONE param-flow rule (QPS/DEFAULT): exact per-value
    windowed token buckets in the device's float32 math
    (``models/param_flow.py`` ``passDefaultLocalCheck`` analog). The
    mirror is exact for every value (a dict has no slot collisions), so
    it sits between the device's two tiers: identical to the hot-tier
    owner bucket, tighter than the cold-tier CMS (which only
    over-estimates usage and so under-admits).

    Like the device — where a window-boundary crossing rolls the bucket
    for BLOCKED requests too — the roll happens for every applicable
    request, and tokens are consumed at param-check time even when a
    later family blocks the entry (the reference chain's ParamFlowSlot
    runs before FlowSlot)."""

    __slots__ = ("param_idx", "threshold", "burst", "duration_ms", "items",
                 "buckets")

    def __init__(self, rule):
        from sentinel_tpu_torch.utils.param_hash import hash_param

        self.param_idx = int(rule.param_idx)
        self.threshold = np.float32(rule.count)
        self.burst = np.float32(rule.burst_count)
        self.duration_ms = max(int(rule.duration_in_sec) * 1000, 1)
        # Per-value exception thresholds (exact hash match, max wins —
        # the device takes the max over matched item slots).
        self.items: Dict[int, np.float32] = {}
        for item in rule.items[:8]:
            h = hash_param(item.object)
            prev = self.items.get(h)
            c = np.float32(item.count)
            self.items[h] = c if prev is None or c > prev else prev
        self.buckets: Dict[int, list] = {}

    def check_commit(self, count: int, now_ms: int,
                     params) -> Optional[bool]:
        """None = rule not applicable (no such argument); True = admitted
        (token consumed); False = blocked (bucket rolled, not consumed)."""
        if self.param_idx >= len(params):
            return None
        h = params[self.param_idx]
        thr = self.items.get(h, self.threshold)
        max_count = thr + self.burst
        acq = np.float32(count)
        ent = self.buckets.get(h)
        if ent is None:
            # Fresh key: full bucket (host-exact; the device's CMS
            # estimate is 0 for a first-seen value too).
            ok = bool(thr > 0) and bool(acq <= max_count)
            if ok:
                if len(self.buckets) >= _PARAM_MAX_KEYS:
                    self._evict(now_ms)
                self.buckets[h] = [np.float32(max_count - acq), now_ms]
            return ok
        tokens, filled = ent
        windows = max((now_ms - filled) // self.duration_ms, 0)
        avail = min(tokens + np.float32(windows) * thr, max_count)
        ok = bool(thr > 0) and bool(acq <= avail)
        # Window roll commits for blocked requests too (device
        # ``touch``/``need_stamp`` are gated on applicability, not
        # admission); consumption only on admission (``ok`` implies
        # ``avail - acq >= 0`` exactly in IEEE float32).
        ent[0] = np.float32(avail - acq) if ok else np.float32(avail)
        if windows >= 1:
            ent[1] = now_ms
        return ok

    def consume(self, count: int, now_ms: int, params) -> None:
        """Mirror a DEVICE-decided pass: roll the value's bucket window
        and consume unconditionally (the device already admitted it, so
        the mirror must reflect the spend — clamped at zero like the
        device's own maximum). Keeps mixed traffic (prioritized /
        pipeline-mode entries on a param-leased resource) from earning
        an independent second quota out of the host mirror."""
        if self.param_idx >= len(params):
            return
        h = params[self.param_idx]
        thr = self.items.get(h, self.threshold)
        max_count = thr + self.burst
        ent = self.buckets.get(h)
        if ent is None:
            if len(self.buckets) >= _PARAM_MAX_KEYS:
                self._evict(now_ms)
            self.buckets[h] = [
                np.float32(max(max_count - np.float32(count), 0.0)), now_ms]
            return
        tokens, filled = ent
        windows = max((now_ms - filled) // self.duration_ms, 0)
        avail = min(tokens + np.float32(windows) * thr, max_count)
        ent[0] = np.float32(max(avail - np.float32(count), 0.0))
        if windows >= 1:
            ent[1] = now_ms

    def _evict(self, now_ms: int) -> None:
        """Drop provably-full (long-idle) buckets; exact — see cap note."""
        full_after = self.duration_ms * (
            2 + int(float(self.burst) / max(float(self.threshold), 1e-9)))
        stale = [h for h, (_t, filled) in self.buckets.items()
                 if now_ms - filled >= full_after]
        for h in stale:
            del self.buckets[h]
        if len(self.buckets) >= _PARAM_MAX_KEYS:
            # Every key is hot: drop the oldest-stamped quarter. Evicted
            # hot keys restart with a full bucket — a bounded, logged
            # over-admission (≤ one window per evicted key), preferred
            # over unbounded host memory.
            from sentinel_tpu_torch.log.record_log import record_log

            oldest = sorted(self.buckets.items(), key=lambda kv: kv[1][1])
            for h, _ in oldest[:_PARAM_MAX_KEYS // 4]:
                del self.buckets[h]
            record_log.warn(
                "param lease mirror evicted %d hot keys (cap %d)",
                len(oldest) // 4, _PARAM_MAX_KEYS)


class WideLease(LocalLease):
    """Widened host lease: DEFAULT + WARM_UP flow rules and at most one
    QPS/DEFAULT param-flow rule, admitted in the device chain's order
    (param-flow before flow) with the step's own float32 arithmetic.

    Always runs the pure-Python ring — the C extension only knows the
    plain-threshold compare, and these resources' per-entry budget is
    dominated by the float32 mirror math anyway (a handful of numpy
    scalar ops, still ~100x cheaper than a device dispatch)."""

    __slots__ = ("warm", "param", "_thr32", "_qps_scale")

    def __init__(self, thresholds: List[float], warm_specs: List[tuple],
                 param_rule, interval_ms: int, buckets: int):
        super().__init__(thresholds, interval_ms, buckets, use_native=False)
        self.warm = [_WarmUpMirror(count, period)
                     for count, period in warm_specs]
        self.param = (_ParamLeaseMirror(param_rule)
                      if param_rule is not None else None)
        self._thr32 = [np.float32(t) for t in thresholds]
        self._qps_scale = np.float32(1000.0 / interval_ms)

    def admit(self, count: int, now_ms: int, params=()) -> int:
        with self._lock:
            idx = self._rotate(now_ms)
            # Device chain order: param-flow verdicts (and their token
            # consumption) land before the flow family sees the entry.
            if self.param is not None:
                param_ok = self.param.check_commit(count, now_ms, params)
            else:
                param_ok = None
            # Warm-up sync runs on every step regardless of earlier-
            # family verdicts (check_flow always syncs), keyed on the
            # PREVIOUS bucket's pass count like the device gather.
            if self.warm:
                prev = self._counts[(idx - 1) % self.buckets]
                for w in self.warm:
                    w.sync(now_ms, prev)
            if param_ok is False:
                return _PARAM_REASON
            used = np.float32(sum(self._counts)) * self._qps_scale
            acq = np.float32(count)
            for thr in self._thr32:
                if used + acq > thr:
                    return _FLOW_REASON
            for w in self.warm:
                if used + acq > w.effective_threshold():
                    return _FLOW_REASON
            self._counts[idx] += count
            return 0

    def add(self, count: int, now_ms: int, params=()) -> None:
        """A device-decided pass updates the window ring AND the param
        mirror: the device path runs beside the lease for prioritized
        entries and the pipeline mode, and an un-mirrored device pass
        would let the same value spend its quota twice (once per side)."""
        with self._lock:
            idx = self._rotate(now_ms)
            self._counts[idx] += count
            if self.param is not None and params:
                self.param.consume(count, now_ms, params)


def _default_leaseable(r) -> bool:
    return (r.grade == C.FLOW_GRADE_QPS
            and r.control_behavior == C.CONTROL_BEHAVIOR_DEFAULT
            and r.strategy == C.FLOW_STRATEGY_DIRECT
            and r.limit_app == C.LIMIT_APP_DEFAULT
            and not r.cluster_mode)


def _warmup_leaseable(r) -> bool:
    return (r.grade == C.FLOW_GRADE_QPS
            and r.control_behavior == C.CONTROL_BEHAVIOR_WARM_UP
            and r.strategy == C.FLOW_STRATEGY_DIRECT
            and r.limit_app == C.LIMIT_APP_DEFAULT
            and not r.cluster_mode
            and r.warm_up_period_sec > 0)


def _param_leaseable(rules) -> bool:
    if len(rules) != 1:
        return False
    r = rules[0]
    return (r.grade == C.PARAM_FLOW_GRADE_QPS
            and r.control_behavior == C.CONTROL_BEHAVIOR_DEFAULT
            and not r.cluster_mode
            and r.duration_in_sec >= 1
            and 0 <= r.param_idx < MAX_PARAMS)


def build_lease_table(engine):
    """Recompute the fast-path state from the engine's CURRENT rules
    (called under the engine lock on every rule push / geometry change).

    Returns ``(leases, guarded, unruled_ok)``:
      * ``leases`` — resource -> LocalLease for lease-ELIGIBLE ruled
        resources;
      * ``guarded`` — every resource carrying ANY rule of any family, or
        RELATEd/CHAINed to by a flow rule: these must use the device
        path when not in ``leases``;
      * ``unruled_ok`` — True when a resource carrying NO rules at all
        may skip the device check entirely (always-pass + async stats):
        the same global gates as leasing (no system rules, no SPI).
    """
    if engine.system_rules.get_rules():
        return {}, set(), False
    if engine._spi.host_slots() or engine._spi.device_checkers():
        return {}, set(), False
    rollout = getattr(engine, "rollout", None)
    if rollout is not None and rollout.device_active():
        # A staged candidate (shadow / canary) needs EVERY entry on the
        # device path: host-leased admissions would be invisible to its
        # would-verdict counters and unenforceable for canary lanes. The
        # fast path stands down until promote or abort.
        return {}, set(), False
    flow_rules = engine.flow_rules.get_rules()
    ruled = {}
    for r in flow_rules:
        ruled.setdefault(r.resource, []).append(r)
    param_by_res = {}
    for r in engine.param_rules.get_rules():
        param_by_res.setdefault(r.resource, []).append(r)
    # A resource another rule RELATEs/CHAINs to must stay on the device
    # path: its window feeds that rule's check, and leased commits land
    # with up to one flush of lag.
    refs = {r.ref_resource for r in flow_rules if r.ref_resource}
    blocked_resources = set()
    for mgr in (engine.degrade_rules, engine.authority_rules):
        for r in mgr.get_rules():
            blocked_resources.add(r.resource)
    guarded = set(ruled) | set(param_by_res) | refs | blocked_resources
    spec = engine._spec1
    out = {}
    for resource in set(ruled) | set(param_by_res):
        if resource in blocked_resources or resource in refs:
            continue
        frules = ruled.get(resource, ())
        prules = param_by_res.get(resource, ())
        defaults = [float(r.count) for r in frules if _default_leaseable(r)]
        warms = [(float(r.count), int(r.warm_up_period_sec))
                 for r in frules if _warmup_leaseable(r)]
        if len(defaults) + len(warms) != len(frules):
            continue  # some flow rule needs the device path
        if prules and not _param_leaseable(prules):
            continue
        if warms or prules:
            out[resource] = WideLease(defaults, warms,
                                      prules[0] if prules else None,
                                      spec.interval_ms, spec.buckets)
        elif defaults:
            out[resource] = LocalLease(defaults, spec.interval_ms,
                                       spec.buckets)
    return out, guarded, True


def _entry_batch_from(chunk: List[tuple]) -> dict:
    """(cluster_row, dn_row, origin_row, entry_in, count, passed,
    block_reason) tuples → the numpy staging dict of a pre-decided entry
    batch at its ladder width (the ONE fill site both committers share).
    ``block_reason`` names the rejecting family for blocked entries
    (attribution channel); ignored for passes."""
    buf = make_entry_batch_np(ladder_width(len(chunk)))
    for i, (cr, dr, orow, ein, cnt, passed, reason) in enumerate(chunk):
        buf["cluster_row"][i] = cr
        buf["dn_row"][i] = dr
        buf["origin_row"][i] = orow
        buf["entry_in"][i] = ein
        buf["count"][i] = cnt
        buf["pre_passed"][i] = passed
        buf["pre_blocked"][i] = not passed
        if not passed and reason:
            buf["pre_reason"][i] = reason
    return buf


def _exit_batch_from(chunk: List[tuple]) -> dict:
    """(cluster_row, dn_row, origin_row, entry_in, count, rt_ms, success,
    error) tuples → the numpy staging dict of an exit batch."""
    buf = make_exit_batch_np(ladder_width(len(chunk)))
    for i, (cr, dr, orow, ein, cnt, rt, succ, err) in enumerate(chunk):
        buf["cluster_row"][i] = cr
        buf["dn_row"][i] = dr
        buf["origin_row"][i] = orow
        buf["entry_in"][i] = ein
        buf["count"][i] = cnt
        buf["rt_ms"][i] = rt
        buf["success"][i] = succ
        buf["error"][i] = err
    return buf


class SyncCommitter:
    """Inline fallback handed out after ``engine.close()``: commits each
    outcome synchronously on the device instead of resurrecting the daemon
    thread for an entry that raced the shutdown."""

    def __init__(self, engine):
        self.engine = engine

    def add_entry(self, cluster_row: int, dn_row: int, origin_row: int,
                  entry_in: bool, count: int, passed: bool,
                  block_reason: int = _FLOW_REASON) -> None:
        self.engine._run_entry_batch(_entry_batch_from(
            [(cluster_row, dn_row, origin_row, entry_in, count, passed,
              block_reason)]))

    def add_exit(self, cluster_row: int, dn_row: int, origin_row: int,
                 entry_in: bool, count: int, rt_ms: int, success: bool,
                 error: bool) -> None:
        self.engine._run_exit_batch(_exit_batch_from(
            [(cluster_row, dn_row, origin_row, entry_in, count, rt_ms,
              success, error)]))

    def flush(self) -> None:
        pass

    def pending_pass_counts(self) -> Dict[int, int]:
        return {}


class StatsCommitter:
    """Streams host-decided outcomes to the device in micro-batches.

    One daemon thread; entries and exits queue lock-free-ish (GIL deque)
    and flush every ``linger_s`` or at ``max_batch``. ENTRIES flush
    before exits each cycle: unlike the pipeline (where an entry is
    device-committed before its caller can exit), a leased pair can have
    BOTH halves queued, and dispatching the exit first would drive the
    thread gauge negative and let SUCCESS outrun PASS across a second
    boundary."""

    def __init__(self, engine, linger_s: float = 0.002,
                 max_batch: int = 2048):
        self.engine = engine
        self.linger_s = linger_s
        self.max_batch = max_batch
        # Deques, not lock+list: append/popleft/len/copy are GIL-atomic,
        # so producers enqueue lock-free — the per-entry lock acquire
        # measured ~9µs under committer contention, dominating the leased
        # path's µs/op budget.
        self._entries: Deque[tuple] = collections.deque()
        self._exits: Deque[tuple] = collections.deque()
        # Serializes whole flush passes: a reader's flush() must WAIT for
        # an in-flight background flush (which already drained the queues)
        # or it would return with the items still un-committed.
        self._flush_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # What the flushes did, for the smoke and the tests: passes that
        # dispatched anything, the dispatched batches by ladder width, and
        # background or final-drain flushes that raised (their commits are
        # lost; a reader's own flush raises to the reader instead).
        self.flushes = 0
        self.failures = 0
        self.entry_widths: Dict[int, int] = {}
        self.exit_widths: Dict[int, int] = {}

    def start(self) -> "StatsCommitter":
        import atexit

        from sentinel_tpu_torch.utils import time_util

        # Under a frozen test clock, flush BEFORE every advance so queued
        # commits land in the second they were decided in (under the real
        # clock the hook list is never invoked).
        self._off_advance = time_util.on_advance(self.flush)
        self._thread = threading.Thread(
            target=self._run, name="sentinel-torch-stats-committer",
            daemon=True)
        self._thread.start()
        # A daemon thread killed mid-dispatch at interpreter exit can die
        # inside the device runtime; stop cleanly at exit instead.
        self._atexit = atexit.register(self.stop)
        return self

    def stop(self) -> None:
        import atexit

        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if getattr(self, "_off_advance", None) is not None:
            self._off_advance()
            self._off_advance = None
        if getattr(self, "_atexit", None) is not None:
            atexit.unregister(self._atexit)
            self._atexit = None
        try:
            self.flush()  # drain stragglers synchronously
        except Exception as ex:  # noqa: BLE001 — best-effort final drain
            self.failures += 1
            # At interpreter shutdown (the atexit path) the device runtime
            # may already be half torn down. Stats are ephemeral by design
            # (reference stance: rules durable, stats not): losing the
            # last micro-batch at process death is the documented trade,
            # not worth a traceback on every clean exit.
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn("final committer drain failed: %r", ex)

    def add_entry(self, cluster_row: int, dn_row: int, origin_row: int,
                  entry_in: bool, count: int, passed: bool,
                  block_reason: int = _FLOW_REASON) -> None:
        self._entries.append(
            (cluster_row, dn_row, origin_row, entry_in, count, passed,
             block_reason))
        # Every append arms the wake (the flusher then lingers linger_s to
        # accumulate a micro-batch). A count-based "only the first append
        # wakes" scheme is racy without the per-append lock: two
        # concurrent first appends can both read len()==2 and neither
        # wake, parking the flusher forever (its wait has no timeout).
        # The is_set pre-check keeps the already-armed common case at a
        # plain volatile read instead of Event.set's lock acquire.
        if not self._wake.is_set():
            self._wake.set()

    def add_exit(self, cluster_row: int, dn_row: int, origin_row: int,
                 entry_in: bool, count: int, rt_ms: int, success: bool,
                 error: bool) -> None:
        self._exits.append((cluster_row, dn_row, origin_row, entry_in,
                            count, rt_ms, success, error))
        if not self._wake.is_set():
            self._wake.set()

    def pending_pass_counts(self) -> Dict[int, int]:
        """Un-flushed PASS counts per cluster row (no dispatch, no flush
        lock) — lets lease seeding account for in-flight commits without
        flushing under the engine lock (which the background flush also
        takes: flushing there would deadlock)."""
        items = self._entries.copy()  # GIL-atomic snapshot (C-level copy)
        out: Dict[int, int] = {}
        for (cr, _dr, _orow, _ein, cnt, passed, _reason) in items:
            if passed:
                out[cr] = out.get(cr, 0) + cnt
        return out

    def _run(self) -> None:
        while not self._stop.is_set():
            # Idle engines sleep here indefinitely (no 2ms polling): the
            # first enqueue sets the event, then we linger briefly so the
            # flush carries a micro-batch rather than a single item.
            self._wake.wait()
            if self._stop.is_set():
                break
            self._stop.wait(self.linger_s)
            self._wake.clear()
            try:
                self.flush()
            except Exception as ex:  # noqa: BLE001 — log, count, carry on
                self.failures += 1
                from sentinel_tpu_torch.log.record_log import record_log

                record_log.warn("stats committer flush failed: %r", ex)

    def flush(self) -> None:
        """Drain both queues to the device (also used by tests/seal).

        Holds ``_flush_lock`` across drain AND dispatch, so a concurrent
        reader's flush returns only after everything enqueued before its
        call is actually committed."""
        with self._flush_lock:
            self._flush_locked()

    @staticmethod
    def _drain(q) -> List[tuple]:
        items: List[tuple] = []
        pop = q.popleft
        try:
            while True:
                items.append(pop())
        except IndexError:
            return items

    def _flush_locked(self) -> None:
        # Capture EXITS first, entries second: a producer enqueues an
        # entry strictly before its exit, so any exit caught by the first
        # drain has its entry already dispatched or caught by the second
        # — entries then dispatch before exits below, and the thread
        # gauge can never see an exit outrun its entry. (Draining
        # entries first would open exactly that window for a pair
        # enqueued between the two drains.)
        exits = self._drain(self._exits)
        entries = self._drain(self._entries)
        if entries or exits:
            self.flushes += 1
        eng = self.engine
        while entries:
            chunk, entries = entries[:self.max_batch], entries[self.max_batch:]
            buf = _entry_batch_from(chunk)
            _count_width(self.entry_widths, buf)
            eng._run_entry_batch(buf)
        while exits:
            chunk, exits = exits[:self.max_batch], exits[self.max_batch:]
            buf = _exit_batch_from(chunk)
            _count_width(self.exit_widths, buf)
            eng._run_exit_batch(buf)

    def pending(self) -> Tuple[int, int]:
        """(queued entries, queued exits) not yet drained by a flush."""
        return len(self._entries), len(self._exits)


def _count_width(hist: Dict[int, int], buf: dict) -> None:
    width = len(buf["cluster_row"])
    hist[width] = hist.get(width, 0) + 1
