"""Dynamic slot-table admission: a bounded device hot set (port of
``sentinel_tpu/core/slots.py``).

The fused step is sized for ONE fixed device tensor of ``capacity``
rows. In slot mode the device tensor shrinks to a slot BUDGET holding
only the live hot set, and the host-side :class:`SlotTable` maps
resources into it dynamically:

* **admit**: a cold resource claims a free slot on first touch (and on
  rebalance, when the population telescope ranks it above an
  incumbent). Admission grafts any previously spilled window rows back
  exactly.
* **evict**: a slot steal spills the victim's per-row columns host-side
  into a :class:`SpillRecord` (1s / 60s windows, staged second,
  concurrency gauge, occupy borrows, cumulative telemetry), then zeroes
  the columns and bumps the slot's GENERATION stamp, so a reused slot can
  never leak the evicted resource's series.
* **cold tail**: resources past the budget degrade LOUDLY, never raise:
  leaseable-ruled resources keep host-exact admission through their
  ``LocalLease`` / ``WideLease``; device-only-ruled cold resources pass
  unenforced behind a counter; unruled cold resources pass behind a
  counter. Cold pass / block / exit tallies fold back into the device
  totals at rehydration (exact counter conservation).
* **pins**: resources named by any compiled rule, live or of the staged
  rollout candidate, are PINNED hot (the compiled rule tensors target
  slot indices). Only unruled resources churn.

Steal / admit decisions ride the once-per-second spill fold
(:meth:`SlotTable.on_spill`), fed by the telescope's top-k, behind the
freeze gate (manual > churn-alarm > telemetry-stale). The fault seams
``slots.evict.storm`` and ``slots.spill.torn`` (``resilience/faults.py``)
exercise the machinery; every transition goes to ``event_sink``.

The surgery on the device state (:meth:`SlotTable._execute`) gathers the
touched slots' columns of every per-row tensor into one int32 buffer
(int64 tensors reinterpreted as int32 pairs), moves it to the host in
ONE device-to-host copy, runs the reference's spill and graft arithmetic
on those columns in numpy, and writes them back with ONE host-to-device
copy and ``index_copy_``; the flight ring's and the rollout shadow
world's touched columns are zeroed on the device (``index_fill_``). The
result is the reference's full-array surgery, bit for bit, at the cost of
the touched columns only
(``surgery_d2h_bytes_total`` / ``surgery_h2d_bytes_total``).

Concurrency protocol:

* ``gate`` (a plain mutex) owns the resource -> (slot, generation) map.
  The map dict is replaced WHOLESALE under ``gate``; lock-free readers
  see the old or the new mapping, never a torn one. Leased-path
  committer enqueues re-translate UNDER ``gate`` immediately before
  enqueue, so a commit is never queued for a slot whose tenancy changed.
* a steal runs: swap the map under ``gate`` (victims out, targets
  reserved) -> flush the stats committer WITHOUT any engine lock (a
  flush under ``engine._lock`` deadlocks against the background flush
  thread) -> state surgery under ``engine._lock`` on the engine's stream
  -> publish the admits under ``gate``.
* lock ORDER is ``engine._lock`` -> ``gate``; never the reverse.
* evicted slots DRAIN (``_draining``) until the surgery zeroes them;
  first-touch admission only claims slots from ``_free``.

No wall-clock reads in this module: every timestamp is the engine
timebase, passed in by the caller.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.registry import (
    ENTRY_ROW,
    KIND_CLUSTER,
    ROOT_ROW,
    NodeMeta,
)

# Slots 0/1 mirror the registry's fixed rows (machine-root, the global
# ENTRY_NODE; ops/step.py hardcodes ENTRY_ROW for inbound commits), so
# dynamic tenancy starts at 2.
FIRST_SLOT = 2

# Synthetic meta kind for an unoccupied slot: never matches KIND_*, so
# every consumer's ``kind != KIND_CLUSTER`` skip naturally drops it.
KIND_FREE = -1

# EntryHandle.slot_gen sentinel: the entry was served on the COLD path
# (no device commit — its exit tallies host-side, never on-device).
COLD_GEN = -2


class SpillRecord:
    """One evicted resource's per-row state, host-side, numpy.

    Geometry stamps (window bucket starts, second/occupy stamps) are
    captured WITH the data so rehydration can graft each bucket exactly
    iff it is still current: ``old_starts[i] != new_starts[i]`` means
    the bucket rotated while the resource was cold, and its grants
    expired with it (the "grants-since-spill" conservation margin of
    docs/SEMANTICS.md)."""

    __slots__ = (
        "resource", "generation", "evicted_ms",
        "w1_counts", "w1_min_rt", "w1_starts",
        "w60_counts", "w60_min_rt", "w60_starts",
        "sec_counts", "sec_min_rt", "sec_stamp",
        "cur_threads", "occupied_next", "occupied_stamp",
        "tel_block", "tel_hist", "tel_totals",
        "spilled_pass",
    )

    def __init__(self, resource: str, generation: int, evicted_ms: int):
        self.resource = resource
        self.generation = generation
        self.evicted_ms = evicted_ms


class SlotTable:
    """Host-side admission cache: live hot set -> bounded device slots."""

    def __init__(self, engine, budget: int):
        from sentinel_tpu_torch.core.config import config as _cfg

        if budget < FIRST_SLOT + 1:
            raise ValueError(
                f"slot budget {budget} leaves no dynamic slots "
                f"(rows 0..{FIRST_SLOT - 1} are reserved)")
        self.engine = engine
        self.budget = int(budget)
        self.max_steals = _cfg.slots_max_steals()
        self.hysteresis_pct = _cfg.slots_hysteresis_pct()
        self.spill_max = _cfg.slots_spill_max()
        self.stale_seconds = _cfg.slots_stale_seconds()
        # The commit gate. See the module docstring's protocol.
        self.gate = threading.Lock()
        # resource -> (slot, generation). Replaced wholesale under gate;
        # read lock-free (GIL-atomic attribute + dict get).
        self._hot: Dict[str, Tuple[int, int]] = {}
        self._occupant: List[Optional[str]] = [None] * self.budget
        self._generation: List[int] = [0] * self.budget
        self._free: Set[int] = set(range(FIRST_SLOT, self.budget))
        # Evicted slots awaiting surgery's zeroing — NOT claimable.
        self._draining: Set[int] = set()
        # Resources mid-admission (reserved, mapping not yet published).
        self._admitting: Set[str] = set()
        # Spill store: resource -> SpillRecord, LRU-capped. A dropped
        # record is a bounded, counted loss (the resource rehydrates
        # cold) — never an error.
        self._spill: "OrderedDict[str, SpillRecord]" = OrderedDict()
        # Cold-tail tallies: resource -> int64[NUM_EVENTS] event deltas
        # served host-side while cold; folded into the device totals at
        # rehydration (exact counter conservation). Guarded by ``gate``.
        self._cold: Dict[str, np.ndarray] = {}
        # Freeze envelope (manual > churn-alarm > telemetry-stale).
        self._manual_freeze: Optional[str] = None
        self._observed_last = -1
        self._observed_changed_ms = -1
        self._rebalanced_ms = -1
        # Device-metas cache: rebuilt when occupancy changes; the LIST
        # OBJECT is immutable once built, so a reference captured at a
        # flight-recorder spill is a true tenancy snapshot.
        self._metas_cache: Optional[List[NodeMeta]] = None
        self._metas_version = -1
        self._version = 0
        # stamp_ms -> the device-metas list in force when that flight
        # second spilled: the timeseries history renders PAST seconds
        # with PAST tenancy, so a reused slot's old seconds can never
        # re-attribute to the successor (the generation-leak pin).
        self._stamp_metas: "OrderedDict[int, List[NodeMeta]]" = OrderedDict()
        # Chaos observability: callable(dict) invoked with every
        # admit/evict/rehydrate/late-exit transition (slot_storm wires a
        # History in; None in production — zero overhead).
        self.event_sink: Optional[Callable[[dict], None]] = None
        # Counters (exported as sentinel_tpu_slots_*).
        self.admits_total = 0
        self.evictions_total = 0
        self.rehydrations_total = 0
        self.rehydrations_cold_total = 0
        self.steals_total = 0
        self.storms_total = 0
        self.hot_hits_total = 0
        self.cold_pass_total = 0
        self.cold_block_total = 0
        self.cold_unenforced_total = 0
        self.spill_torn_total = 0
        self.spill_dropped_total = 0
        self.late_exits_total = 0
        self.pin_overflow_total = 0
        self.freezes_total = 0
        # What the device surgeries moved (not in status(), which keeps
        # the reference's keys): count, and bytes each way.
        self.surgeries_total = 0
        self.surgery_d2h_bytes_total = 0
        self.surgery_h2d_bytes_total = 0

    # -- translation (the ONLY resource->slot map in the tree) ------------

    def device_row(self, resource: str) -> Optional[int]:
        """The resource's current device slot, or None while cold. The
        single translation implementation: no second resource->slot map
        exists outside this module."""
        cur = self._hot.get(resource)
        return cur[0] if cur is not None else None

    def current(self, resource: str) -> Optional[Tuple[int, int]]:
        """(slot, generation) of the resource's live tenancy, or None."""
        return self._hot.get(resource)

    def resources(self) -> Dict[str, int]:
        """resource -> slot of the current hot set (ops-plane shape
        parity with ``NodeRegistry.resources``)."""
        return {res: sg[0] for res, sg in self._hot.items()}

    def hot_count(self) -> int:
        return len(self._hot)

    def device_metas(self) -> List[NodeMeta]:
        """Slot-indexed meta view mirroring ``registry.meta``'s shape:
        rows 0/1 are the registry's fixed rows, occupied slots render as
        ClusterNodes of their occupant, free slots as inert KIND_FREE
        rows. Cached per occupancy version; the returned list is never
        mutated after build."""
        cache, ver = self._metas_cache, self._metas_version
        if cache is not None and ver == self._version:
            return cache
        with self.gate:
            if self._metas_cache is not None \
                    and self._metas_version == self._version:
                return self._metas_cache
            reg = self.engine.registry
            root = NodeMeta(row=ROOT_ROW, kind=reg.meta[ROOT_ROW].kind,
                            resource=reg.meta[ROOT_ROW].resource)
            entry = NodeMeta(row=ENTRY_ROW, kind=reg.meta[ENTRY_ROW].kind,
                             resource=reg.meta[ENTRY_ROW].resource,
                             parent_row=ROOT_ROW)
            metas: List[NodeMeta] = [root, entry]
            for slot in range(FIRST_SLOT, self.budget):
                res = self._occupant[slot]
                if res is None:
                    metas.append(NodeMeta(row=slot, kind=KIND_FREE))
                    continue
                src = reg.get_cluster_row(res)
                src_meta = reg.meta[src] if src is not None else None
                metas.append(NodeMeta(
                    row=slot, kind=KIND_CLUSTER, resource=res,
                    parent_row=ROOT_ROW,
                    entry_type=(src_meta.entry_type if src_meta
                                else int(C.EntryType.OUT)),
                    resource_type=(src_meta.resource_type if src_meta
                                   else int(C.ResourceType.COMMON))))
                root.children.append(slot)
            self._metas_cache = metas
            self._metas_version = self._version
            return metas

    def rule_registry_view(self) -> "_RuleRegistryView":
        """The registry facade handed to the rule compilers: resource
        rows resolve through THIS table (a cold resource compiles to row
        -1 = inert rule slot), id interning passes through to the real
        registry. Pins keep ruled resources hot, so inert compiles only
        happen past a pin overflow, which is counted and logged."""
        return _RuleRegistryView(self)

    # -- flight-second tenancy snapshots (generation-leak defense) --------

    def remember_metas(self, stamp_ms: int, metas: List[NodeMeta]) -> None:
        """Pin the tenancy view a flight second spilled under, keyed by
        its stamp; the timeseries history renders with it forever after."""
        ts = getattr(self.engine, "timeseries", None)
        keep = max(64, getattr(ts, "retention_seconds", 0) or 64)
        with self.gate:
            self._stamp_metas[int(stamp_ms)] = metas
            while len(self._stamp_metas) > keep:
                self._stamp_metas.popitem(last=False)

    def recall_metas(self, stamp_ms: int) -> Optional[List[NodeMeta]]:
        return self._stamp_metas.get(int(stamp_ms))

    # -- freeze envelope ---------------------------------------------------

    def freeze(self, reason: str) -> None:
        """Manual steal freeze (ops ``slots op=freeze``): rebalance
        steals stop; first-touch free-slot admits continue (freezing
        those would turn a drill into an outage for new resources)."""
        self._manual_freeze = str(reason) or "manual"
        self.freezes_total += 1

    def thaw(self) -> None:
        self._manual_freeze = None

    def freeze_reason(self, now_ms: int) -> Optional[str]:
        """Why steals are frozen right now, else None. Precedence:
        manual > churn-alarm > telemetry-stale (the standard envelope —
        an operator hold beats automation, a firing cardinality alarm
        means the top-k feed is churning too fast to trust for steals,
        and a stale telescope means the feed itself stopped moving)."""
        if self._manual_freeze is not None:
            return f"manual: {self._manual_freeze}"
        population = getattr(self.engine, "population", None)
        if population is None or not population.enabled:
            return "telemetry-stale: population telescope disabled"
        if population.alarm:
            return "churn-alarm: cardinality alarm firing"
        observed = population.observed_total
        if observed != self._observed_last:
            self._observed_last = observed
            self._observed_changed_ms = now_ms
        elif self._observed_changed_ms >= 0 and now_ms \
                - self._observed_changed_ms > self.stale_seconds * 1000:
            return ("telemetry-stale: population feed unchanged for "
                    f"{(now_ms - self._observed_changed_ms) // 1000}s")
        return None

    # -- cold-tail accounting ---------------------------------------------

    def _cold_tally_locked(self, resource: str, event: int,
                           count: int) -> None:
        vec = self._cold.get(resource)
        if vec is None:
            vec = self._cold[resource] = np.zeros(C.NUM_EVENTS, np.int64)
        vec[event] += count

    def cold_pass(self, resource: str, count: int,
                  unenforced: bool = False) -> None:
        with self.gate:
            self._cold_tally_locked(resource, int(C.MetricEvent.PASS), count)
            self.cold_pass_total += 1
            if unenforced:
                self.cold_unenforced_total += 1

    def cold_block(self, resource: str, count: int) -> None:
        with self.gate:
            self._cold_tally_locked(resource, int(C.MetricEvent.BLOCK), count)
            self.cold_block_total += 1

    def cold_exit(self, resource: str, count: int, rt_ms: int,
                  error: bool) -> None:
        """Completion of a COLD-path entry: SUCCESS/EXCEPTION/RT tally
        host-side (there is no device row to commit to)."""
        with self.gate:
            self._cold_tally_locked(resource,
                                    int(C.MetricEvent.SUCCESS), count)
            self._cold_tally_locked(resource, int(C.MetricEvent.RT), rt_ms)
            if error:
                self._cold_tally_locked(resource,
                                        int(C.MetricEvent.EXCEPTION), count)

    def evicted_exit(self, resource: str, count: int, rt_ms: int,
                     error: bool, now_ms: int) -> None:
        """Completion of a DEVICE-committed entry whose resource was
        evicted (and not re-admitted) before it exited: the entry's
        thread count is standing in the spill record — decrement it
        there so rehydration cannot leak phantom concurrency — and its
        completion stats tally cold (they fold back on rehydrate)."""
        with self.gate:
            rec = self._spill.get(resource)
            if rec is not None:
                rec.cur_threads = max(0, int(rec.cur_threads) - count)
            self._cold_tally_locked(resource,
                                    int(C.MetricEvent.SUCCESS), count)
            self._cold_tally_locked(resource, int(C.MetricEvent.RT), rt_ms)
            if error:
                self._cold_tally_locked(resource,
                                        int(C.MetricEvent.EXCEPTION), count)
            self.late_exits_total += 1
        self._emit({"e": "slotLateExit", "resource": resource,
                    "count": count, "ms": now_ms})

    # -- admission ---------------------------------------------------------

    def try_admit(self, resource: str, now_ms: int) -> Optional[Tuple[int, int]]:
        """First-touch admission into a FREE slot (never a steal): the
        fast path for a cold resource while the table is under budget.
        Returns the published (slot, generation), or None when no free
        slot exists / the resource is mid-admission elsewhere. Pays a
        rehydration graft iff a spill record survives."""
        with self.gate:
            cur = self._hot.get(resource)
            if cur is not None:
                return cur
            if resource in self._admitting or not self._free:
                return None
            slot = min(self._free)  # deterministic choice (replay oracles)
            self._free.discard(slot)
            self._occupant[slot] = resource
            self._admitting.add(resource)
            self._version += 1
        self._execute([], [(resource, slot)], now_ms)
        return self._hot.get(resource)

    def ensure_pinned(self, pinned: Set[str], now_ms: int) -> None:
        """Make every ruled resource hot BEFORE its rules compile (the
        config-plane hook on each rule push): compiled rule tensors
        target slot indices, so a cold ruled resource would compile to
        an inert rule. Steals unpinned incumbents when the free list
        runs dry; past that, the remaining pins overflow LOUDLY (the
        rule stays unenforced-while-cold, counted + logged)."""
        missing = [res for res in sorted(pinned)
                   if res not in self._hot and res not in self._admitting]
        if not missing:
            return
        evicts: List[Tuple[str, int, int]] = []
        admits: List[Tuple[str, int]] = []
        overflowed = 0
        with self.gate:
            hot = dict(self._hot)
            # Victim pool: unpinned occupants, coldest-first by the
            # telescope's current ranking (absent from top-k = 0).
            counts = self._population_counts()
            victims = sorted(
                (res for res in hot if res not in pinned),
                key=lambda r: (counts.get(r, 0), r))
            for res in missing:
                if res in hot or res in self._admitting:
                    continue
                if self._free:
                    slot = min(self._free)
                    self._free.discard(slot)
                elif victims:
                    victim = victims.pop(0)
                    slot, gen = hot.pop(victim)
                    self._generation[slot] = gen + 1
                    self._occupant[slot] = None
                    self._draining.add(slot)
                    evicts.append((victim, slot, gen))
                else:
                    self.pin_overflow_total += 1
                    overflowed += 1
                    continue
                self._occupant[slot] = res
                self._admitting.add(res)
                admits.append((res, slot))
            self._hot = hot
            self._version += 1
        if overflowed:
            self._log_pin_overflow(pinned)
        if evicts or admits:
            self._execute(evicts, admits, now_ms)

    def _log_pin_overflow(self, pinned: Set[str]) -> None:
        from sentinel_tpu_torch.log.record_log import record_log

        record_log.warn(
            "slot table cannot pin every ruled resource (budget=%d, "
            "ruled=%d): overflowed rules stay UNENFORCED while cold; "
            "pin_overflow_total=%d", self.budget, len(pinned),
            self.pin_overflow_total)

    # -- rebalance (rides the spill fold) ----------------------------------

    def _population_counts(self) -> Dict[str, int]:
        population = getattr(self.engine, "population", None)
        if population is None or not population.enabled:
            return {}
        snap = population.snapshot(topk=max(2 * self.budget, 16), windows=1)
        return {e["key"]: int(e["count"]) for e in snap["topk"]}

    def on_spill(self, now_ms: int) -> None:
        """Rebalance tick, riding ``_spill_flight``'s once-per-second
        fold: sweep stale cold tallies of hot resources, then (at most
        once per second, outside any freeze) steal the coldest unpinned
        slots for telescope-ranked challengers under the hysteresis and
        ``max.steals`` bounds. The ``slots.evict.storm`` seam sits ABOVE
        the freeze gate — chaos must be able to exercise eviction even
        mid-freeze, exactly like a real operator drill."""
        from sentinel_tpu_torch.resilience import faults

        if now_ms - self._rebalanced_ms < 1000 and self._rebalanced_ms >= 0:
            return
        self._rebalanced_ms = now_ms
        self._sweep_hot_tallies(now_ms)

        storm = False
        try:
            faults.fire("slots.evict.storm")
        except faults.FaultInjected:
            storm = True
        if storm:
            self.storms_total += 1
            self._evict_storm(now_ms)
            return

        reason = self.freeze_reason(now_ms)
        if reason is not None:
            return

        counts = self._population_counts()
        if not counts:
            return
        pinned = self.engine._slot_pinned_resources()
        hot = self._hot
        challengers = sorted(
            ((cnt, res) for res, cnt in counts.items()
             if res not in hot and res not in self._admitting),
            reverse=True)
        if not challengers:
            return
        victims = sorted(
            ((counts.get(res, 0), res) for res in hot if res not in pinned))
        scale = 1.0 + self.hysteresis_pct / 100.0
        evicts: List[Tuple[str, int, int]] = []
        admits: List[Tuple[str, int]] = []
        with self.gate:
            hot_map = dict(self._hot)
            free = sorted(self._free)
            for cnt, res in challengers:
                if len(evicts) + len(admits) >= self.max_steals:
                    break
                if res in hot_map or res in self._admitting:
                    continue
                if free:
                    slot = free.pop(0)
                    self._free.discard(slot)
                elif victims and cnt > victims[0][0] * scale:
                    vcnt, victim = victims.pop(0)
                    if victim not in hot_map:
                        continue
                    slot, gen = hot_map.pop(victim)
                    self._generation[slot] = gen + 1
                    self._occupant[slot] = None
                    self._draining.add(slot)
                    evicts.append((victim, slot, gen))
                    self.steals_total += 1
                else:
                    break  # sorted feeds: nothing below can qualify
                self._occupant[slot] = res
                self._admitting.add(res)
                admits.append((res, slot))
            self._hot = hot_map
            self._version += 1
        if evicts or admits:
            self._execute(evicts, admits, now_ms)

    def _evict_storm(self, now_ms: int) -> None:
        """Chaos storm: evict EVERY unpinned occupant this cycle (the
        worst-case churn the conservation invariant must survive)."""
        pinned = self.engine._slot_pinned_resources()
        evicts: List[Tuple[str, int, int]] = []
        with self.gate:
            hot_map = dict(self._hot)
            for res in sorted(hot_map):
                if res in pinned:
                    continue
                slot, gen = hot_map.pop(res)
                self._generation[slot] = gen + 1
                self._occupant[slot] = None
                self._draining.add(slot)
                evicts.append((res, slot, gen))
            self._hot = hot_map
            self._version += 1
        if evicts:
            self._execute(evicts, [], now_ms)

    def _sweep_hot_tallies(self, now_ms: int) -> None:
        """Fold any cold tallies standing for resources that are HOT
        (an in-flight cold entry can tally after its resource was
        re-admitted): a tiny device update keeps total conservation
        exact without waiting for the next evict/rehydrate cycle."""
        with self.gate:
            stale = {res: self._cold.pop(res)
                     for res in [r for r in self._cold if r in self._hot]}
        if not stale:
            return
        eng = self.engine
        with eng._lock, eng._on_stream():
            eng._ensure_compiled()
            totals = eng._state.telemetry.totals
            for res, vec in stale.items():
                cur = self._hot.get(res)
                if cur is None:
                    with self.gate:  # went cold again mid-sweep: put back
                        prev = self._cold.get(res)
                        self._cold[res] = vec if prev is None else prev + vec
                    continue
                totals[:, cur[0]] += torch.from_numpy(vec).to(totals.device)

    # -- the steal/graft surgery ------------------------------------------

    def _execute(self, evicts: List[Tuple[str, int, int]],
                 admits: List[Tuple[str, int]], now_ms: int) -> None:
        """Spill ``evicts``' columns, zero them, graft ``admits``' spill
        records back, publish. Caller has ALREADY swapped the hot map
        (victims unpublished, targets reserved) under ``gate`` and holds
        NO locks here. See the module docstring for why the committer
        flush must happen outside ``engine._lock``."""
        from sentinel_tpu_torch.ops import window as W

        eng = self.engine
        # Everything enqueued under the victims' tenancy lands on device
        # before the surgery reads it (enqueues after the map swap were
        # re-translated under the gate and went cold instead).
        eng._flush_committer()
        records: List[Optional[SpillRecord]] = []
        grafted: List[dict] = []
        with eng._lock, eng._on_stream():
            eng._ensure_compiled()
            state = eng._state
            touched = [s for _, s, _ in evicts] + [s for _, s in admits]
            slots = sorted(set(touched))
            col = {s: k for k, s in enumerate(slots)}
            idx = torch.tensor(slots, dtype=torch.long,
                               device=state.cur_threads.device)
            h, d2h = _gather_columns(state, idx)
            (tb, th, tt, w1c, w1m, w60c, w60m, secc, secm, thr, occ, sa,
             sh) = h["cols"]
            w1s, w60s = h["w1_starts"], h["w60_starts"]
            sec_stamp, occ_stamp = h["sec_stamp"], h["occ_stamp"]

            for res, slot, gen in evicts:
                k = col[slot]
                rec = self._spill_slot(
                    res, k, gen, now_ms, w1c, w1m, w1s, w60c, w60m, w60s,
                    secc, secm, sec_stamp, thr, occ, occ_stamp, tb, th, tt,
                    sa, sh)
                records.append(rec)
                # Zero the victim's columns (the generation firewall:
                # whatever the successor commits, none of this survives).
                w1c[:, :, k] = 0
                w1m[:, k] = int(W.MIN_RT_EMPTY)
                w60c[:, :, k] = 0
                w60m[:, k] = int(W.MIN_RT_EMPTY)
                secc[:, k] = 0
                secm[k] = int(W.MIN_RT_EMPTY)
                thr[k] = 0
                occ[k] = 0
                tb[:, k] = 0
                th[:, k] = 0
                tt[:, k] = 0
                sa[:, k] = 0
                sh[:, k] = 0

            for res, slot in admits:
                with self.gate:
                    rec = self._spill.pop(res, None)
                    cold = self._cold.pop(res, None)
                info = self._graft_slot(
                    res, col[slot], rec, cold, w1c, w1m, w1s, w60c, w60m,
                    w60s, secc, secm, sec_stamp, thr, occ, occ_stamp, tb, th,
                    tt)
                info["slot"] = slot
                grafted.append(info)

            h2d = _scatter_columns(state, idx, h["cols"])
            # Shadow lanes and flight ring: zeroed, never grafted. The
            # rollout guardrail re-baselines, and a ring slot must not
            # carry a prior tenancy's second into the next spill.
            shadow = state.shadow
            if shadow is not None:
                shadow.counts.index_fill_(1, idx, 0)
                shadow.w1.counts.index_fill_(2, idx, 0)
                shadow.w1.min_rt.index_fill_(1, idx, W.MIN_RT_EMPTY)
            flight = state.flight
            if flight is not None:
                for t in (flight.events, flight.attr, flight.hist):
                    t.index_fill_(2, idx, 0)
            self.surgeries_total += 1
            self.surgery_d2h_bytes_total += d2h
            # The columns written back, and the slot index vector.
            self.surgery_h2d_bytes_total += h2d + idx.numel() * 8

        # Publish: store spill records, free fully-drained slots, map
        # the admits in at their slots' CURRENT generation.
        with self.gate:
            for rec in records:
                if rec is None:
                    continue
                self._spill[rec.resource] = rec
                self._spill.move_to_end(rec.resource)
                while len(self._spill) > self.spill_max:
                    self._spill.popitem(last=False)
                    self.spill_dropped_total += 1
            for _, slot, _ in evicts:
                self._draining.discard(slot)
                if self._occupant[slot] is None:
                    self._free.add(slot)
            hot_map = dict(self._hot)
            for res, slot in admits:
                hot_map[res] = (slot, self._generation[slot])
                self._admitting.discard(res)
            self._hot = hot_map
            self._version += 1
            self.evictions_total += len(evicts)
            self.admits_total += len(admits)

        for (res, slot, gen), rec in zip(evicts, records):
            self._emit({"e": "slotEvict", "resource": res, "slot": slot,
                        "gen": gen, "torn": rec is None,
                        "spilledPass": (int(rec.spilled_pass)
                                        if rec is not None else 0),
                        "ms": now_ms})
        for info in grafted:
            self.rehydrations_total += 1
            if not info["fromRecord"]:
                self.rehydrations_cold_total += 1
            info.update(e="slotRehydrate", ms=now_ms,
                        gen=self._generation[info["slot"]])
            self._emit(info)
            self._emit({"e": "slotAdmit", "resource": info["resource"],
                        "slot": info["slot"], "gen": info["gen"],
                        "ms": now_ms})

    def _spill_slot(self, res, slot, gen, now_ms, w1c, w1m, w1s, w60c, w60m,
                    w60s, secc, secm, sec_stamp, thr, occ, occ_stamp, tb,
                    th, tt, sa, sh) -> Optional[SpillRecord]:
        """Extract one victim's columns into a SpillRecord — unless the
        ``slots.spill.torn`` seam tears it (error OR garbage mode), in
        which case the victim's state is dropped on the floor, counted:
        it rehydrates cold, the documented bounded-loud loss."""
        from sentinel_tpu_torch.resilience import faults

        try:
            torn = faults.mutate("slots.spill.torn", b"\x01") != b"\x01"
        except faults.FaultInjected:
            torn = True
        if torn:
            self.spill_torn_total += 1
            return None
        rec = SpillRecord(res, gen, now_ms)
        rec.w1_counts = w1c[:, :, slot].copy()
        rec.w1_min_rt = w1m[:, slot].copy()
        rec.w1_starts = w1s.copy()
        rec.w60_counts = w60c[:, :, slot].copy()
        rec.w60_min_rt = w60m[:, slot].copy()
        rec.w60_starts = w60s.copy()
        rec.sec_counts = secc[:, slot].copy()
        rec.sec_min_rt = int(secm[slot])
        rec.sec_stamp = sec_stamp
        rec.cur_threads = int(thr[slot])
        rec.occupied_next = int(occ[slot])
        rec.occupied_stamp = occ_stamp
        # Cumulative telemetry spills with the live staged second folded
        # in (the staging would otherwise be zeroed un-folded).
        rec.tel_block = tb[:, slot] + sa[:, slot].astype(np.int64)
        rec.tel_hist = th[:, slot] + sh[:, slot].astype(np.int64)
        rec.tel_totals = tt[:, slot].copy()
        rec.spilled_pass = int(tt[int(C.MetricEvent.PASS), slot]
                               + secc[int(C.MetricEvent.PASS), slot])
        return rec

    def _graft_slot(self, res, slot, rec: Optional[SpillRecord], cold,
                    w1c, w1m, w1s, w60c, w60m, w60s, secc, secm, sec_stamp,
                    thr, occ, occ_stamp, tb, th, tt) -> dict:
        """Graft a spill record into a freshly zeroed slot, bucket by
        geometry-checked bucket; fold the resource's cold-tail tallies
        into the totals (exact counter conservation across the cold
        spell). Returns the rehydrate event payload."""
        info = {"resource": res, "slot": slot, "fromRecord": rec is not None,
                "graftedPass": 0, "stalePass": 0,
                "coldPass": int(cold[int(C.MetricEvent.PASS)])
                if cold is not None else 0}
        if rec is not None:
            grafted_pass = 0
            stale_pass = 0
            for i in range(min(len(rec.w1_starts), w1s.shape[0])):
                if rec.w1_starts[i] == w1s[i]:
                    w1c[i, :, slot] = rec.w1_counts[i]
                    w1m[i, slot] = rec.w1_min_rt[i]
                    grafted_pass += int(
                        rec.w1_counts[i][int(C.MetricEvent.PASS)])
                else:
                    stale_pass += int(
                        rec.w1_counts[i][int(C.MetricEvent.PASS)])
            for i in range(min(len(rec.w60_starts), w60s.shape[0])):
                if rec.w60_starts[i] == w60s[i]:
                    w60c[i, :, slot] = rec.w60_counts[i]
                    w60m[i, slot] = rec.w60_min_rt[i]
            if rec.sec_stamp == sec_stamp:
                # The staged second never rolled: restore it — it folds
                # into w60/telemetry on the normal cadence.
                secc[:, slot] = rec.sec_counts
                secm[slot] = rec.sec_min_rt
            else:
                # Its second completed while cold: the minute-window
                # bucket may have rotated, but the COUNTERS must not
                # lose it — fold straight into the cumulative totals.
                tt[:, slot] += rec.sec_counts.astype(np.int64)
            thr[slot] = rec.cur_threads
            if rec.occupied_stamp == occ_stamp:
                occ[slot] = rec.occupied_next
            tb[:, slot] = rec.tel_block
            th[:, slot] = rec.tel_hist
            tt[:, slot] += rec.tel_totals
            info["graftedPass"] = grafted_pass
            info["stalePass"] = stale_pass
        if cold is not None:
            tt[:, slot] += cold
        return info

    # -- checkpoint support ------------------------------------------------

    def checkpoint_dict(self) -> dict:
        """Slot assignment + generations for the checkpoint header. The
        saved device arrays are slot-indexed, so restore needs exactly
        this map to re-bind them. Spill records and cold tallies are
        NOT persisted — the cold tail restarts cold across a process
        restart, the reference's own "restart = cold stats" stance,
        bounded to resources outside the hot set."""
        with self.gate:
            return {
                "budget": self.budget,
                "hot": {res: [sg[0], sg[1]] for res, sg in self._hot.items()},
                "generations": list(self._generation),
            }

    def restore_assignment(self, d: dict) -> None:
        """Re-bind a checkpoint's slot assignment (boot-time only, under
        ``restore_checkpoint``'s fresh-engine guard)."""
        if int(d.get("budget", -1)) != self.budget:
            raise ValueError(
                f"checkpoint slot budget {d.get('budget')} != engine "
                f"slot budget {self.budget}")
        gens = [int(g) for g in d.get("generations", [])]
        if len(gens) != self.budget:
            raise ValueError("checkpoint slot generations length mismatch")
        with self.gate:
            self._generation = gens
            hot: Dict[str, Tuple[int, int]] = {}
            occupant: List[Optional[str]] = [None] * self.budget
            for res, sg in (d.get("hot") or {}).items():
                slot, gen = int(sg[0]), int(sg[1])
                if not FIRST_SLOT <= slot < self.budget \
                        or occupant[slot] is not None:
                    raise ValueError(
                        f"checkpoint slot assignment corrupt at {res!r}")
                hot[res] = (slot, gen)
                occupant[slot] = res
            self._hot = hot
            self._occupant = occupant
            self._free = {s for s in range(FIRST_SLOT, self.budget)
                          if occupant[s] is None}
            self._draining.clear()
            self._admitting.clear()
            self._version += 1

    # -- ops plane ---------------------------------------------------------

    def status(self) -> dict:
        with self.gate:
            cold_mass = {str(k): int(v.sum()) for k, v in
                         list(self._cold.items())[:16]}
            return {
                "budget": self.budget,
                "hot": len(self._hot),
                "free": len(self._free),
                "draining": len(self._draining),
                "pinnedNow": len(self.engine._slot_pinned_resources()),
                "frozen": self._manual_freeze,
                "admitsTotal": self.admits_total,
                "evictionsTotal": self.evictions_total,
                "rehydrationsTotal": self.rehydrations_total,
                "rehydrationsColdTotal": self.rehydrations_cold_total,
                "stealsTotal": self.steals_total,
                "stormsTotal": self.storms_total,
                "hotHitsTotal": self.hot_hits_total,
                "coldPassTotal": self.cold_pass_total,
                "coldBlockTotal": self.cold_block_total,
                "coldUnenforcedTotal": self.cold_unenforced_total,
                "spillTornTotal": self.spill_torn_total,
                "spillDroppedTotal": self.spill_dropped_total,
                "spillRecords": len(self._spill),
                "lateExitsTotal": self.late_exits_total,
                "pinOverflowTotal": self.pin_overflow_total,
                "freezesTotal": self.freezes_total,
                "coldTallyResources": len(self._cold),
                "coldTallySample": cold_mass,
                "hitRate": self.hit_rate(),
            }

    def hit_rate(self) -> float:
        """Measured hot-set hit rate since start: device/lease-hot
        admissions over ALL admissions (the BENCH_19 comparand for the
        telescope's ``population_report`` projection)."""
        hits = self.hot_hits_total
        total = hits + self.cold_pass_total + self.cold_block_total
        return round(hits / total, 6) if total else 1.0

    def note_verdict(self, resource: str, slot: int, gen: int, sec: int,
                     verdict: str, reason: int = 0) -> None:
        """Per-verdict attribution event for the ``slot_conservation``
        invariant (every verdict must land on exactly one live
        (resource, generation) tenancy). No-op without a sink — the hot
        path pays one attribute read."""
        if self.event_sink is None:
            return
        self._emit({"e": "slotVerdict", "resource": resource, "slot": slot,
                    "gen": gen, "sec": sec, "verdict": verdict,
                    "reason": reason})

    def _emit(self, event: dict) -> None:
        sink = self.event_sink
        if sink is not None:
            try:
                sink(event)
            except Exception:  # noqa: BLE001 — observability can't break admission
                pass


class _RuleRegistryView:
    """Duck-typed ``NodeRegistry`` facade for the rule compilers in slot
    mode: resource rows resolve through the slot table (cold -> -1 =
    inert rule slot, which the pin machinery makes a counted anomaly,
    never the steady state); id interning passes through to the real
    registry; the per-(context, resource) / per-origin row kinds have no
    device rows under a slot budget (-1 — CHAIN warm-up sync and
    per-origin statistic rows degrade to the cluster aggregate,
    docs/SEMANTICS.md "Eviction conservation bound")."""

    __slots__ = ("_slots", "_registry")

    def __init__(self, slots: SlotTable):
        self._slots = slots
        self._registry = slots.engine.registry

    def cluster_row(self, resource: str, entry_type: int = 0,
                    resource_type: int = 0) -> int:
        row = self._slots.device_row(resource)
        return row if row is not None else -1

    def origin_id(self, origin: str) -> int:
        return self._registry.origin_id(origin)

    def context_id(self, context: str) -> int:
        return self._registry.context_id(context)

    def default_row(self, context: str, resource: str,
                    parent_row: int) -> int:
        return -1

    def entrance_row(self, context: str) -> int:
        return -1

    def origin_row(self, resource: str, origin: str) -> int:
        return -1



def _row_tensors(state) -> list:
    """The per-row state tensors a surgery reads and rewrites, row axis
    last, in the order ``_execute`` unpacks them. The int64 cumulative
    telemetry comes first, so every int64 part of a packed buffer starts
    on an even int32 word."""
    tel = state.telemetry
    return [tel.block_by_reason, tel.rt_hist, tel.totals,
            state.w1.counts, state.w1.min_rt, state.w60.counts,
            state.w60.min_rt, state.sec.counts, state.sec.min_rt,
            state.cur_threads, state.occupied_next, tel.stage_attr,
            tel.stage_hist]


def _words(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat int32 tensor (int64 as word pairs)."""
    return t.contiguous().reshape(-1).view(torch.int32)


def _unpack(host: np.ndarray, like: list) -> list:
    """Split a packed int32 buffer back into arrays shaped and typed like
    the tensors in ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * (2 if t.dtype == torch.int64 else 1)
        words = host[off:off + n]
        off += n
        arr = words.view(np.int64) if t.dtype == torch.int64 else words
        out.append(arr.reshape(tuple(t.shape)))
    return out


def _gather_columns(state, idx: torch.Tensor):
    """The touched columns of every per-row tensor, plus the window
    starts and the two stamps, in ONE device-to-host copy. Returns
    (host arrays, bytes moved): ``cols`` in ``_row_tensors`` order with
    the row axis cut to ``idx``."""
    parts = [t.index_select(t.dim() - 1, idx) for t in _row_tensors(state)]
    stamps = [state.w1.starts, state.w60.starts,
              state.sec.stamp.reshape(1), state.occupied_stamp.reshape(1)]
    # int64 parts (telemetry columns, then the stamps) lead the buffer.
    like = parts[:3] + stamps + parts[3:]
    host = torch.cat([_words(t) for t in like]).cpu().numpy()
    out = _unpack(host, like)
    w1s, w60s, sec_stamp, occ_stamp = out[3:7]
    return {"cols": out[:3] + out[7:], "w1_starts": w1s, "w60_starts": w60s,
            "sec_stamp": int(sec_stamp[0]),
            "occ_stamp": int(occ_stamp[0])}, host.nbytes


def _scatter_columns(state, idx: torch.Tensor, cols) -> int:
    """Write the surgery's columns back in ONE host-to-device copy and
    ``index_copy_`` them into every per-row tensor; returns the bytes
    moved."""
    tensors = _row_tensors(state)
    words = np.concatenate([
        np.ascontiguousarray(c).reshape(-1).view(np.int32) for c in cols])
    dev = torch.from_numpy(words).to(idx.device)
    off = 0
    for t, c in zip(tensors, cols):
        n = c.size * (2 if c.dtype == np.int64 else 1)
        part = dev[off:off + n]
        off += n
        if t.dtype == torch.int64:
            part = part.view(torch.int64)
        t.index_copy_(t.dim() - 1, idx, part.reshape(c.shape))
    return words.nbytes
