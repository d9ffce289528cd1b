"""The host engine: the entry/exit API over the fused device step (port of
``sentinel_tpu/core/engine.py``, its width-1 main path).

It owns the node registry, the compiled rule tensors and the device state.
Each ``entry()`` resolves the call context, runs the SPI host slots, and
then takes one of three paths, in the reference's order:

  1. a lease-eligible resource is admitted on the host
     (``core/lease.py``) and its statistics stream to the device through
     the background ``StatsCommitter``;
  2. a resource with no rules at all passes, its statistics streamed the
     same way (the unruled fast path);
  3. everything else runs one width-1 ``entry_step`` on the device and
     raises a typed ``BlockException``, sleeps a paced wait, or passes.

The fast-path state (leases, guarded set, unruled flag) is rebuilt on
every rule push under a config lock separate from the engine lock, so a
push never waits on a device dispatch. The readers (``seal_metrics``,
``row_stats``, ``tree_dict``, ``node_snapshot``) flush the committer first.
The batch API (``check_batch`` / ``complete_batch`` /
``harvest_decisions``) runs the step on caller-built batches.

``start_pipeline()`` switches to micro-batched admission
(``core/pipeline.py``): a collector thread folds concurrent callers'
entries and exits into one step per cycle. While it runs, every guarded
and unruled entry goes to the device (the leases and the unruled pass
stand down), as in the reference. Every dispatch is timed
(``step_timer``, ``metrics/profiling.py``) and every entry dispatch hands
its verdicts to the decision-trace pump (``traces``,
``telemetry/trace_ring.py``). ``set_window_geometry`` and ``set_clock``
retune the instant window and swap the timebase at runtime.

The once-per-second fold: the state carries the flight-recorder ring by
default (``csp.sentinel.telemetry.timeseries.seconds``, 128), written by
the step at each second's fold; ``_spill_flight`` (run by
``timeseries_view`` and ``population_report``) gathers the fresh ring
slots into the host history (``telemetry/timeseries.py``), renders each
fresh second into the SLO manager (``slo/``), evaluates the burn rules,
seals the latency waterfall (``telemetry/waterfall.py``), rolls the
namespace telescope (``telemetry/population.py``, fed from every entry
dispatch), runs the slot table's rebalance, and ticks the adaptive loop
(``adaptive/``), which acts only through the rollout manager.
``slo_refresh`` runs the fold on demand.

The control plane: ``engine.journal`` (``telemetry/journal.py``) records
every rule load, rollout transition, SLO transition, adaptive decision,
cluster role flip and clock swap; ``why_query`` and ``explain_trace``
join those records and the sampled traces with the recorded seconds.
``engine.fleet`` holds a ``FleetView`` the engine watches, when one is
attached.

Slot mode (``SentinelEngine(slot_budget=N)``, or
``csp.sentinel.slots.budget``): the device state has N rows and the slot
table (``core/slots.py``) maps the live hot set into them, evicting and
rehydrating columns of the state; cold resources degrade to counted
host-side passes (host-exact for leaseable rules). Slot mode runs without
the pipeline, as in the reference.

Boot and restart: the instant window's geometry and the occupy cap are
seeded from config (``csp.sentinel.statistic.interval.ms`` /
``.sample.count``, ``csp.sentinel.occupy.timeout.ms``) and retuned through
``window_geometry_property`` / ``occupy_timeout_property``;
``core/checkpoint.py`` saves the statistics and restores them into a fresh
engine. SPI device checkers (``core/spi.py``) ride every entry dispatch,
read again after each (un)registration.

Staged rollout (``rollout/``): ``engine.rollout`` (a ``RolloutManager``)
stages a candidate ruleset, loaded through it or pushed as rules tagged
``candidateSet``. While one holds the device, the engine compiles the
merged candidate pack beside the live one (``_compile_shadow``), the
state carries its shadow world, every entry dispatch evaluates it (and
enforces it for the canary slice) and every exit dispatch feeds it; the
leases and the unruled pass stand down, so every entry reaches the step.
``shadow_counts()`` reads its counters.

The cluster token check: ``engine.cluster`` (a ``ClusterStateManager``)
makes the engine a token client or an embedded token server
(``cluster/``). Entries on resources with cluster-mode rules ask the
token server first (``_cluster_token_check``), under one deadline budget
per entry (``csp.sentinel.resilience.cluster.entry.budget.ms``); its
verdict masks the cluster rules out of the local check or pre-blocks the
entry, and a failed or shed acquire falls back to the local check where
the rule asks for it, counted in ``resilience_stats()``. Every Nth such
entry carries a trace context over the wire, and its stitched spans land
in ``engine.spans``.

``engine.rebalancer`` (``cluster/rebalance.py``) governs shard placement
when ``engine.cluster.ha`` follows shard maps; ``set_clock`` resets its
cooldown ledger and abort backoff with the other timebases.

LLM admission (``llm/``): ``engine.tps_rules`` lowers tokens-per-second
rules onto flow rules on ``llm:<model>``; ``stream_open`` /
``stream_tick`` / ``stream_close`` run streaming reservations on the
host ledger ``engine.streams``, debiting tokens through ``entry`` (so on
the card through the fused step and its prefix kernel), and the fold
evicts idle leases.

Device: ``cuda`` unless the caller passes ``device="cpu"``; with no card
and no explicit device the constructor raises. On ``cuda`` the
segmented-prefix kernel is built at construction, so a build failure
raises here and not in the first ``entry()``. Every dispatch and every
read of the state runs on ONE stream, the device's default stream, made
current in whichever thread dispatches (callers, the stats committer,
the pipeline's collector), so the steps on the shared state tensors are
ordered by the stream alone.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core import context as ctx_mod
from sentinel_tpu_torch.core import spi as spi_mod
from sentinel_tpu_torch.core.batch import (
    BATCH_WIDTHS, MAX_PARAMS, Decisions, EntryBatch, ExitBatch,
    batch_to, make_entry_batch_np, make_exit_batch_np, stage_row,
    to_device)
from sentinel_tpu_torch.core.config import (
    DEFAULT_PROFILE_SYNC_EVERY, DEFAULT_RESILIENCE_ENTRY_BUDGET_MS,
    DEFAULT_TELEMETRY_TIMESERIES_HISTORY,
    DEFAULT_TELEMETRY_TIMESERIES_SECONDS, OCCUPY_TIMEOUT_MS,
    PROFILE_SYNC_EVERY, RESILIENCE_ENTRY_BUDGET_MS, STATISTIC_INTERVAL_MS,
    STATISTIC_SAMPLE_COUNT, TELEMETRY_TIMESERIES_HISTORY,
    TELEMETRY_TIMESERIES_SECONDS, config)
from sentinel_tpu_torch.core.exceptions import (
    BlockException, FlowException, exception_for_reason)
from sentinel_tpu_torch.core.property import (
    DynamicSentinelProperty, SimplePropertyListener)
from sentinel_tpu_torch.core.registry import (
    KIND_CLUSTER, ROOT_ROW, NodeRegistry)
from sentinel_tpu_torch.llm import rules as LR
from sentinel_tpu_torch.llm.streams import StreamLedger
from sentinel_tpu_torch.log.record_log import log_block, record_log
from sentinel_tpu_torch.metrics import profiling as _prof
from sentinel_tpu_torch.metrics.profiling import StepTimer, timed_call
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.native import load_lease_ext
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.resilience.budget import DeadlineBudget
from sentinel_tpu_torch.telemetry.population import PopulationTracker
from sentinel_tpu_torch.telemetry.spans import Span, SpanCollector
from sentinel_tpu_torch.telemetry.timeseries import (
    TimeseriesHistory, compact_second, page_newest_first, second_to_dict)
from sentinel_tpu_torch.telemetry.trace_ring import DecisionTraceBuffer
from sentinel_tpu_torch.utils import time_util
from sentinel_tpu_torch.utils.device import resolve_device, to_host
from sentinel_tpu_torch.utils.param_hash import hash_param

_hash_param = hash_param  # the reference engine's name for it

# Per-family slot-count floors at construction (the JAX engine's values).
INITIAL_SLOT_FLOOR = {"flow": 1, "degrade": 0, "authority": 0, "param": 0}


class DeviceDispatchError(RuntimeError):
    """A device step failed after it may have consumed the state. The
    raising site has already dropped the engine to a cold state (rules
    durable, stats ephemeral); the width-1 entry path fails open and
    counts it (``fail_open_count``), batch-API callers see this error."""


class _StagedVerdicts:
    """A dispatched step's (reason, wait_us) on their way to the host: on
    CUDA, pinned host tensors filled by non-blocking copies and the event
    recorded after them; on the CPU, the step's own tensors."""

    __slots__ = ("reason", "wait_us", "event")

    def __init__(self, reason, wait_us, event):
        self.reason = reason
        self.wait_us = wait_us
        self.event = event


_RLock = type(threading.RLock())


class _LockTake:
    """``with`` the engine lock as it stands (``engine._lock``, which a
    measuring caller may wrap). While the span recorder is on, a take of
    the plain lock tries without blocking first, and only a take that has
    to wait reads the clock: a ``name`` span."""

    __slots__ = ("_engine", "_name")

    def __init__(self, engine, name: str):
        self._engine = engine
        self._name = name

    def __enter__(self) -> None:
        lock = self._engine._lock
        if _prof.recorder is None or type(lock) is not _RLock:
            lock.__enter__()
        elif not lock.acquire(blocking=False):
            with _prof.span(self._name):
                lock.acquire()

    def __exit__(self, *exc) -> bool:
        return self._engine._lock.__exit__(*exc)


class _FastPathState:
    """One atomically-swapped snapshot of the host fast-path config:
    entry() reads a single attribute, so a rule push can never expose a
    torn (leases, guarded, unruled) combination to a lock-free reader."""

    __slots__ = ("leases", "guarded", "unruled")

    def __init__(self, leases, guarded, unruled):
        self.leases = leases
        self.guarded = guarded
        self.unruled = unruled


class EntryHandle:
    """A live entry (reference: ``CtEntry``). Use as a context manager."""

    __slots__ = (
        "engine", "resource", "context", "cluster_row", "dn_row",
        "origin_row", "entry_in", "count", "created_ms", "error", "exited",
        "params", "leased", "slot_gen",
    )

    def __init__(self, engine, resource, context, cluster_row, dn_row,
                 origin_row, entry_in, count, params, leased=False,
                 now_ms=None):
        self.engine = engine
        self.resource = resource
        self.context = context
        self.cluster_row = cluster_row
        self.dn_row = dn_row
        self.origin_row = origin_row
        self.entry_in = entry_in
        self.count = count
        # Callers on the µs-scale fast path pass the clock they already
        # read; everyone else pays the read here.
        self.created_ms = engine.now_ms() if now_ms is None else now_ms
        self.error = False
        self.exited = False
        self.params = params
        self.leased = leased
        # Slot mode: the tenancy generation the entry committed under, or
        # slots.COLD_GEN for a cold-path entry; -1 outside slot mode.
        self.slot_gen = -1

    def trace(self, ex: Optional[BaseException] = None) -> None:
        """Record a business exception (reference: ``Tracer.trace``)."""
        if ex is None or not BlockException.is_block_exception(ex):
            self.error = True

    def exit(self, count: Optional[int] = None) -> None:
        if self.exited:
            return
        self.exited = True
        self.engine._do_exit(self, count if count is not None else self.count)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and not BlockException.is_block_exception(exc):
            self.trace(exc)
        self.exit()
        return False


class SentinelEngine:
    """Owns the device state and compiled rules.

    Lock order is config -> engine: ``_config_lock`` serializes rule
    pushes and ``close()``; ``_lock`` serializes device steps and reads of
    the state. Never take ``_config_lock`` while holding ``_lock``.
    """

    def __init__(self, capacity: int = 4096, device=None, clock=None,
                 journal_path: Optional[str] = None,
                 slot_budget: int = 0):
        self.device = resolve_device(device)
        # The one stream every dispatch and state read runs on (None on
        # the CPU).
        self._stream = None
        if self.device.type == "cuda":
            from sentinel_tpu_torch.ops import prefix_cuda

            prefix_cuda.build()
            self._stream = torch.cuda.default_stream(self.device)
        # Slot mode: slot_budget > 0 (or csp.sentinel.slots.budget) bounds
        # the device state to ``budget`` rows and maps the live hot set
        # into them (core/slots.py); the registry keeps the larger
        # name table. 0 = fixed-capacity mode.
        if not slot_budget:
            slot_budget = config.slots_budget()
        if slot_budget:
            from sentinel_tpu_torch.core.slots import SlotTable

            self.registry = NodeRegistry(config.slots_registry_capacity())
            self.capacity = int(slot_budget)
            self.slots = SlotTable(self, int(slot_budget))
        else:
            self.registry = NodeRegistry(capacity)
            self.capacity = capacity
            self.slots = None
        # None = the process clock (time_util, which tests may freeze); a
        # callable = this engine's private timebase.
        self._clock = clock
        self._seed_window_config()
        # Global kill switch (reference: Constants.ON). Off => every entry
        # passes unguarded.
        self.enabled = True
        self.system_status = Y.SystemStatusListener()
        self._signals_refreshed_ms = 0
        self._sealed_sec = self.now_ms() // 1000 - 1
        # Control-plane audit journal (telemetry/journal.py): every rule,
        # SLO and target load, rollout transition, cluster role flip,
        # adaptive decision and clock swap appends one seq-numbered,
        # causally linked record, stamped on now_ms(). Built first among
        # the observability surfaces: the rule managers, rollout, SLO,
        # adaptive and cluster layers below write through it, and the SLO
        # and adaptive logs restore from a file-backed one. journal_path:
        # None = csp.sentinel.journal.path, "" = memory-only.
        from sentinel_tpu_torch.telemetry.journal import ControlPlaneJournal

        self.journal = ControlPlaneJournal(self.now_ms, path=journal_path)
        # Fleet federation (telemetry/fleet.py): a FleetView collector
        # this engine watches through (None = not watching).
        self.fleet = None
        # Entries that passed UNGUARDED because a device step failed.
        self.fail_open_count = 0
        self._fail_open_logged_ms = 0
        # Token-lease fast path (core/lease.py): host-admitted resources +
        # the async stats committer, rebuilt on every rule push. The C
        # ring builds here, never under the config lock of a push.
        self.lease_enabled = config.lease_enabled()
        if self.lease_enabled:
            load_lease_ext()
        self._fastpath = _FastPathState({}, frozenset(), self.lease_enabled)
        self._committer = None
        self._closed = False
        self._lock = threading.RLock()
        self._config_lock = threading.RLock()
        self._step_seq = 0  # device steps dispatched, under the lock
        # The lock's takes on the batch path and by the seal.
        self._batch_lock = _LockTake(self, "lock_wait")
        self._seal_lock = _LockTake(self, "seal.lock_wait")
        self._state: Optional[S.SentinelState] = None
        self._rules: Optional[S.RulePack] = None
        self._named_origins: Dict[str, set] = {}
        self._slot_floor = dict(INITIAL_SLOT_FLOOR)
        self._dirty = {k: False for k in ("flow", "degrade", "authority",
                                          "system", "param", "rollout")}
        self._spi = spi_mod
        # The SPI device checkers spliced into every entry step, and the
        # registration version they were read at (-1: read at the first
        # _ensure_compiled).
        self._spi_version = -1
        self._checkers: Tuple = ()
        # The step functions, as attributes so a test can poison one (the
        # reference's ``_entry_jit`` / ``_exit_jit``).
        self._entry_step = S.entry_step
        self._exit_step = S.exit_step
        # Per-step timing: enqueue wall per dispatch, and a synchronous
        # wall every ``csp.sentinel.profile.syncEvery``-th one.
        sync_every = config.get_int(PROFILE_SYNC_EVERY,
                                    DEFAULT_PROFILE_SYNC_EVERY)
        if sync_every <= 0:
            record_log.warn("invalid %s=%s; using default %d",
                            PROFILE_SYNC_EVERY, sync_every,
                            DEFAULT_PROFILE_SYNC_EVERY)
            sync_every = DEFAULT_PROFILE_SYNC_EVERY
        self.step_timer = StepTimer(sync_every=sync_every)
        # Sampled decision traces, pulled off the device by a daemon pump.
        self.traces = DecisionTraceBuffer(self)
        # Flight recorder: the device ring's length (0 = no ring tensors)
        # and the compacted host history it spills into on reads; tees get
        # each freshly spilled second rendered by ``second_to_dict``.
        self.flight_seconds = max(0, config.get_int(
            TELEMETRY_TIMESERIES_SECONDS,
            DEFAULT_TELEMETRY_TIMESERIES_SECONDS))
        self.timeseries = TimeseriesHistory(config.get_int(
            TELEMETRY_TIMESERIES_HISTORY,
            DEFAULT_TELEMETRY_TIMESERIES_HISTORY))
        self._flight_tees: List = []
        # SLO engine (slo/): burn-rate objectives, anomaly baselines and
        # health scores over the complete seconds the fold spills.
        from sentinel_tpu_torch.slo.manager import SloManager

        self.slo = SloManager(self)
        # Latency waterfall: per-stage log2 histograms sealed by the fold;
        # built after slo (its sentry fires through
        # slo.external_transition).
        from sentinel_tpu_torch.telemetry.waterfall import WaterfallRecorder

        self.waterfall = WaterfallRecorder(self)
        # Namespace telescope, fed from every entry dispatch and rolled by
        # the spill fold.
        self.population = PopulationTracker(self)
        # Pipelined admission (core/pipeline.py) and its counters summed
        # over pipeline generations (the live Pipeline dies with
        # stop_pipeline; the totals stay monotone).
        self._pipeline = None
        self._pipeline_totals = {
            "cycles": 0, "batched": 0, "harvests": 0, "failOpenCycles": 0,
            "inflightDepthMax": 0, "poolAllocated": 0, "poolReused": 0,
        }
        # Guards the totals fold and the retiring hand-off, so a stats read
        # during stop_pipeline() never sees a counter dip. Not the engine
        # lock: stats reads must not wait behind a dispatch.
        self._pipeline_stats_lock = threading.Lock()
        self._retiring_pipeline = None
        # Cluster role (client / embedded server); servers it starts serve
        # THIS engine's bridge and run on its device. Host-side maps from
        # resource to its cluster-mode rules' (flowId, fallbackToLocal
        # [, paramIdx]), and flowId -> (threshold, windowIntervalMs) of
        # the local copies (the degraded-quota share base), replaced
        # wholesale on every flow / param load.
        from sentinel_tpu_torch.cluster.state import ClusterStateManager

        self.cluster = ClusterStateManager()
        # Role flips journal through this engine's journal.
        self.cluster.journal = self.journal
        self.cluster.engine = self
        self._cluster_flow_info: Dict[str, list] = {}
        self._cluster_param_info: Dict[str, list] = {}
        self._cluster_thresholds: Dict[int, tuple] = {}
        # How often cluster-mode rules degraded to their local fallback,
        # how often the per-entry budget ran out, and the acquires the
        # token server shed (OVERLOADED) or mis-routed (WRONG_SLICE).
        self.cluster_fallback_count = 0
        self.cluster_budget_exhausted_count = 0
        self.cluster_overload_count = 0
        self.cluster_wrong_slice_count = 0
        self.cluster_entry_budget_ms = config.get_int(
            RESILIENCE_ENTRY_BUDGET_MS, DEFAULT_RESILIENCE_ENTRY_BUDGET_MS)
        if self.cluster_entry_budget_ms <= 0:
            record_log.warn("invalid %s=%s; using default %dms",
                            RESILIENCE_ENTRY_BUDGET_MS,
                            self.cluster_entry_budget_ms,
                            DEFAULT_RESILIENCE_ENTRY_BUDGET_MS)
            self.cluster_entry_budget_ms = DEFAULT_RESILIENCE_ENTRY_BUDGET_MS
        # Cross-process spans: every Nth cluster-checked entry carries a
        # trace context over the token-server wire.
        self.spans = SpanCollector()
        self.flow_rules = F.FlowRuleManager()
        self.degrade_rules = D.DegradeRuleManager()
        self.authority_rules = A.AuthorityRuleManager()
        self.system_rules = Y.SystemRuleManager()
        self.param_rules = P.ParamFlowRuleManager()
        for family, mgr in (("flow", self.flow_rules),
                            ("degrade", self.degrade_rules),
                            ("authority", self.authority_rules),
                            ("system", self.system_rules),
                            ("param", self.param_rules)):
            mgr.add_listener(lambda f=family: self._mark_dirty(f))
        # LLM admission (llm/): the TPS family LOWERS onto flow rules, so
        # the device gains no rule pack of its own; the listener strips
        # the previously derived rules and re-injects the fresh lowering.
        # The streaming-reservation ledger is host state on the engine's
        # timebase, evicted on the fold.
        self.tps_rules = LR.TpsRuleManager()
        self.tps_rules.add_listener(self._on_tps_rules_changed)
        self._llm_max_streams: Dict[str, int] = {}
        self._llm_window_budget: Dict[str, float] = {}
        self._llm_default_estimate = config.llm_default_estimate_tokens()
        self.streams = StreamLedger(
            capacity=config.llm_max_streams(),
            idle_evict_ms=config.llm_idle_evict_ms(),
            window_ms=self._spec1.interval_ms)
        # Staged rollout: the compiled candidate pack and the canary
        # scalars live here; the manager owns the lifecycle and the
        # guardrail. Built after the rule managers (it reads their staged
        # partitions).
        from sentinel_tpu_torch.rollout.manager import RolloutManager

        self._shadow_rules: Optional[S.RulePack] = None
        self._canary_bps: Optional[int] = None
        self._canary_salt = 0
        self.rollout = RolloutManager(self)
        # Closed-loop adaptive limiting: built after rollout (it registers
        # a lifecycle listener) and slo (its senses read judgement); it
        # ticks on the fold and acts only through the rollout manager.
        from sentinel_tpu_torch.adaptive.loop import AdaptiveLoop

        self.adaptive = AdaptiveLoop(self)
        # Governed shard placement (cluster/rebalance.py): senses the
        # fleet plane, proposes minimal-movement map diffs, certifies
        # them on a chaos mesh on this engine's device, and applies
        # through the journal-audited HA path. Pure control plane — no
        # background thread and nothing on the step.
        from sentinel_tpu_torch.cluster.rebalance import ShardRebalancer

        self.rebalancer = ShardRebalancer(self)

    def _seed_window_config(self) -> None:
        """Seed the instant-window geometry (reference: ``IntervalProperty``
        / ``SampleCountProperty``) and the prioritized-borrow wait cap
        (``OccupyTimeoutProperty``) from config, before any state or lease
        mirror exists; a bad value warns and falls back, so it cannot brick
        boot. Both are runtime-tunable through ``set_window_geometry`` /
        ``set_occupy_timeout`` and their push-property forms::

            engine.window_geometry_property.update_value(
                {"intervalMs": 2000, "sampleCount": 4})
            engine.occupy_timeout_property.update_value(250)
        """
        interval = config.get_int(STATISTIC_INTERVAL_MS, C.SECOND_WINDOW_MS)
        samples = config.get_int(STATISTIC_SAMPLE_COUNT, C.SECOND_BUCKETS)
        if interval <= 0 or samples <= 0 or interval % samples != 0:
            # The validation set_window_geometry enforces (a sample count
            # of 0 would divide by zero on the first rotate).
            record_log.warn("invalid csp.sentinel.statistic geometry "
                            "%sms/%s; using defaults", interval, samples)
            interval, samples = C.SECOND_WINDOW_MS, C.SECOND_BUCKETS
        self._spec1 = W.WindowSpec(interval, samples)
        self.window_geometry_property = DynamicSentinelProperty()
        self.window_geometry_property.add_listener(SimplePropertyListener(
            lambda v: self.set_window_geometry(
                v.get("intervalMs"), v.get("sampleCount"))))
        occupy = config.get_int(OCCUPY_TIMEOUT_MS,
                                C.DEFAULT_OCCUPY_TIMEOUT_MS)
        if not 0 <= occupy <= interval:
            record_log.warn(
                "invalid csp.sentinel.occupy.timeout.ms %s (window %sms); "
                "using default", occupy, interval)
            occupy = min(C.DEFAULT_OCCUPY_TIMEOUT_MS, interval)
        self._occupy_timeout_ms = occupy
        self.occupy_timeout_property = DynamicSentinelProperty()
        self.occupy_timeout_property.add_listener(SimplePropertyListener(
            lambda v: self.set_occupy_timeout(int(v))))

    # -- clock / signals -----------------------------------------------------

    def now_ms(self) -> int:
        clock = self._clock
        return int(clock()) if clock is not None else \
            time_util.current_time_millis()

    def set_clock(self, clock) -> None:
        """Install (or clear, with None) an injected clock, resetting the
        engine's time cursors and its volatile statistics to the new
        timebase.

        The cursors assume time never moves backward: ``_sealed_sec``
        gates the metric log, ``timeseries.last_stamp_ms`` gates the
        flight-recorder spill, and the signal and fail-open-log throttles
        hold last-read stamps. A timebase earlier than the old one would
        wedge them. The device state is dropped cold for the same reason
        (window bucket starts and the staged second carry old stamps);
        rules survive, statistics restart on the next dispatch. The lease
        mirrors carry old stamps too: the fast path swaps to empty first,
        so the rebuild starts every mirror cold."""
        with self._config_lock, self._lock:
            self._clock = clock
            now = self.now_ms()
            self._sealed_sec = now // 1000 - 1
            self._signals_refreshed_ms = 0
            self._fail_open_logged_ms = 0
            self._state = None  # _ensure_compiled rebuilds it
            self.timeseries.clear()
            self._fastpath = _FastPathState({}, frozenset(),
                                            self.lease_enabled)
            self._rebuild_leases()
        # Stamp-bearing subsystem cursors reset outside the engine locks
        # (each takes its own; the order is adaptive/slo -> engine): the
        # SLO cursors, series, baselines and alerts, the adaptive loop's
        # backoff and cooldown stamps, the rebalancer's cooldown ledger
        # and abort backoff, the waterfall's staged seconds, and
        # the telescope's open churn window.
        self.slo.reset_timebase()
        self.adaptive.reset_timebase()
        self.rebalancer.reset_timebase()
        self.waterfall.reset_timebase()
        self.population.reset_timebase()
        # The swap itself, stamped on the NEW timebase (seq stays
        # monotone even where timestamps step backward).
        self.journal.record("clockSwap", injected=clock is not None)

    def add_flight_tee(self, fn) -> None:
        """Subscribe ``fn(second_dict)`` to every freshly spilled complete
        flight-recorder second."""
        self._flight_tees.append(fn)

    def remove_flight_tee(self, fn) -> None:
        try:
            self._flight_tees.remove(fn)
        except ValueError:
            pass

    def _on_stream(self):
        """Make the engine's stream current for a dispatch or a read."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _maybe_start_system_listener(self) -> None:
        def is_set(v):
            return v is not None and v >= 0

        if any(is_set(r.highest_system_load) or is_set(r.highest_cpu_usage)
               for r in self.system_rules.get_rules()):
            self.system_status.start()

    def _refresh_signals(self, now_ms: int) -> None:
        """Fold the latest host OS sample into device state (≤ 1 Hz). A
        clock that stepped backward refreshes at once."""
        if 0 <= now_ms - self._signals_refreshed_ms < 1000:
            return
        self._signals_refreshed_ms = now_ms
        self._state = self._state._replace(sys_signals=torch.from_numpy(
            self.system_status.snapshot()).to(self.device))

    @property
    def state(self) -> Optional[S.SentinelState]:
        return self._state

    @property
    def rules(self) -> Optional[S.RulePack]:
        return self._rules

    # -- fast path -----------------------------------------------------------

    @property
    def _leases(self):
        return self._fastpath.leases

    @property
    def _guarded_resources(self):
        return self._fastpath.guarded

    @property
    def _unruled_fastpath(self):
        return self._fastpath.unruled

    @property
    def lease_ring(self) -> str:
        """Which ring plain leases run: ``"native"`` (the C extension) or
        ``"python"`` (``LocalLease``'s own ring)."""
        return "native" if load_lease_ext() is not None else "python"

    @property
    def committer(self):
        """The live stats committer, or None before the first fast-path
        entry and after ``close()``."""
        return self._committer

    def _rebuild_leases(self) -> None:
        """Recompute the token-lease table from the current rules.

        Mirrors must NOT reset to zero on a rule push: re-granting quota
        already spent this window would double-admit. Surviving resources
        carry their mirror over; newly eligible ones seed from the device
        window plus the queued commits."""
        from sentinel_tpu_torch.core.lease import build_lease_table

        if self._closed:
            return  # a straggler push must not resurrect the fast path
        old = self._leases
        if self.lease_enabled:
            new, guarded, unruled_ok = build_lease_table(self)
        else:
            new, guarded, unruled_ok = {}, set(), False
        fresh = []
        for res, lease in new.items():
            prev = old.get(res)
            if prev is not None and prev.buckets == lease.buckets \
                    and prev.bucket_ms == lease.bucket_ms:
                lease.seed(*prev.snapshot())
            else:
                fresh.append(res)
        if fresh:
            self._seed_leases_into(new, fresh)
        self._fastpath = _FastPathState(new, guarded, unruled_ok)

    def _ensure_committer(self):
        committer = self._committer
        if committer is None:
            from sentinel_tpu_torch.core.lease import (StatsCommitter,
                                                       SyncCommitter)

            with self._lock:
                if self._closed:
                    # An entry racing close() read the fast path before the
                    # swap: commit inline rather than restart the thread.
                    return SyncCommitter(self)
                if self._committer is None:
                    self._committer = StatsCommitter(self).start()
                committer = self._committer
        return committer

    def _flush_committer(self) -> None:
        """Drain pending leased commits so reads are deterministic."""
        committer = self._committer
        if committer is not None:
            committer.flush()

    def _seed_leases_from_state(self) -> None:
        """Adopt the device windows into every lease mirror (the
        checkpoint's warm restart)."""
        table = self._leases
        self._seed_leases_into(table, list(table))

    def _seed_leases_into(self, table, targets) -> None:
        """Seed ``targets``' mirrors in ``table`` from the device window
        PLUS the un-flushed committer commits. Flushing here would
        deadlock against the background flush, which takes the engine
        lock a caller may hold: so count, don't flush. A resource with no
        registry row never served traffic and stays empty."""
        targets = [res for res in targets if res in table]
        if not targets:
            return
        with self._lock, self._on_stream():
            state = self._state
            if state is not None:
                pass_counts = state.w1.counts[:, C.MetricEvent.PASS, :] \
                    .cpu().numpy()
                starts = state.w1.starts.cpu().numpy()
            rows = {}
            for res in targets:
                row = self._device_row_of(res)
                if row is not None:
                    rows[res] = row
        committer = self._committer
        pending = committer.pending_pass_counts() if committer else {}
        now = self.now_ms()
        for res in targets:
            if res not in rows:
                continue
            lease = table[res]
            if state is not None:
                lease.seed(starts, pass_counts[:, rows[res]])
            queued = pending.get(rows[res], 0)
            if queued:
                lease.add(queued, now)

    # -- rule compilation --------------------------------------------------

    def _mark_dirty(self, family: str) -> None:
        # Config lock, NOT the engine lock: the dirty flag hand-off is a
        # GIL-atomic dict write read under the engine lock on the next
        # dispatch, and the lease rebuild must not queue behind a step.
        with self._config_lock:
            self._dirty[family] = True
            # Tagged rules stage (or update, or end) a candidate before the
            # leases rebuild, so the fast path sees the rollout's gate.
            self._sync_rollout_sources()
            if family == "flow":
                rules = self.flow_rules.get_rules()
                # entry() reads the named-origin map before any compile,
                # and the cluster maps lock-free.
                self._named_origins = F.named_origin_map(rules, self.registry)
                self._cluster_flow_info = self._cluster_info(rules)
                self._cluster_thresholds = self._cluster_threshold_map(rules)
            elif family == "param":
                self._cluster_param_info = self._cluster_info(
                    self.param_rules.get_rules(), with_param_idx=True)
            self._rebuild_leases()
        self._slots_sync_pins()
        self._journal_rule_load(family)

    def _journal_rule_load(self, family: str) -> None:
        """One ``ruleLoad`` record per family load: who pushed (the
        ``acting()`` provenance), what is now in force (rule dicts,
        capped) and what caused it (a promotion's ``causing()`` seam).
        Runs outside the config lock: the journal's fsync must not
        lengthen the time a push holds the config plane."""
        from sentinel_tpu_torch.datasource import converters as CV
        from sentinel_tpu_torch.telemetry.journal import MAX_RULES_PER_RECORD

        mgr, to_dict = {
            "flow": (self.flow_rules, CV.flow_rule_to_dict),
            "degrade": (self.degrade_rules, CV.degrade_rule_to_dict),
            "authority": (self.authority_rules, CV.authority_rule_to_dict),
            "system": (self.system_rules, CV.system_rule_to_dict),
            "param": (self.param_rules, CV.param_rule_to_dict),
            "tps": (self.tps_rules, CV.tps_rule_to_dict),
        }[family]
        rules = list(mgr.get_rules())
        dicts = []
        for r in rules[:MAX_RULES_PER_RECORD]:
            try:
                dicts.append(to_dict(r))
            except Exception:  # noqa: BLE001 — audit must not break loads
                dicts.append({"resource": getattr(r, "resource", None)})
        self.journal.record(
            "ruleLoad", family=family, count=len(rules), rules=dicts,
            rulesTruncated=len(rules) > MAX_RULES_PER_RECORD)

    def _on_tps_rules_changed(self) -> None:
        """TPS loads LOWER onto the flow family (``llm/rules.py``): strip
        the previously derived rules, re-inject the fresh lowering, keep
        every operator rule (live and staged). The flow load fires the
        flow listener, so tensors, leases and cluster maps rebuild with no
        TPS-specific compile. An operator flow push replaces the whole
        flow list: lowered rules vanish until the next TPS load."""
        tps_live = self.tps_rules.get_rules()
        tps_staged = [r for rs in self.tps_rules.get_staged().values()
                      for r in rs]
        lowered = LR.lower_tps_rules(tps_live) \
            + LR.lower_tps_rules(tps_staged)
        # Replaced wholesale, never mutated: stream_open reads them
        # lock-free.
        self._llm_max_streams = LR.max_streams_by_resource(tps_live)
        # resource -> tightest per-window token budget, the reservation
        # cap: an up-front reservation never exceeds one window's budget.
        budgets: Dict[str, float] = {}
        for r in LR.lower_tps_rules(tps_live):
            cur = budgets.get(r.resource)
            budgets[r.resource] = r.count if cur is None \
                else min(cur, r.count)
        self._llm_window_budget = budgets
        keep = [r for r in self.flow_rules.get_rules()
                if getattr(r, "derived_from", None) != LR.DERIVED_TPS]
        keep += [r for rs in self.flow_rules.get_staged().values()
                 for r in rs
                 if getattr(r, "derived_from", None) != LR.DERIVED_TPS]
        self.flow_rules.load_rules(keep + lowered)
        self._journal_rule_load("tps")

    def _sync_rollout_sources(self) -> None:
        """A rule push may carry staged (candidate-tagged) rules, and the
        active candidate's MERGED view depends on the live rules: both make
        the compiled shadow pack stale. Caller holds the config lock."""
        self.rollout.refresh_staged()
        if self.rollout.device_active():
            self._dirty["rollout"] = True

    def _set_canary(self, bps: Optional[int], salt: int) -> None:
        """The canary scalars every entry dispatch passes to the step
        (``None`` = no canary: the shadow lanes only count)."""
        self._canary_bps = None if bps is None else int(bps)
        self._canary_salt = int(salt)

    def _snapshot_checkers(self) -> None:
        # Version BEFORE checkers: a registration racing between the two
        # reads leaves version != snapshot, so the next _ensure_compiled
        # reads again (the reverse order would pin a stale set forever).
        self._spi_version = self._spi.device_version()
        self._checkers = self._spi.device_checkers()

    def reset_slot_floor(self) -> Dict[str, int]:
        """Drop every family's slot floor back to its initial value and
        mark every family dirty, so the next dispatch recompiles the rule
        tensors at the width the CURRENT rules need (one rule rebuild; the
        port has no trace to redo). Returns the floor in effect before."""
        with self._config_lock:
            old = dict(self._slot_floor)
            self._slot_floor = dict(INITIAL_SLOT_FLOOR)
            for family in INITIAL_SLOT_FLOOR:
                self._dirty[family] = True
            self._rebuild_leases()
        return old

    def _ratchet_slots(self, **tensors) -> None:
        for family, rt in tensors.items():
            self._slot_floor[family] = max(self._slot_floor[family], rt.slots)

    def _compile_flow(self):
        ft, named = F.compile_flow_rules(
            self.flow_rules.get_rules(), self._rule_registry(), self.capacity,
            min_slots=self._slot_floor["flow"], device=self.device)
        self._ratchet_slots(flow=ft)
        self._named_origins = {r: set(o) for r, o in named.items()}
        return ft

    def _compile_degrade(self):
        dt, di = D.compile_degrade_rules(
            self.degrade_rules.get_rules(), self._rule_registry(),
            self.capacity,
            min_slots=self._slot_floor["degrade"], device=self.device)
        self._ratchet_slots(degrade=dt)
        return dt, di

    def _compile_authority(self):
        at = A.compile_authority_rules(
            self.authority_rules.get_rules(), self._rule_registry(),
            self.capacity,
            min_slots=self._slot_floor["authority"], device=self.device)
        self._ratchet_slots(authority=at)
        return at

    def _compile_param(self):
        pt = P.compile_param_rules(
            self.param_rules.get_rules(), self._rule_registry(),
            self.capacity,
            min_slots=self._slot_floor["param"], device=self.device)
        self._ratchet_slots(param=pt)
        return pt

    def _ensure_compiled(self) -> None:
        """(Re)build rule tensors + state after a config push. Each family
        rebuilds independently: a flow push re-creates flow controller
        state but keeps breaker state, and vice versa; node stats always
        survive. Dirty flags clear before their rules are read, so a push
        landing mid-compile is never lost."""
        if self._spi_version != self._spi.device_version():
            self._snapshot_checkers()  # the SPI device checker set changed
        if self._state is None:
            for k in self._dirty:
                self._dirty[k] = False
            now = self.now_ms()
            ft = self._compile_flow()
            dt, di = self._compile_degrade()
            pt = self._compile_param()
            at = self._compile_authority()
            self._rules = S.RulePack(
                flow=ft, degrade=dt, authority=at,
                system=Y.compile_system_rules(self.system_rules.get_rules(),
                                              device=self.device),
                param=pt)
            self._state = S.make_state(
                self.capacity, ft.num_rules, now,
                degrade=D.make_degrade_state(dt, di),
                param=P.make_param_state(pt.num_rules, device=self.device),
                spec1=self._spec1, device=self.device,
                flight_seconds=self.flight_seconds)
            self._maybe_start_system_listener()
            self._compile_shadow()
            return
        if not any(self._dirty.values()):
            return
        now = self.now_ms()
        if self._dirty["flow"]:
            self._dirty["flow"] = False
            ft = self._compile_flow()
            self._rules = self._rules._replace(flow=ft)
            self._state = self._state._replace(
                flow=F.make_flow_state(ft.num_rules, now, device=self.device))
        if self._dirty["degrade"]:
            self._dirty["degrade"] = False
            dt, di = self._compile_degrade()
            self._rules = self._rules._replace(degrade=dt)
            self._state = self._state._replace(
                degrade=D.make_degrade_state(dt, di))
        if self._dirty["authority"]:
            self._dirty["authority"] = False
            self._rules = self._rules._replace(
                authority=self._compile_authority())
        if self._dirty["system"]:
            self._dirty["system"] = False
            self._rules = self._rules._replace(system=Y.compile_system_rules(
                self.system_rules.get_rules(), device=self.device))
            self._maybe_start_system_listener()
        if self._dirty["param"]:
            self._dirty["param"] = False
            pt = self._compile_param()
            self._rules = self._rules._replace(param=pt)
            self._state = self._state._replace(
                param=P.make_param_state(pt.num_rules, device=self.device))
        if self._dirty["rollout"]:
            self._compile_shadow()

    def _compile_shadow(self) -> None:
        """(Re)build the candidate pack and a FRESH shadow world, or tear
        both down when no candidate holds the device.

        The candidate compiles from the merged view (live rules plus the
        candidate's per-resource overrides, ``rollout/manager.py``) through
        the same registry view as the live pack (the slot table's in slot
        mode) and with the live slot floors, which it does not ratchet.
        Like a live rule load, a candidate edit re-creates controller
        state: the shadow world and its counters restart cold, and the
        guardrail re-baselines on its next tick. Runs under the engine lock
        on the engine's stream (``_ensure_compiled``)."""
        self._dirty["rollout"] = False
        spec = self.rollout.device_spec()
        if spec is None:
            self._shadow_rules = None
            if self._state is not None and self._state.shadow is not None:
                self._state = self._state._replace(shadow=None)
            return
        reg, dev = self._rule_registry(), self.device
        ft, _ = F.compile_flow_rules(
            spec["flow"], reg, self.capacity,
            min_slots=self._slot_floor["flow"], device=dev)
        dt, di = D.compile_degrade_rules(
            spec["degrade"], reg, self.capacity,
            min_slots=self._slot_floor["degrade"], device=dev)
        at = A.compile_authority_rules(
            spec["authority"], reg, self.capacity,
            min_slots=self._slot_floor["authority"], device=dev)
        pt = P.compile_param_rules(
            spec["param"], reg, self.capacity,
            min_slots=self._slot_floor["param"], device=dev)
        self._shadow_rules = S.RulePack(
            flow=ft, degrade=dt, authority=at,
            system=Y.compile_system_rules(spec["system"], device=dev),
            param=pt)
        if self._state is not None:
            self._state = self._state._replace(shadow=S.make_shadow_state(
                self.capacity, self._shadow_rules, D.make_degrade_state(dt, di),
                spec1=self._spec1, device=dev))

    def shadow_counts(self) -> Optional[np.ndarray]:
        """Cumulative rollout counters since the candidate was installed:
        ``np.int64[S.NUM_SHADOW_COUNTERS, R]`` (would-pass / would-block
        per family beside the live outcome of the same lanes), or None when
        no candidate holds the device. One copy under the engine lock."""
        with self._lock, self._on_stream():
            self._ensure_compiled()
            state = self._state
            if state is None or state.shadow is None:
                return None
            return state.shadow.counts.cpu().numpy().copy()

    # -- device steps --------------------------------------------------------

    def _as_batch(self, batch, cls):
        if isinstance(batch, dict):
            with _prof.span("to_device"):
                return to_device(batch, self.device)
        if not isinstance(batch, cls):
            raise TypeError(f"expected {cls.__name__} or a numpy staging dict")
        # Columns of numpy (the reference's own tests build batches so),
        # other array-likes or tensors on another device move here first:
        # a step that raised on them would restart the engine cold.
        return batch_to(batch, self.device)

    def _run_entry_batch_locked(self, batch, now_ms: Optional[int] = None,
                                timed: bool = True) -> Decisions:
        """One entry dispatch under the engine lock. ``timed=False`` (the
        batch API) dispatches without the step timer, as the reference's
        ``check_batch`` does."""
        host = batch if isinstance(batch, dict) else None
        with self._on_stream():
            batch = self._as_batch(batch, EntryBatch)
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            self._refresh_signals(now)
            try:
                self._state, dec = self._dispatch(
                    timed, "entry", batch.size,
                    self._entry_step, self._state, self._rules, batch, now,
                    spec1=self._spec1,
                    occupy_timeout_ms=self._occupy_timeout_ms,
                    extra_checkers=self._checkers,
                    shadow_rules=self._shadow_rules,
                    canary_bps=self._canary_bps,
                    canary_salt=self._canary_salt)
            except Exception as ex:  # noqa: BLE001 — the state may be consumed
                self._state = None  # restart cold: rules durable, stats not
                raise DeviceDispatchError(
                    f"entry dispatch failed: {ex!r:.200}") from ex
            # Sampled decision traces: a snapshot and a hand-off only; the
            # pump reads it off this thread. The host staging columns are
            # read when the batch came as one.
            with _prof.span("telemetry.traces_submit"):
                self.traces.submit(host if host is not None else batch, dec,
                                   now)
            with _prof.span("telemetry.population"):
                self._observe_population(host, batch)
        return dec

    def _run_entry_batch(self, batch) -> Decisions:
        with self._lock:
            return self._run_entry_batch_locked(batch)

    def _run_exit_batch(self, batch, now_ms: Optional[int] = None,
                        timed: bool = True) -> None:
        with self._on_stream():
            batch = self._as_batch(batch, ExitBatch)
        with self._batch_lock, self._on_stream():
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            try:
                self._state = self._dispatch(
                    timed, "exit", batch.size,
                    self._exit_step, self._state, self._rules, batch, now,
                    spec1=self._spec1, shadow_rules=self._shadow_rules)
            except Exception as ex:  # noqa: BLE001
                self._state = None
                raise DeviceDispatchError(
                    f"exit dispatch failed: {ex!r:.200}") from ex

    @property
    def _sync(self):
        """Wait for the engine's stream (the step timer's sampled wall);
        None on the CPU, where a step has finished when it returns."""
        return self._stream.synchronize if self._stream is not None else None

    def _dispatch(self, timed: bool, kind: str, n: int, fn, *args, **kw):
        """``fn(*args, **kw)``, step number ``_step_seq``, through the step
        timer when ``timed``; while the span recorder is on, the same two
        clock reads make its ``step.<kind>`` span."""
        self._step_seq += 1
        rec = _prof.recorder
        if rec is not None:
            rec.step(self._step_seq)
        elif not timed:
            return fn(*args, **kw)
        return timed_call(self.step_timer if timed else None, kind, n,
                          self._sync, fn, *args, **kw)

    # -- batch API -----------------------------------------------------------

    def check_batch(self, batch, now_ms: Optional[int] = None) -> Decisions:
        """One admission step over a batch (``EntryBatch`` of tensors on
        this engine's device, or a ``make_entry_batch_np`` dict)."""
        with _prof.span("check_batch"), self._batch_lock:
            return self._run_entry_batch_locked(batch, now_ms, timed=False)

    def complete_batch(self, batch, now_ms: Optional[int] = None) -> None:
        """One completion step (``ExitBatch`` or a numpy staging dict)."""
        with _prof.span("complete_batch"):
            self._run_exit_batch(batch, now_ms, timed=False)

    def stage_decisions(self, dec) -> _StagedVerdicts:
        """Start a step's verdicts on their way to the host without
        blocking: on CUDA, non-blocking copies of ``reason`` and
        ``wait_us`` into pinned memory on the engine's stream, then one
        event. Needs no lock: the copies follow the step on the stream."""
        if isinstance(dec, _StagedVerdicts):
            return dec
        if self._stream is None:
            return _StagedVerdicts(dec.reason, dec.wait_us, None)
        with self._on_stream():
            out = []
            for t in (dec.reason, dec.wait_us):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                out.append(host)
            event = torch.cuda.Event()
            event.record()
        return _StagedVerdicts(out[0], out[1], event)

    def harvest_decisions(self, dec) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a dispatched step's verdicts on the host: (reason,
        wait_us). ``dec`` is a step's ``Decisions`` or what
        :meth:`stage_decisions` made of them. Waits on the copies' event
        WITHOUT the engine lock, so a concurrent dispatch never stalls
        behind it. A failure here (a step that died after dispatch) drops
        the state cold, as a dispatch-time failure does, and raises
        ``DeviceDispatchError``."""
        with _prof.span("harvest"):
            try:
                staged = self.stage_decisions(dec)
                if staged.event is not None:
                    staged.event.synchronize()
                return staged.reason.numpy(), staged.wait_us.numpy()
            except Exception as ex:  # noqa: BLE001 — device or runtime death
                with self._lock:
                    self._state = None
                raise DeviceDispatchError(
                    f"harvest failed: {ex!r:.200}") from ex

    def warmup(self, widths: Optional[Sequence[int]] = None) -> None:
        """Run one no-op entry and exit step (all rows -1, nothing
        committed) at every ladder width under the current rules, so the
        first real traffic finds the kernel loaded and the allocator
        warm."""
        for width in (widths if widths is not None else BATCH_WIDTHS):
            self._run_entry_batch(make_entry_batch_np(int(width)))
            self._run_exit_batch(make_exit_batch_np(int(width)))

    def close(self) -> None:
        """Stop the background workers: the stats committer, then the
        pipeline, the OS sampler, the cluster role, the trace pump, the
        alert webhook and a watched fleet's clients; close the journal.

        The fast path goes off FIRST (one swap under both locks, which
        ``_ensure_committer`` checks), so no new entry takes it; then the
        committer stops and drains OUTSIDE the locks, since its flush
        takes the engine lock. A leased handle exiting after close
        commits synchronously on the device."""
        with self._config_lock, self._lock:
            self._closed = True
            self._fastpath = _FastPathState({}, frozenset(), False)
            committer, self._committer = self._committer, None
        if committer is not None:
            committer.stop()
        self.stop_pipeline()
        self.system_status.stop()
        self.cluster.stop()
        self.traces.stop()
        self.slo.stop()
        fleet = self.fleet
        if fleet is not None:
            self.fleet = None
            fleet.stop()
        self.journal.close()

    # -- runtime retuning ----------------------------------------------------

    def set_occupy_timeout(self, timeout_ms: int) -> None:
        """Retune the prioritized-borrow wait cap (reference:
        ``OccupyTimeoutProperty``), within one instant window."""
        timeout_ms = int(timeout_ms)
        with self._lock:
            if timeout_ms < 0 or timeout_ms > self._spec1.interval_ms:
                raise ValueError(
                    f"occupy timeout {timeout_ms}ms must be within "
                    f"[0, {self._spec1.interval_ms}] (one instant window)")
            self._occupy_timeout_ms = timeout_ms

    def set_window_geometry(self, interval_ms: Optional[int] = None,
                            sample_count: Optional[int] = None) -> None:
        """Retune the instant window at runtime (reference:
        ``IntervalProperty`` / ``SampleCountProperty``).

        The instant-window statistics RESET under the new geometry;
        breakers, param buckets, the minute window and the concurrency
        gauge survive. Pending occupy borrows are dropped: their bucket
        geometry no longer exists. The step takes the geometry as an
        argument, so nothing is rebuilt but the state and the leases."""
        # Queued commits belong to the OLD window: land them in it before
        # it is discarded (outside the lock: the flush takes it).
        self._flush_committer()
        with self._config_lock, self._lock:
            cur = self._spec1
            interval_ms = cur.interval_ms if interval_ms is None \
                else int(interval_ms)
            sample_count = cur.buckets if sample_count is None \
                else int(sample_count)
            if interval_ms <= 0 or sample_count <= 0 \
                    or interval_ms % sample_count != 0:
                raise ValueError(
                    f"invalid window geometry: interval {interval_ms}ms must "
                    f"be a positive multiple of sample count {sample_count}")
            new = W.WindowSpec(interval_ms, sample_count)
            if new == cur:
                return
            self._spec1 = new
            # The borrow-wait cap stays within one instant window: a shrink
            # below it clamps it, loudly.
            if self._occupy_timeout_ms > new.interval_ms:
                record_log.warn(
                    "occupy timeout %sms clamped to new %sms window",
                    self._occupy_timeout_ms, new.interval_ms)
                self._occupy_timeout_ms = new.interval_ms
            # Reset the device window BEFORE rebuilding the leases: the new
            # mirrors (new bucket count) seed from the new-geometry window.
            if self._state is not None:
                with self._on_stream():
                    self._state = self._state._replace(
                        w1=W.make_window(self.capacity, new, self.device),
                        occupied_next=torch.zeros(
                            (self.capacity,), dtype=torch.int32,
                            device=self.device),
                        occupied_stamp=torch.tensor(
                            -1, dtype=torch.int64, device=self.device))
            # The shadow world's window has the OLD geometry: it is rebuilt
            # under the new spec at the next compile (its statistics reset
            # with the live window's).
            self._dirty["rollout"] = True
            self._rebuild_leases()

    # -- pipelined mode ------------------------------------------------------

    def start_pipeline(self, max_batch: int = 2048,
                       linger_s: Optional[float] = None,
                       inflight_depth: Optional[int] = None):
        """Switch to micro-batched admission (``core/pipeline.py``):
        concurrent entries fold into one device step per cycle, up to
        ``inflight_depth`` cycles in flight. ``linger_s`` and
        ``inflight_depth`` default to the ``csp.sentinel.pipeline.*``
        keys. While it runs, the leases and the unruled pass stand down."""
        from sentinel_tpu_torch.core.pipeline import Pipeline

        if self.slots is not None:
            raise RuntimeError(
                "pipelined admission is not supported in slot mode: the "
                "pipeline resolves rows outside the slot-tenancy "
                "re-validation protocol (run slot mode synchronous, or "
                "fixed-capacity mode pipelined)")
        with self._lock:
            if self._pipeline is None:
                with self._on_stream():
                    self._ensure_compiled()  # compile before the loop starts
                self._pipeline = Pipeline(
                    self, max_batch, linger_s,
                    inflight_depth=inflight_depth).start()
            return self._pipeline

    def stop_pipeline(self) -> None:
        with self._pipeline_stats_lock:
            pipeline, self._pipeline = self._pipeline, None
            if pipeline is None:
                return  # a concurrent stop owns (or already folded) it
            self._retiring_pipeline = pipeline
        pipeline.stop()  # may drain for a while: counters stay readable
        with self._pipeline_stats_lock:
            s = pipeline.stats()
            t = self._pipeline_totals
            for k in ("cycles", "batched", "harvests", "failOpenCycles",
                      "poolAllocated", "poolReused"):
                t[k] += s[k]
            t["inflightDepthMax"] = max(t["inflightDepthMax"],
                                        s["inflightDepthMax"])
            self._retiring_pipeline = None

    def pipeline_stats(self) -> Dict:
        """Pipelined admission at a glance: counters monotone across
        pipeline generations (a stopping pipeline keeps reporting through
        the retiring hand-off), the live in-flight depth, and the
        queue-wait vs device-wait split from the step timer. Never takes
        the engine lock."""
        with self._pipeline_stats_lock:
            t = dict(self._pipeline_totals)
            p = self._pipeline or self._retiring_pipeline
            live = p.stats() if p is not None else None
            active = self._pipeline is not None

        def total(k):
            return t[k] + (live[k] if live else 0)

        out = {
            "active": active,
            "cycles": total("cycles"),
            "batched": total("batched"),
            "harvests": total("harvests"),
            "failOpenCycles": total("failOpenCycles"),
            "inflightDepth": live["inflightDepth"] if live else 0,
            "inflightDepthMax": max(
                t["inflightDepthMax"],
                live["inflightDepthMax"] if live else 0),
            "configuredDepth": live["configuredDepth"] if live else 0,
            "poolAllocated": total("poolAllocated"),
            "poolReused": total("poolReused"),
        }
        out.update(self.step_timer.pipeline_snapshot())
        return out

    # -- width-1 API ---------------------------------------------------------

    def entry(self, resource: str, entry_type: int = C.EntryType.OUT,
              count: int = 1, args: Sequence = (),
              prioritized: bool = False) -> EntryHandle:
        """``SphU.entry``: admit or raise a ``BlockException`` subclass.
        The origin comes from the call context (``context_enter``)."""
        if count > C.MAX_ACQUIRE_COUNT:
            raise ValueError(
                f"count={count} exceeds MAX_ACQUIRE_COUNT={C.MAX_ACQUIRE_COUNT}")
        ctx = ctx_mod.get_context()
        if ctx is None:
            ctx = ctx_mod.enter_auto()  # pooled per-thread default context
        entry_in = entry_type == C.EntryType.IN
        if ctx.is_null or not self.enabled:
            return EntryHandle(self, resource, ctx, -1, -1, -1, entry_in,
                               count, ())
        if self.slots is not None:
            # Slot mode: hot resources take the lease / device machinery
            # at their SLOT row, cold ones degrade loudly; nothing raises
            # at capacity.
            return self._slot_entry(resource, ctx, entry_type, count, args,
                                    prioritized)

        reg = self.registry
        if ctx.entrance_row < 0:
            ctx.entrance_row = reg.entrance_row(ctx.name)
        parent = ctx.cur_entry.dn_row if ctx.cur_entry else ctx.entrance_row
        cluster_row, dn_row, origin_row, origin_id = reg.resolve_entry(
            resource, ctx.name, ctx.origin, parent, int(entry_type))
        if cluster_row < 0:
            # Registry full: pass-through, like the reference's chain cap.
            return EntryHandle(self, resource, ctx, -1, -1, -1, entry_in,
                               count, ())
        params = tuple(hash_param(a) for a in args[:MAX_PARAMS]) \
            if args else ()

        # SPI host slots: a slot raising a BlockException rejects the
        # entry; the block is committed to statistics first.
        custom_ex = None
        slots = self._spi.host_slots()
        if slots:
            info = self._spi.EntryInfo(
                resource=resource, origin=ctx.origin, count=count,
                entry_type=int(entry_type), prioritized=prioritized,
                args=tuple(args), context_name=ctx.name)
            for slot in slots:
                try:
                    slot.on_entry(info)
                except BlockException as ex:
                    custom_ex = ex
                    break
                except Exception:
                    # A buggy slot must not leak the auto-created context.
                    ctx_mod.auto_exit_context()
                    raise
        if custom_ex is not None:
            self._submit_entry(
                resource, cluster_row, dn_row, origin_row, origin_id,
                reg.context_id(ctx.name), count, prioritized, entry_in,
                params, pre_blocked=True)
            ctx_mod.auto_exit_context()
            log_block(resource, type(custom_ex).__name__, ctx.origin, count,
                      self.now_ms())
            raise custom_ex

        # Token-lease fast path: eligible resources admit host-side and
        # stream their stats to the device. Prioritized requests keep the
        # device path: a rejected one may still borrow the next window.
        # Under the pipeline every entry goes to the device.
        fp = self._fastpath  # ONE read: never a torn (leases, guarded, unruled)
        lease = fp.leases.get(resource)
        fast_ok = (not slots and self._pipeline is None
                   and not self._spi.device_checkers())
        if lease is not None and not prioritized and fast_ok:
            now = self.now_ms()
            block_reason = lease.admit(count, now, params)
            self._ensure_committer().add_entry(
                cluster_row, dn_row, origin_row, entry_in, count,
                block_reason == 0, block_reason)
            if block_reason:
                ctx_mod.auto_exit_context()
                ex = exception_for_reason(block_reason, resource)
                log_block(resource, type(ex).__name__, ctx.origin, count, now)
                raise ex
            handle = EntryHandle(self, resource, ctx, cluster_row, dn_row,
                                 origin_row, entry_in, count, params,
                                 leased=True, now_ms=now)
            ctx.entry_stack.append(handle)
            return handle
        if lease is None and fast_ok and fp.unruled \
                and resource not in fp.guarded:
            # NO rules of any family on this resource and nothing RELATEs
            # to it: always pass, stats stream via the committer.
            self._ensure_committer().add_entry(
                cluster_row, dn_row, origin_row, entry_in, count, True)
            handle = EntryHandle(self, resource, ctx, cluster_row, dn_row,
                                 origin_row, entry_in, count, params,
                                 leased=True)
            ctx.entry_stack.append(handle)
            return handle

        if lease is not None:
            # Device path on a LEASED resource (a prioritized request, or
            # the pipeline's): land pending leased commits first so the
            # device check sees them, and mirror the verdict below so the
            # lease never drifts from the device window.
            self._flush_committer()
        # Cross-process spans: only entries with cluster-mode rules can
        # cross the wire, so only those are sampled; the root span records
        # the final verdict, the cluster check hangs token_request and the
        # server's span under it.
        trace_ctx = root_span = None
        if self._cluster_flow_info.get(resource) \
                or self._cluster_param_info.get(resource):
            trace_ctx = self.spans.sample()
        if trace_ctx is not None:
            root_span = Span("sentinel.entry", trace_ctx,
                             attrs={"resource": resource,
                                    "origin": ctx.origin})
        skip_cluster, pre_blocked = self._cluster_token_check(
            resource, count, prioritized, args, trace=trace_ctx)
        reason, wait_us = self._submit_entry(
            resource, cluster_row, dn_row, origin_row, origin_id,
            reg.context_id(ctx.name), count, prioritized, entry_in, params,
            skip_cluster=skip_cluster, pre_blocked=pre_blocked)
        if root_span is not None:
            root_span.attrs.update(
                reason=int(reason),
                blocked=bool(reason > 0 and reason != C.BlockReason.WAIT),
                preBlocked=bool(pre_blocked))
            self.spans.record(root_span.finish())
        if reason > 0 and reason != C.BlockReason.WAIT:
            # Drop an auto-entered context with no live entries so a fresh
            # context_enter on this thread isn't shadowed by it.
            ctx_mod.auto_exit_context()
            ex = exception_for_reason(reason, resource)
            log_block(resource, type(ex).__name__, ctx.origin, count,
                      self.now_ms())
            raise ex
        if wait_us > 0:
            time.sleep(wait_us / 1e6)
        if lease is not None:
            # Occupy grants land in the bucket after the wait: recording
            # post-sleep stamps them there.
            lease.add(count, self.now_ms(), params)
        handle = EntryHandle(self, resource, ctx, cluster_row, dn_row,
                             origin_row, entry_in, count, params)
        ctx.entry_stack.append(handle)
        return handle

    def _submit_entry(self, resource, cluster_row, dn_row, origin_row,
                      origin_id, context_id, count, prioritized, entry_in,
                      params, skip_cluster=False,
                      pre_blocked=False) -> Tuple[int, int]:
        """One entry's device verdict, (reason, wait_us): a ticket of the
        pipeline's when it runs, else one width-1 step. A failed step or
        cycle fails open, counted."""
        fields = dict(
            cluster_row=cluster_row, dn_row=dn_row, origin_row=origin_row,
            origin_id=origin_id,
            origin_named=origin_id in self._named_origins.get(resource, ()),
            context_id=context_id, count=count, prioritized=prioritized,
            entry_in=entry_in, skip_cluster=skip_cluster,
            pre_blocked=pre_blocked, params=params)
        pipeline = self._pipeline
        if pipeline is not None:
            ticket = pipeline.submit_entry(fields)
            # A submitted ticket is completed exactly once, by a cycle or
            # by stop()'s straggler drain: NEVER resubmit it (that would
            # double-commit). Only a None ticket (closed before submit)
            # takes the synchronous path.
            if ticket is not None:
                while not ticket.done.wait(timeout=2.0):
                    if pipeline.closed and not ticket.done.wait(timeout=2.0):
                        # stop() drained what it could and the ticket never
                        # surfaced (the collector died mid-cycle).
                        self._note_fail_open("collector died mid-cycle")
                        return 0, 0
                if ticket.reason == -2:  # cycle error: pass-through
                    self._note_fail_open("pipeline cycle error")
                    return 0, 0
                return ticket.reason, ticket.wait_us
        buf = make_entry_batch_np(1)
        stage_row(buf, 0, fields)
        with self._lock:
            try:
                dec = self._run_entry_batch_locked(buf)
            except DeviceDispatchError as ex:
                self._note_fail_open(str(ex))
                return 0, 0
            return int(dec.reason[0]), int(dec.wait_us[0])

    def _note_fail_open(self, why: str) -> None:
        """Count + rate-limited log of an unguarded pass-through."""
        self.fail_open_count += 1
        now = self.now_ms()
        if now - self._fail_open_logged_ms >= 1000:
            self._fail_open_logged_ms = now
            logging.getLogger("sentinel_tpu_torch").warning(
                "entry passed UNGUARDED (%s); fail_open_count=%d",
                why, self.fail_open_count)

    # -- the cluster token check ---------------------------------------------

    @staticmethod
    def _cluster_info(rules, with_param_idx: bool = False) -> Dict[str, list]:
        """resource -> [(flowId, fallback[, paramIdx])] for remote-enforced
        (cluster mode + flowId) rules. Pod-psum cluster rules (no flowId)
        stay out: they are enforced by the local/pod check."""
        info: Dict[str, list] = {}
        for r in rules:
            cc = getattr(r, "cluster_config", None) or {}
            if getattr(r, "cluster_mode", False) and cc.get("flowId") is not None:
                entry = (int(cc["flowId"]),
                         bool(cc.get("fallbackToLocalWhenFail", True)))
                if with_param_idx:
                    entry += (int(r.param_idx),)
                info.setdefault(r.resource, []).append(entry)
        return info

    @staticmethod
    def _cluster_threshold_map(rules) -> Dict[int, tuple]:
        """flowId -> (threshold, windowIntervalMs) from the local copies
        of cluster-mode flow rules (the degraded-quota share base) — the
        same derivation standalone HA seats use, so every client computes
        the same share."""
        from sentinel_tpu_torch.cluster.rules import cluster_thresholds

        return cluster_thresholds(
            r for r in rules if getattr(r, "cluster_mode", False))

    def cluster_degraded_thresholds(self) -> Dict[int, tuple]:
        """Current flowId -> (threshold, intervalMs) map for the HA
        client's degraded quota (lock-free: replaced wholesale on load)."""
        return self._cluster_thresholds

    # -- LLM streaming reservations (llm/) -----------------------------------

    def _llm_debit(self, resource: str, tokens: int) -> int:
        """Debit ``tokens`` into the model's TPS window through the normal
        entry path, in chunks of MAX_ACQUIRE_COUNT. QPS PASS debits stay
        in the window; the immediate exit releases only the concurrency
        gauge. On a block mid-way the exception carries ``llm_debited``,
        the tokens already landed, so the caller can refund them."""
        remaining = int(tokens)
        debited = 0
        try:
            while remaining > 0:
                chunk = min(remaining, C.MAX_ACQUIRE_COUNT)
                try:
                    handle = self.entry(resource, count=chunk)
                except BlockException as ex:
                    ex.llm_debited = debited
                    raise
                handle.exit()
                debited += chunk
                remaining -= chunk
        finally:
            # Land the leased commits now, in this second: an injected
            # clock (the simulator) has no advance hook, so a background
            # flush after the clock moved would stamp these debits into
            # the wrong window.
            self._flush_committer()
        return debited

    def stream_open(self, stream_id: str, model: str,
                    estimate_tokens: Optional[int] = None,
                    tenant: str = C.LIMIT_APP_DEFAULT):
        """Open a streaming reservation: acquire the ESTIMATED output
        budget up front as a lease that ticks down as tokens stream
        (``stream_tick``) and reconciles on ``stream_close``. Raises a
        ``BlockException`` subclass when the window, the
        maxConcurrentStreams cap or the ledger's capacity rejects it; a
        partly debited estimate is refunded as expiring credit."""
        resource = LR.llm_resource(model)
        now = self.now_ms()
        estimate = int(self._llm_default_estimate
                       if estimate_tokens is None else estimate_tokens)
        if estimate < 0:
            raise ValueError("estimate_tokens must be >= 0")
        cap = self._llm_max_streams.get(resource)
        if (cap is not None and self.streams.active(resource) >= cap) \
                or self.streams.at_capacity():
            self.streams.open_blocked += 1
            log_block(resource, "FlowException", tenant, estimate, now)
            raise FlowException(resource)
        # The reservation caps at ONE window's token budget: a longer
        # generation pays the rest live as it streams (the tick's
        # overflow path), which keeps an abort's over-admission within
        # one window of tokens.
        budget = self._llm_window_budget.get(resource)
        reserved = estimate if budget is None \
            else min(estimate, int(budget))
        credit = self.streams.take_credit(resource, reserved, now)
        try:
            debited = self._llm_debit(resource, reserved - int(credit))
        except BlockException as ex:
            # Refund what landed (live chunks and consumed credit): the
            # tokens stay in the PASS window until it rolls, and the
            # credit makes them reusable for that long.
            refund = getattr(ex, "llm_debited", 0) + credit
            self.streams.add_credit(resource, refund, now)
            self.streams.open_blocked += 1
            raise
        return self.streams.open(stream_id, resource, tenant,
                                 estimate, reserved, debited, now)

    def stream_tick(self, stream_id: str, tokens: int) -> float:
        """Reconcile ``tokens`` actually streamed against the reservation.
        Output beyond the reservation debits live (credit first); a block
        on that debit propagates as backpressure, the streamed tokens
        still counted. Returns the remaining reserved budget."""
        now = self.now_ms()
        covered, overflow = self.streams.tick(stream_id, tokens, now)
        if overflow > 0:
            lease = self.streams.get(stream_id)
            credit = self.streams.take_credit(
                lease.resource, overflow, now)
            try:
                debited = self._llm_debit(
                    lease.resource, int(overflow - int(credit)))
            except BlockException as ex:
                self.streams.record_overflow_debit(
                    getattr(ex, "llm_debited", 0))
                raise
            self.streams.record_overflow_debit(debited)
        lease = self.streams.get(stream_id)
        return lease.remaining if lease is not None else 0.0

    def stream_close(self, stream_id: str, aborted: bool = False) -> float:
        """Close (or abort) a streaming reservation. The unconsumed
        remainder returns as credit on the resource, expiring when the
        window rolls; returns that remainder."""
        now = self.now_ms()
        lease = self.streams.get(stream_id)
        if lease is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        remainder = self.streams.close(stream_id, now, aborted=aborted)
        if remainder > 0:
            self.streams.add_credit(lease.resource, remainder, now)
        return remainder

    def _note_cluster_fallback(self, budget_exhausted: bool = False) -> None:
        """A cluster-mode rule degraded to its local fallback this entry."""
        self.cluster_fallback_count += 1
        if budget_exhausted:
            self.cluster_budget_exhausted_count += 1

    def _cluster_token_check(self, resource, count, prioritized, args,
                             trace=None) -> Tuple[bool, bool]:
        """Remote token acquire for cluster-mode rules (``passClusterCheck``).

        Returns (skip_cluster, pre_blocked): with a healthy token client,
        OK/SHOULD_WAIT verdicts mask the cluster rules out of the local
        check; BLOCKED pre-decides the entry; FAIL-class statuses keep the
        local check live when the rule's fallbackToLocalWhenFail is set
        (= ``fallbackToLocalOrPass``). No client / no cluster rules ->
        local enforcement as-is.

        Bounded latency: ALL remote work for one entry — request waits
        AND server-hinted SHOULD_WAIT sleeps, across every cluster rule —
        shares one ``cluster_entry_budget_ms`` deadline budget; rules the
        budget can't reach degrade to the local check. Once the client's
        breaker is OPEN, requests fail fast without touching the wire.
        """
        # Lock-free fast path: the info dicts are replaced wholesale on
        # rule load.
        flow_info = self._cluster_flow_info.get(resource, ())
        param_info = self._cluster_param_info.get(resource, ())
        if not flow_info and not param_info:
            return False, False
        client = self.cluster.client_if_active()
        if client is None:
            return False, False
        from sentinel_tpu_torch.cluster.constants import TokenResultStatus

        def traced_call(kind, flow_id, fn):
            """Run one remote acquire under a child span when tracing;
            the server-side span (shipped in the response TLV) joins the
            local collector so the stitched trace reads in one place."""
            if trace is None:
                return fn(None)
            from sentinel_tpu_torch.telemetry.spans import TraceContext

            child = trace.child()
            sp = Span("cluster.token_request", child,
                      parent_span_id=trace.span_id,
                      attrs={"flowId": flow_id, "kind": kind})
            tr = fn(child)
            sp.finish()
            sp.attrs["status"] = int(tr.status)
            self.spans.record(sp)
            if tr.server_span is not None:
                srv = tr.server_span
                self.spans.record_remote(
                    TraceContext(trace.trace_id, srv["spanId"]),
                    "cluster.token_service", child.span_id,
                    srv["startMs"], srv["durationUs"],
                    attrs={"flowId": flow_id})
            return tr

        budget = DeadlineBudget(self.cluster_entry_budget_ms)
        # A request launched with less than half the configured budget
        # left is breaker-NEUTRAL on timeout: a healthy server can miss a
        # starved deadline, and such misses must not trip the gate.
        neutral_below_ms = self.cluster_entry_budget_ms / 2
        all_ok = True
        for flow_id, fallback in flow_info:
            remaining_ms = budget.remaining_ms()
            if remaining_ms <= 0:
                if fallback:
                    all_ok = False
                self._note_cluster_fallback(budget_exhausted=True)
                continue
            tr = traced_call("flow", flow_id, lambda t: client.request_token(
                flow_id, count, prioritized, timeout_s=remaining_ms / 1000.0,
                gate_neutral=remaining_ms < neutral_below_ms, trace=t))
            if tr.status == TokenResultStatus.OK:
                continue
            if tr.status == TokenResultStatus.SHOULD_WAIT:
                wait_ms = budget.clamp_wait_ms(tr.wait_ms)
                if wait_ms > 0:
                    time.sleep(wait_ms / 1000.0)
                continue
            if tr.status == TokenResultStatus.BLOCKED:
                return False, True
            if tr.status == TokenResultStatus.OVERLOADED:
                # Shed before admission: degrade to the local path at
                # once — no retry, no sleep.
                self.cluster_overload_count += 1
                if fallback:
                    all_ok = False
                    self._note_cluster_fallback()
                continue
            if tr.status == TokenResultStatus.WRONG_SLICE:
                # A sharded leader that no longer owns the flow's slice:
                # not a verdict, degrade like a FAIL, counted apart.
                self.cluster_wrong_slice_count += 1
                if fallback:
                    all_ok = False
                    self._note_cluster_fallback()
                continue
            if fallback:  # FAIL / NO_RULE / TOO_MANY_REQUEST -> local check
                all_ok = False
                self._note_cluster_fallback()
        for flow_id, fallback, param_idx in param_info:
            if param_idx >= len(args):
                continue  # no such argument: the rule does not apply
            remaining_ms = budget.remaining_ms()
            if remaining_ms <= 0:
                if fallback:
                    all_ok = False
                self._note_cluster_fallback(budget_exhausted=True)
                continue
            tr = traced_call(
                "param", flow_id, lambda t: client.request_param_token(
                    flow_id, count, [args[param_idx]],
                    timeout_s=remaining_ms / 1000.0,
                    gate_neutral=remaining_ms < neutral_below_ms, trace=t))
            if tr.status == TokenResultStatus.OK:
                continue
            if tr.status == TokenResultStatus.BLOCKED:
                return False, True
            if tr.status == TokenResultStatus.OVERLOADED:
                self.cluster_overload_count += 1
                if fallback:
                    all_ok = False
                    self._note_cluster_fallback()
                continue
            if tr.status == TokenResultStatus.WRONG_SLICE:
                self.cluster_wrong_slice_count += 1
                if fallback:
                    all_ok = False
                    self._note_cluster_fallback()
                continue
            if fallback:
                all_ok = False
                self._note_cluster_fallback()
        return all_ok, False

    def _do_exit(self, handle: EntryHandle, count: int) -> None:
        ctx = handle.context
        if ctx.entry_stack and ctx.entry_stack[-1] is handle:
            ctx.entry_stack.pop()
        elif handle in ctx.entry_stack:
            ctx.entry_stack.remove(handle)
        if self.slots is not None and handle.slot_gen != -1:
            # Slot mode: generation-stamped exit accounting (current-slot
            # device exit / spill-record decrement / cold tally).
            self._slot_exit(handle, count)
            return
        if handle.cluster_row < 0:
            ctx_mod.auto_exit_context()
            return
        now = self.now_ms()
        rt = max(0, now - handle.created_ms)
        slots = self._spi.host_slots()
        if slots:
            info = self._spi.EntryInfo(
                resource=handle.resource, origin=ctx.origin, count=count,
                entry_type=(C.EntryType.IN if handle.entry_in
                            else C.EntryType.OUT),
                prioritized=False, args=(), context_name=ctx.name)
            for slot in slots:
                try:
                    slot.on_exit(info, rt, handle.error)
                except Exception as ex:  # noqa: BLE001 — exit must finish
                    record_log.warn("SPI slot %r on_exit failed: %r",
                                    type(slot).__name__, ex)
        committer = self._committer  # one read: close() nulls it concurrently
        if handle.leased and committer is not None:
            # Leased entries complete through the committer too; after
            # close() they fall through to the synchronous commit below.
            committer.add_exit(
                handle.cluster_row, handle.dn_row, handle.origin_row,
                handle.entry_in, count, min(rt, C.DEFAULT_MAX_RT_MS),
                True, handle.error)
            ctx_mod.auto_exit_context()
            return
        fields = dict(
            cluster_row=handle.cluster_row, dn_row=handle.dn_row,
            origin_row=handle.origin_row, entry_in=handle.entry_in,
            count=count, rt_ms=min(rt, C.DEFAULT_MAX_RT_MS), success=True,
            error=handle.error, params=handle.params)
        pipeline = self._pipeline
        if pipeline is None or not pipeline.submit_exit(fields):
            buf = make_exit_batch_np(1)
            stage_row(buf, 0, fields)
            try:
                self._run_exit_batch(buf)
            except DeviceDispatchError as ex:
                # An exit commit is pure statistics: an infrastructure
                # failure must never break the caller's happy path.
                self._note_fail_open(str(ex))
        ctx_mod.auto_exit_context()

    # -- readers ---------------------------------------------------------------

    def seal_metrics(self, now_ms: Optional[int] = None) -> List:
        """Aggregate sealed (fully elapsed) seconds from the minute window
        (reference: ``MetricTimerListener``). Returns ``MetricNode``s for
        seconds not sealed by a previous call; all-idle resource-seconds
        are skipped.

        The clock is read under the engine lock (the reference reads it
        before the committer's flush): a step of a later second that ran
        in between would otherwise be folded under the older stamp.
        While the span recorder is on, the seal is the spans
        ``seal.flush_committer``, ``seal.lock_wait`` (only when the lock
        is held), ``seal.read`` (the fold, the gather and the copy under
        the lock) and ``seal.nodes``."""
        with _prof.span("seal.flush_committer"):
            self._flush_committer()  # leased commits land before sealing
        with self._seal_lock, _prof.span("seal.read"), self._on_stream():
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            now_sec = now // 1000
            first = max(self._sealed_sec + 1, now_sec - C.MINUTE_BUCKETS + 1)
            seconds = list(range(first, now_sec))
            if not seconds:
                return []
            self._sealed_sec = seconds[-1]
            # Fold any completed staged second into w60 before reading it.
            self._state = S.flush_seconds(self._state, now)
            idx = torch.tensor([s % C.MINUTE_BUCKETS for s in seconds],
                               device=self.device)
            w60 = W.rotate(self._state.w60, now, S.SPEC_60S)
            slices = w60.counts[idx].permute(2, 0, 1).cpu().numpy()
            threads = self._state.cur_threads.cpu().numpy()
            metas = self._device_metas()
        with _prof.span("seal.nodes"):
            return self._seal_nodes(seconds, slices, threads, metas)

    @staticmethod
    def _seal_nodes(seconds, slices, threads, metas) -> List:
        """The sealed seconds' ``MetricNode``s, active cluster rows only."""
        from sentinel_tpu_torch.metrics.metric_node import MetricNode

        ev = [C.MetricEvent.PASS, C.MetricEvent.BLOCK,
              C.MetricEvent.SUCCESS, C.MetricEvent.EXCEPTION]
        active_rows, active_k = np.nonzero(slices[:, :, ev].any(axis=2))
        out = []
        for row, k in zip(active_rows.tolist(), active_k.tolist()):
            m = metas[row]
            if m.kind != KIND_CLUSTER:
                continue
            t = slices[row, k]
            succ = int(t[C.MetricEvent.SUCCESS])
            out.append(MetricNode(
                timestamp=seconds[k] * 1000,
                resource=m.resource,
                pass_qps=int(t[C.MetricEvent.PASS]),
                block_qps=int(t[C.MetricEvent.BLOCK]),
                success_qps=succ,
                exception_qps=int(t[C.MetricEvent.EXCEPTION]),
                rt=float(t[C.MetricEvent.RT]) / max(succ, 1),
                occupied_pass_qps=int(t[C.MetricEvent.OCCUPIED_PASS]),
                concurrency=int(threads[row]),
                classification=m.resource_type,
            ))
        out.sort(key=lambda n: n.timestamp)
        return out

    def row_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """(per-second QPS totals f32[R, E], threads int[R]) as numpy.
        Totals are normalized by the instant-window interval."""
        self._flush_committer()
        with self._lock, self._on_stream():
            self._ensure_compiled()
            now = self.now_ms()
            w1 = W.rotate(self._state.w1, now, self._spec1)
            totals = W.all_totals(w1).cpu().numpy()
            threads = self._state.cur_threads.cpu().numpy()
        scale = np.float32(1000.0 / self._spec1.interval_ms)
        return totals.astype(np.float32) * scale, threads

    def telemetry_counts(self) -> Dict[str, np.ndarray]:
        """Cumulative device telemetry since engine start, as numpy:
        ``blockByReason`` int64[NUM_ATTR_REASONS, R] per-(reason family,
        node row) block attribution, ``rtHist`` int64[NUM_RT_BUCKETS, R]
        success-RT histogram, ``totals`` int64[NUM_EVENTS, R] event
        counters, ``blockBySlot`` int64[NUM_ATTR_REASONS, NUM_SLOT_BINS].
        Queued leased commits are flushed first; the state comes to the
        host in one copy under the lock, and the live staged second folds
        in on the host (``ops/step.py:telemetry_view``'s arithmetic), so a
        read never dispatches a step."""
        self._flush_committer()
        with self._lock, self._on_stream():
            self._ensure_compiled()
            tele = self._state.telemetry
            h = to_host({
                "sec": self._state.sec.counts, "block": tele.block_by_reason,
                "hist": tele.rt_hist, "totals": tele.totals,
                "slot": tele.block_by_slot, "stage_attr": tele.stage_attr,
                "stage_hist": tele.stage_hist, "stage_slot": tele.stage_slot})
        return {
            "blockByReason": h["block"] + h["stage_attr"].astype(np.int64),
            "rtHist": h["hist"] + h["stage_hist"].astype(np.int64),
            "totals": h["totals"] + h["sec"].astype(np.int64),
            "blockBySlot": h["slot"] + h["stage_slot"].astype(np.int64),
        }

    def telemetry_snapshot(self) -> Dict:
        """JSON-shaped telemetry view (the reference's ``telemetry`` ops
        command): per-resource cumulative counters, block attribution by
        reason family, RT percentiles estimated from the device
        histogram, the degradation counters and the sampling rings."""
        from sentinel_tpu_torch.telemetry.attribution import (
            ATTR_REASON_NAMES, histogram_quantile, slot_bins_to_dict)

        counts = self.telemetry_counts()
        totals = counts["totals"]
        by_reason = counts["blockByReason"]
        rt_hist = counts["rtHist"]
        active = totals.any(axis=0) | by_reason.any(axis=0)
        resources: Dict[str, Dict] = {}
        for row, meta in enumerate(self._device_metas()):
            if meta.kind != KIND_CLUSTER or row >= active.shape[0] \
                    or not active[row]:
                continue
            hist = rt_hist[:, row]
            reasons = {name: int(by_reason[ch, row])
                       for ch, name in enumerate(ATTR_REASON_NAMES)
                       if by_reason[ch, row]}
            resources[meta.resource] = {
                "passTotal": int(totals[C.MetricEvent.PASS, row]),
                "blockTotal": int(totals[C.MetricEvent.BLOCK, row]),
                "successTotal": int(totals[C.MetricEvent.SUCCESS, row]),
                "exceptionTotal": int(totals[C.MetricEvent.EXCEPTION, row]),
                "rtSumMs": int(totals[C.MetricEvent.RT, row]),
                "blockByReason": reasons,
                "rtP50Ms": round(histogram_quantile(hist, 0.50), 2),
                "rtP95Ms": round(histogram_quantile(hist, 0.95), 2),
                "rtP99Ms": round(histogram_quantile(hist, 0.99), 2),
            }
        return {
            "resources": resources,
            "counters": {
                "failOpenCount": self.fail_open_count,
                "clusterFallbackCount": self.cluster_fallback_count,
                "clusterBudgetExhaustedCount":
                    self.cluster_budget_exhausted_count,
            },
            "blockBySlot": slot_bins_to_dict(counts["blockBySlot"]),
            "stepTimer": self.step_timer.snapshot(),
            "pipeline": self.pipeline_stats(),
            # snapshot(limit=0): the counter fields without the entries.
            "traceSampling": {
                k: v for k, v in self.traces.snapshot(limit=0).items()
                if k != "traces"
            },
            "spanSampling": {
                k: v for k, v in self.spans.snapshot(limit=0).items()
                if k != "spans"
            },
        }

    def resilience_stats(self) -> Dict:
        """One ops view of every degradation channel: fail-open passes,
        cluster-rule local fallbacks, the token client's breaker, the
        embedded server's overload and wire snapshots, the rollout
        guardrail, the adaptive loop, the cluster role, and the
        registered health probes with last-success ages. Lock-free: plain
        counter and snapshot reads."""
        from sentinel_tpu_torch import resilience

        now = self.now_ms()
        out: Dict = {
            "failOpenCount": self.fail_open_count,
            "clusterFallbackCount": self.cluster_fallback_count,
            "clusterBudgetExhaustedCount": self.cluster_budget_exhausted_count,
            "clusterOverloadCount": self.cluster_overload_count,
            "clusterWrongSliceCount": self.cluster_wrong_slice_count,
            "clusterEntryBudgetMs": self.cluster_entry_budget_ms,
            "tokenClientBreaker": None,
            "overload": self.cluster.overload_stats(),
            "wire": self.cluster.wire_stats(),
            "rollout": self.rollout.guardrail_state(),
            "clusterHA": self.cluster.ha_stats(),
            "adaptive": self.adaptive.guardrail_state(),
            "probes": {},
        }
        client = self.cluster.token_client
        gate = getattr(client, "health_gate", None)
        if gate is not None:
            out["tokenClientBreaker"] = gate.snapshot()
        for name, snap in resilience.health_snapshot().items():
            for key in ("lastSuccessMs", "lastCheckMs"):
                v = snap.get(key)
                if isinstance(v, (int, float)) and v > 0:
                    snap[key.replace("Ms", "AgeMs")] = max(0, now - int(v))
            out["probes"][name] = snap
        return out

    def tree_dict(self) -> Dict:
        """Call tree rooted at machine-root (command API ``jsonTree``;
        reference: ``FetchJsonTreeCommandHandler``)."""
        totals, threads = self.row_stats()
        metas = self._device_metas()

        def render(row: int) -> Dict:
            m = metas[row]
            t = totals[row]
            succ = float(t[C.MetricEvent.SUCCESS])
            return {
                "id": m.row,
                "resource": m.resource,
                "threadNum": int(threads[row]),
                "passQps": float(t[C.MetricEvent.PASS]),
                "blockQps": float(t[C.MetricEvent.BLOCK]),
                "totalQps": float(t[C.MetricEvent.PASS])
                + float(t[C.MetricEvent.BLOCK]),
                "successQps": succ,
                "exceptionQps": float(t[C.MetricEvent.EXCEPTION]),
                "averageRt": float(t[C.MetricEvent.RT]) / succ
                if succ > 0 else 0.0,
                "children": [render(c) for c in m.children],
            }

        return render(ROOT_ROW)

    def node_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-resource live stats (command-API ``cnode`` source)."""
        totals, threads = self.row_stats()
        out = {}
        for res, row in self._device_resources().items():
            t = totals[row]
            succ = float(t[C.MetricEvent.SUCCESS])
            out[res] = {
                "passQps": float(t[C.MetricEvent.PASS]),
                "blockQps": float(t[C.MetricEvent.BLOCK]),
                "successQps": succ,
                "exceptionQps": float(t[C.MetricEvent.EXCEPTION]),
                "avgRt": float(t[C.MetricEvent.RT]) / succ if succ > 0 else 0.0,
                "curThreadNum": int(threads[row]),
            }
        return out

    # -- flight recorder and the once-per-second fold ------------------------

    def _spill_flight(self, now_ms: Optional[int] = None) -> None:
        """Pull completed seconds off the device ring into the host
        history, then run the hooks that ride the same fold in the
        reference's order: each fresh second into the SLO manager, burn
        evaluation, the waterfall's seal, the telescope's roll, the slot
        table's rebalance, the adaptive loop's tick and the stream
        ledger's eviction. The ring read gathers ONLY the slots newer than
        the last spilled stamp, in one gather and one device-to-host copy
        under the engine lock; the hooks are host work outside it. The
        clock is read under the lock, as :meth:`seal_metrics` reads it.
        While the span recorder is on, the fold is a ``spill`` span of two
        children, ``spill.read`` and ``spill.hooks``."""
        with _prof.span("spill"):
            with _prof.span("spill.read"):
                now, fresh, cols = self._spill_read(now_ms)
            with _prof.span("spill.hooks"):
                self._spill_hooks(now, fresh, cols)

    def _spill_read(self, now_ms: Optional[int]):
        """(now, the fresh ``(stamp, slot)``s, their host columns ``(ev,
        attr, hist, slot)`` or None): the fold's read under the lock."""
        fresh, cols = [], None
        with self._lock, self._on_stream():
            now = now_ms if now_ms is not None else self.now_ms()
            self._ensure_compiled()
            state = self._state
            if state is not None and state.flight is not None:
                # Fold any completed staged second into the ring first, so
                # a read right after a second boundary sees that second.
                self._state = state = S.flush_seconds(state, now)
                ring = state.flight
                stamps = ring.stamps.cpu().numpy()
                last = self.timeseries.last_stamp_ms
                fresh = sorted((int(s), i) for i, s in
                               enumerate(stamps.tolist())
                               if s >= 0 and s > last)
                if fresh:
                    idx = torch.tensor([i for _, i in fresh],
                                       dtype=torch.long, device=self.device)
                    parts = [ring.events[idx], ring.attr[idx],
                             ring.hist[idx], ring.slot_attr[idx]]
                    k = len(fresh)
                    host = torch.cat([p.reshape(k, -1) for p in parts],
                                     dim=1).cpu().numpy()
                    cut = np.cumsum([0] + [p[0].numel() for p in parts])
                    cols = tuple(
                        host[:, cut[j]:cut[j + 1]].reshape(
                            (k,) + tuple(parts[j].shape[1:]))
                        for j in range(4))
        return now, fresh, cols

    def _spill_hooks(self, now: int, fresh, cols) -> None:
        """The fold's host work outside the lock, in the reference's
        order."""
        ev, attr, hist, slot = cols if cols is not None else (None,) * 4
        metas = self._device_metas()
        slots_tbl = self.slots
        for j, (stamp, _i) in enumerate(fresh):
            rec = compact_second(stamp, ev[j], attr[j], hist[j], slot[j])
            self.timeseries.append(rec)
            if slots_tbl is not None:
                # Pin the tenancy this second spilled under: history renders
                # a reused slot's PAST seconds under the evicted occupant.
                slots_tbl.remember_metas(stamp, metas)
            # Judgement rides the spill: every complete second, rendered
            # once, feeds the SLO manager's series and baselines, then the
            # tees (outside the engine lock).
            sec_dict = second_to_dict(rec, metas)
            self.slo.ingest(stamp, sec_dict["resources"])
            for tee in list(self._flight_tees):
                try:
                    tee(sec_dict)
                except Exception:  # noqa: BLE001 — a tee can't stall spill
                    record_log.warn("flight tee %r failed; detaching", tee)
                    self.remove_flight_tee(tee)
        # Burn rules re-evaluate at the newest complete second boundary on
        # EVERY spill, fresh seconds or not (idle decay resolves alerts).
        self.slo.evaluate(now)
        # The waterfall seals its staged seconds after the evaluation, so
        # its sentry's transitions land in the freshly evaluated store.
        self.waterfall.roll(now)
        # The telescope folds its staged observations on the same cadence;
        # the slot table's rebalance follows (the telescope's top-k ranks
        # the challengers), 1/s-throttled and freeze-gated inside.
        self.population.roll(now)
        if slots_tbl is not None:
            slots_tbl.on_spill(now)
        # The adaptive loop once judgement is current (its freeze gate and
        # proposal gate read it); interval-gated and reentry-safe inside.
        self.adaptive.on_spill(now)
        # The stream ledger's hygiene last: leases whose client vanished
        # mid-generation evict (their remainder returns as expiring
        # credit, as an abort's does) and stale credit rolls off.
        for lease in self.streams.evict(now):
            self.streams.add_credit(lease.resource, lease.remaining, now)

    def _observe_population(self, host, batch) -> None:
        """Stage one admission batch's (row, tokens) traffic for the
        telescope: from the host staging dict when the batch came as one,
        else from the CPU tensors, else (device tensors) by non-blocking
        copies into pinned memory behind an event that the fold waits on.
        No device dispatch and no host sync on the dispatch path."""
        population = self.population
        if not population.enabled or self.slots is not None:
            # Slot mode observes at RESOURCE grain in _slot_entry (cold
            # entries never reach a device batch).
            return
        metas = self.registry.meta
        if host is not None:
            population.observe_rows(host["cluster_row"], host["count"],
                                    metas)
        elif batch.cluster_row.device.type == "cpu":
            population.observe_rows(batch.cluster_row.numpy(),
                                    batch.count.numpy(), metas)
        else:
            cols = []
            for t in (batch.cluster_row, batch.count):
                pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned.copy_(t, non_blocking=True)
                cols.append(pinned)
            event = torch.cuda.Event()
            event.record()
            population.observe_rows_staged(cols[0], cols[1], event, metas)

    def population_report(self, slot_budget: int = 1024,
                          now_ms: Optional[int] = None) -> Dict:
        """Admission-readiness projection for a hypothetical slot budget:
        bring the telescope current on the fold it rides, then project
        the hot-set hit rate, eviction rate and cold-tail mass."""
        self._flush_committer()
        self._spill_flight(now_ms)
        return self.population.report(slot_budget)

    def slo_refresh(self, now_ms: Optional[int] = None) -> None:
        """Bring SLO judgement current: land leased commits, then fold and
        spill the completed flight-recorder seconds (which feeds the SLO
        manager) and re-evaluate the burn rules at the newest complete
        second boundary."""
        self._flush_committer()
        self._spill_flight(now_ms)

    def timeseries_view(self, resource: Optional[str] = None,
                        start_ms: Optional[int] = None,
                        end_ms: Optional[int] = None,
                        limit: Optional[int] = None,
                        offset: int = 0,
                        now_ms: Optional[int] = None) -> Dict:
        """Exact per-second telemetry series within the host retention.

        Seconds return in chronological order; ``offset`` / ``limit``
        paginate newest-first (offset 0 ends at the most recent complete
        second). ``resource`` filters each second's per-resource map.
        ``now_ms`` drives the fold boundary (the in-progress second stays
        staged). Runs the fold: the committer's flush, then
        ``_spill_flight``."""
        self._flush_committer()  # leased commits land before the fold
        self._spill_flight(now_ms)
        recs = self.timeseries.query(start_ms, end_ms)
        metas = self._device_metas()
        slots_tbl = self.slots
        if resource is not None and slots_tbl is None:
            row = self._device_row_of(resource)
            recs = ([r for r in recs if row in r.rows]
                    if row is not None else [])
        total = len(recs)
        recs = page_newest_first(recs, limit, offset)
        if slots_tbl is None:
            seconds = [second_to_dict(r, metas, resource) for r in recs]
        else:
            # Each second renders under the tenancy it was RECORDED under.
            seconds = [
                second_to_dict(
                    r, slots_tbl.recall_metas(r.stamp_ms) or metas, resource)
                for r in recs]
            if resource is not None:
                seconds = [s for s in seconds if s.get("resources")]
        return {
            "seconds": seconds,
            "total": total,
            "retainedSeconds": self.timeseries.retained(),
            "recorderSeconds": self.flight_seconds,
        }

    def explain_trace(self, resource: Optional[str] = None,
                      index: int = 0,
                      now_ms: Optional[int] = None) -> Optional[Dict]:
        """Join one sampled blocked-entry trace with the flight-recorder
        second it occurred in: the verdict (reason and rule slot), that
        resource's traffic in that second, and the loaded rules of the
        blocking family. Reconstruction from recorded data, no step
        re-run. None when there is no trace at ``index``."""
        from sentinel_tpu_torch.datasource import converters as CV

        self.traces.drain()
        traces = self.traces.snapshot()["traces"]
        if resource is not None:
            traces = [t for t in traces if t["resource"] == resource]
        index = max(0, int(index))
        if index >= len(traces):
            return None
        tr = traces[index]
        sec_start = tr["timestamp"] - tr["timestamp"] % 1000
        view = self.timeseries_view(resource=tr["resource"],
                                    start_ms=sec_start,
                                    end_ms=sec_start + 1000,
                                    now_ms=now_ms)
        second = view["seconds"][0] if view["seconds"] else None
        fam_rules = {
            "FLOW": (self.flow_rules, CV.flow_rule_to_dict),
            "DEGRADE": (self.degrade_rules, CV.degrade_rule_to_dict),
            "AUTHORITY": (self.authority_rules, CV.authority_rule_to_dict),
            "PARAM_FLOW": (self.param_rules, CV.param_rule_to_dict),
            "SYSTEM": (self.system_rules, CV.system_rule_to_dict),
        }.get(tr["reason"])
        matched = []
        if fam_rules is not None:
            mgr, to_dict = fam_rules
            matched = [to_dict(r) for r in mgr.get_rules()
                       if getattr(r, "resource", tr["resource"])
                       == tr["resource"]]
        res_second = (second or {}).get("resources", {}).get(
            tr["resource"], {})
        return {
            "trace": tr,
            # The full second the entry fell in (None when it predates
            # retention or recording is off).
            "second": second,
            "occupancy": {
                "passThatSecond": res_second.get("pass", 0),
                "blockThatSecond": res_second.get("block", 0),
                "occupiedPassThatSecond": res_second.get("occupiedPass", 0),
                "windowAtTrace": tr.get("window", {}),
            },
            "verdict": {
                "reason": tr["reason"],
                "ruleSlot": tr["ruleSlot"],
                "matchedRules": matched,
            },
        }

    def why_query(self, resource: str,
                  stamp_ms: Optional[int] = None) -> Dict:
        """Forensic "why": join the flight-recorder second at ``stamp_ms``
        with the journal records in force then (the blocking rule and its
        load provenance with the causeSeq chain, the rollout candidate,
        the shard map); see ``telemetry/journal.py:forensic_why``."""
        from sentinel_tpu_torch.telemetry.journal import forensic_why

        return forensic_why(self, resource, stamp_ms)

    # -- slot-table admission (core/slots.py) --------------------------------

    def _slot_entry(self, resource: str, ctx, entry_type: int, count: int,
                    args: Sequence, prioritized: bool) -> EntryHandle:
        """entry() in slot mode. Hot resources run the lease / device
        machinery at their slot row; cold-tail resources degrade LOUDLY:
        leaseable-ruled -> host-exact lease verdict, everything else ->
        counted pass (unenforced if device-only-ruled). Handles carry
        (slot, generation) so exits never land on a reused slot's
        successor."""
        from sentinel_tpu_torch.core.slots import COLD_GEN

        slots = self.slots
        entry_in = entry_type == C.EntryType.IN
        params = tuple(hash_param(a) for a in args[:MAX_PARAMS]) \
            if args else ()
        now = self.now_ms()
        # Intern the name host-side: metadata only, never a device row.
        # Past registry capacity this degrades loudly (overflow counter).
        self.registry.cluster_row(resource, int(entry_type))
        # The telescope drives admit / steal, so it sees EVERY entry at
        # resource grain; cold ones never reach a device batch.
        population = self.population
        if population.enabled:
            population.observe_pairs(((resource, count),))
        cur = slots.current(resource)
        if cur is None:
            cur = slots.try_admit(resource, now)
        fp = self._fastpath
        lease = fp.leases.get(resource)

        if cur is None:
            # ---- cold tail: no slot, no raise ---------------------------
            if lease is not None:
                # Host-exact verdict through the lease: eviction costs
                # stats continuity, never rule fidelity.
                block_reason = lease.admit(count, now, params)
                if block_reason:
                    slots.cold_block(resource, count)
                    slots.note_verdict(resource, -1, COLD_GEN, now // 1000,
                                       "block", block_reason)
                    ctx_mod.auto_exit_context()
                    ex = exception_for_reason(block_reason, resource)
                    log_block(resource, type(ex).__name__, ctx.origin,
                              count, now)
                    raise ex
                slots.cold_pass(resource, count)
            else:
                unenforced = resource in fp.guarded or not fp.unruled
                slots.cold_pass(resource, count, unenforced=unenforced)
            slots.note_verdict(resource, -1, COLD_GEN, now // 1000,
                               "pass", 0)
            handle = EntryHandle(self, resource, ctx, -1, -1, -1, entry_in,
                                 count, params, now_ms=now)
            handle.slot_gen = COLD_GEN
            ctx.entry_stack.append(handle)
            return handle

        slots.hot_hits_total += 1
        slot, gen = cur
        fast_ok = (not self._spi.host_slots()
                   and not self._spi.device_checkers())
        if lease is not None and not prioritized and fast_ok:
            # ---- leased-hot: host verdict, committer commit -------------
            block_reason = lease.admit(count, now, params)
            # Committer BEFORE gate: its lazy construction takes _lock,
            # and the lock order is _lock -> gate, never the reverse.
            committer = self._ensure_committer()
            with slots.gate:
                cur2 = slots._hot.get(resource)
                if cur2 is not None:
                    # Re-translated under the gate: the enqueue can never
                    # target a slot whose tenancy already changed.
                    committer.add_entry(cur2[0], -1, -1, entry_in, count,
                                        block_reason == 0, block_reason)
                    slot, gen = cur2
            if cur2 is None:
                # Evicted between translation and enqueue: the verdict
                # stands (host-exact), the stats tally cold.
                if block_reason:
                    slots.cold_block(resource, count)
                else:
                    slots.cold_pass(resource, count)
            if block_reason:
                slots.note_verdict(resource, slot if cur2 else -1,
                                   gen if cur2 else COLD_GEN, now // 1000,
                                   "block", block_reason)
                ctx_mod.auto_exit_context()
                ex = exception_for_reason(block_reason, resource)
                log_block(resource, type(ex).__name__, ctx.origin, count,
                          now)
                raise ex
            slots.note_verdict(resource, slot if cur2 else -1,
                               gen if cur2 else COLD_GEN, now // 1000,
                               "pass", 0)
            handle = EntryHandle(self, resource, ctx,
                                 cur2[0] if cur2 else -1, -1, -1, entry_in,
                                 count, params, leased=cur2 is not None,
                                 now_ms=now)
            handle.slot_gen = gen if cur2 else COLD_GEN
            ctx.entry_stack.append(handle)
            return handle

        # ---- device path at the slot row --------------------------------
        # SPI host slots keep their veto: a BlockException pre-blocks the
        # device commit.
        pre_blocked = False
        custom_ex = None
        spi_slots = self._spi.host_slots()
        if spi_slots:
            info = self._spi.EntryInfo(
                resource=resource, origin=ctx.origin, count=count,
                entry_type=int(entry_type), prioritized=prioritized,
                args=tuple(args), context_name=ctx.name)
            for spi_slot in spi_slots:
                try:
                    spi_slot.on_entry(info)
                except BlockException as ex:
                    custom_ex, pre_blocked = ex, True
                    break
                except Exception:
                    ctx_mod.auto_exit_context()
                    raise
        if lease is not None:
            # Pending leased commits must land before the device check.
            self._flush_committer()
        skip_cluster, cluster_blocked = self._cluster_token_check(
            resource, count, prioritized, args)
        oid = self.registry.origin_id(ctx.origin)
        fields = dict(
            cluster_row=-1, dn_row=-1, origin_row=-1, origin_id=oid,
            origin_named=oid in self._named_origins.get(resource, ()),
            context_id=self.registry.context_id(ctx.name), count=count,
            prioritized=prioritized, entry_in=entry_in,
            skip_cluster=skip_cluster,
            pre_blocked=pre_blocked or cluster_blocked, params=params)
        reason, wait_us, cur2 = self._slot_submit(resource, fields)
        if custom_ex is not None:
            ctx_mod.auto_exit_context()
            log_block(resource, type(custom_ex).__name__, ctx.origin,
                      count, now)
            raise custom_ex
        if cur2 is None:
            # Tenancy changed between translation and dispatch: nothing
            # committed; serve the entry as a counted cold pass.
            slots.cold_pass(resource, count)
            slots.note_verdict(resource, -1, COLD_GEN, now // 1000,
                               "pass", 0)
            handle = EntryHandle(self, resource, ctx, -1, -1, -1, entry_in,
                                 count, params, now_ms=now)
            handle.slot_gen = COLD_GEN
            ctx.entry_stack.append(handle)
            return handle
        slot, gen = cur2
        if reason > 0 and reason != C.BlockReason.WAIT:
            slots.note_verdict(resource, slot, gen, now // 1000, "block",
                               int(reason))
            ctx_mod.auto_exit_context()
            ex = exception_for_reason(reason, resource)
            log_block(resource, type(ex).__name__, ctx.origin, count,
                      self.now_ms())
            raise ex
        if wait_us > 0:
            time.sleep(wait_us / 1e6)
        if lease is not None:
            lease.add(count, self.now_ms(), params)
        slots.note_verdict(resource, slot, gen, now // 1000, "pass", 0)
        handle = EntryHandle(self, resource, ctx, slot, -1, -1, entry_in,
                             count, params, now_ms=now)
        handle.slot_gen = gen
        ctx.entry_stack.append(handle)
        return handle

    def _slot_submit(self, resource: str, fields: Dict
                     ) -> Tuple[int, int, Optional[Tuple[int, int]]]:
        """Width-1 device dispatch with in-lock tenancy re-validation: the
        slot row is resolved INSIDE ``_lock`` (the surgery holds it), so a
        commit only lands under live tenancy. Returns (reason, wait_us,
        (slot, gen) committed under); (0, 0, None) when the resource went
        cold first (nothing committed)."""
        with self._lock:
            cur = self.slots.current(resource)
            if cur is None:
                return 0, 0, None
            buf = make_entry_batch_np(1)
            stage_row(buf, 0, dict(fields, cluster_row=cur[0]))
            try:
                dec = self._run_entry_batch_locked(buf)
            except DeviceDispatchError as ex:
                self._note_fail_open(str(ex))
                return 0, 0, cur
            return int(dec.reason[0]), int(dec.wait_us[0]), cur

    def _slot_exit(self, handle: EntryHandle, count: int) -> None:
        """_do_exit in slot mode. A resource hot NOW (any generation)
        exits at its CURRENT slot; evicted-and-still-cold exits decrement
        the spill record and tally host-side; cold-path entries always
        tally host-side."""
        from sentinel_tpu_torch.core.slots import COLD_GEN

        slots = self.slots
        now = self.now_ms()
        rt = min(max(0, now - handle.created_ms), C.DEFAULT_MAX_RT_MS)
        if handle.slot_gen == COLD_GEN:
            slots.cold_exit(handle.resource, count, rt, handle.error)
            ctx_mod.auto_exit_context()
            return
        committer = self._committer  # one read: close() nulls it
        if handle.leased and committer is not None:
            with slots.gate:
                cur = slots._hot.get(handle.resource)
                if cur is not None:
                    committer.add_exit(cur[0], -1, -1, handle.entry_in,
                                       count, rt, True, handle.error)
            if cur is None:
                slots.evicted_exit(handle.resource, count, rt,
                                   handle.error, now)
            ctx_mod.auto_exit_context()
            return
        with self._lock:
            cur = slots.current(handle.resource)
            if cur is not None:
                buf = make_exit_batch_np(1)
                stage_row(buf, 0, dict(
                    cluster_row=cur[0], dn_row=-1, origin_row=-1,
                    entry_in=handle.entry_in, count=count, rt_ms=rt,
                    success=True, error=handle.error, params=handle.params))
                try:
                    self._run_exit_batch(buf)
                except DeviceDispatchError as ex:
                    self._note_fail_open(str(ex))
        if cur is None:
            slots.evicted_exit(handle.resource, count, rt, handle.error,
                               now)
        ctx_mod.auto_exit_context()

    def _device_metas(self):
        """Row-indexed meta view of the DEVICE state: the registry in
        fixed-capacity mode, the slot table's tenancy view in slot mode.
        Every reader that renders device rows to names reads through
        here, so a reused slot renders as its CURRENT occupant only."""
        slots = self.slots
        return self.registry.meta if slots is None else slots.device_metas()

    def _device_resources(self) -> Dict[str, int]:
        """resource -> device row of everything with a live device row."""
        slots = self.slots
        return self.registry.resources() if slots is None \
            else slots.resources()

    def _device_row_of(self, resource: str) -> Optional[int]:
        """Current device row of one resource, or None (cold / never
        registered)."""
        slots = self.slots
        if slots is None:
            return self.registry.get_cluster_row(resource)
        return slots.device_row(resource)

    def _rule_registry(self):
        """What the rule compilers resolve rows through: the registry in
        fixed-capacity mode, the slot table's facade in slot mode (a cold
        ruled resource compiles inert; the pins prevent that outside a
        pin overflow)."""
        slots = self.slots
        return self.registry if slots is None else slots.rule_registry_view()

    def _slot_pinned_resources(self) -> set:
        """Resources the compiled rules target, live and the rollout
        candidate's: PINNED hot, since the rule tensors hold their slot
        indices (evicting one would apply its rule to the slot's
        successor)."""
        if self.slots is None:
            return set()
        pinned: set = set()

        def _add(rules) -> None:
            for r in rules:
                res = getattr(r, "resource", "")
                if res:
                    pinned.add(res)
                ref = getattr(r, "ref_resource", "")
                if ref:
                    pinned.add(ref)

        _add(self.flow_rules.get_rules())
        _add(self.degrade_rules.get_rules())
        _add(self.param_rules.get_rules())
        _add(self.authority_rules.get_rules())
        rollout = getattr(self, "rollout", None)
        spec = rollout.device_spec() if rollout is not None else None
        if spec:
            for fam in ("flow", "degrade", "authority", "param"):
                _add(spec.get(fam) or ())
        return pinned

    def _slots_sync_pins(self) -> None:
        """Config-plane hook on every rule push: admit (stealing if
        needed) every newly ruled resource BEFORE its rules compile. If
        pinning changed occupancy, every family re-dirties: the next
        dispatch recompiles against the final mapping."""
        slots = self.slots
        if slots is None:
            return
        before = slots.admits_total
        slots.ensure_pinned(self._slot_pinned_resources(), self.now_ms())
        if slots.admits_total != before:
            with self._config_lock:
                for fam in ("flow", "degrade", "authority", "param"):
                    self._dirty[fam] = True
