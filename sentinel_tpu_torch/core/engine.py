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

What it does not have yet (later slices): the slot table, the cluster
token check, shadow lanes and the flight recorder, SPI device checkers,
checkpoints.

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
    make_entry_batch_np, make_exit_batch_np, stage_row, to_device)
from sentinel_tpu_torch.core.config import (
    DEFAULT_PROFILE_SYNC_EVERY, PROFILE_SYNC_EVERY, config)
from sentinel_tpu_torch.core.exceptions import (
    BlockException, exception_for_reason)
from sentinel_tpu_torch.core.registry import (
    KIND_CLUSTER, ROOT_ROW, NodeRegistry)
from sentinel_tpu_torch.log.record_log import log_block, record_log
from sentinel_tpu_torch.metrics.profiling import StepTimer, timed_call
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.native import load_lease_ext
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.ops import window as W
from sentinel_tpu_torch.telemetry.trace_ring import DecisionTraceBuffer
from sentinel_tpu_torch.utils import time_util
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.param_hash import hash_param

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
        "params", "leased",
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

    def __init__(self, capacity: int = 4096, device=None, clock=None):
        self.device = resolve_device(device)
        # The one stream every dispatch and state read runs on (None on
        # the CPU).
        self._stream = None
        if self.device.type == "cuda":
            from sentinel_tpu_torch.ops import prefix_cuda

            prefix_cuda.build()
            self._stream = torch.cuda.default_stream(self.device)
        self.capacity = capacity
        self.registry = NodeRegistry(capacity)
        # None = the process clock (time_util, which tests may freeze); a
        # callable = this engine's private timebase.
        self._clock = clock
        self._spec1 = S.SPEC_1S
        self._occupy_timeout_ms = C.DEFAULT_OCCUPY_TIMEOUT_MS
        # Global kill switch (reference: Constants.ON). Off => every entry
        # passes unguarded.
        self.enabled = True
        self.system_status = Y.SystemStatusListener()
        self._signals_refreshed_ms = 0
        self._sealed_sec = self.now_ms() // 1000 - 1
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
        self._state: Optional[S.SentinelState] = None
        self._rules: Optional[S.RulePack] = None
        self._named_origins: Dict[str, set] = {}
        self._slot_floor = dict(INITIAL_SLOT_FLOOR)
        self._dirty = {k: False for k in
                       ("flow", "degrade", "authority", "system", "param")}
        self._spi = spi_mod
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
        gates the metric log, and the signal and fail-open-log throttles
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
            self._fastpath = _FastPathState({}, frozenset(),
                                            self.lease_enabled)
            self._rebuild_leases()

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
                row = self.registry.get_cluster_row(res)
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
            if family == "flow":
                # entry() reads the named-origin map before any compile.
                self._named_origins = F.named_origin_map(
                    self.flow_rules.get_rules(), self.registry)
            self._rebuild_leases()

    def _ratchet_slots(self, **tensors) -> None:
        for family, rt in tensors.items():
            self._slot_floor[family] = max(self._slot_floor[family], rt.slots)

    def _compile_flow(self):
        ft, named = F.compile_flow_rules(
            self.flow_rules.get_rules(), self.registry, self.capacity,
            min_slots=self._slot_floor["flow"], device=self.device)
        self._ratchet_slots(flow=ft)
        self._named_origins = {r: set(o) for r, o in named.items()}
        return ft

    def _compile_degrade(self):
        dt, di = D.compile_degrade_rules(
            self.degrade_rules.get_rules(), self.registry, self.capacity,
            min_slots=self._slot_floor["degrade"], device=self.device)
        self._ratchet_slots(degrade=dt)
        return dt, di

    def _compile_authority(self):
        at = A.compile_authority_rules(
            self.authority_rules.get_rules(), self.registry, self.capacity,
            min_slots=self._slot_floor["authority"], device=self.device)
        self._ratchet_slots(authority=at)
        return at

    def _compile_param(self):
        pt = P.compile_param_rules(
            self.param_rules.get_rules(), self.registry, self.capacity,
            min_slots=self._slot_floor["param"], device=self.device)
        self._ratchet_slots(param=pt)
        return pt

    def _ensure_compiled(self) -> None:
        """(Re)build rule tensors + state after a config push. Each family
        rebuilds independently: a flow push re-creates flow controller
        state but keeps breaker state, and vice versa; node stats always
        survive. Dirty flags clear before their rules are read, so a push
        landing mid-compile is never lost."""
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
                spec1=self._spec1, device=self.device)
            self._maybe_start_system_listener()
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

    # -- device steps --------------------------------------------------------

    def _as_batch(self, batch, cls):
        if isinstance(batch, dict):
            return to_device(batch, self.device)
        if not isinstance(batch, cls):
            raise TypeError(f"expected {cls.__name__} or a numpy staging dict")
        return batch

    def _run_entry_batch_locked(self, batch, now_ms: Optional[int] = None
                                ) -> Decisions:
        host = batch if isinstance(batch, dict) else None
        with self._on_stream():
            batch = self._as_batch(batch, EntryBatch)
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            self._refresh_signals(now)
            try:
                self._state, dec = timed_call(
                    self.step_timer, "entry", batch.size, self._sync,
                    self._entry_step, self._state, self._rules, batch, now,
                    spec1=self._spec1,
                    occupy_timeout_ms=self._occupy_timeout_ms)
            except Exception as ex:  # noqa: BLE001 — the state may be consumed
                self._state = None  # restart cold: rules durable, stats not
                raise DeviceDispatchError(
                    f"entry dispatch failed: {ex!r:.200}") from ex
            # Sampled decision traces: a snapshot and a hand-off only; the
            # pump reads it off this thread. The host staging columns are
            # read when the batch came as one.
            self.traces.submit(host if host is not None else batch, dec, now)
        return dec

    def _run_entry_batch(self, batch) -> Decisions:
        with self._lock:
            return self._run_entry_batch_locked(batch)

    def _run_exit_batch(self, batch, now_ms: Optional[int] = None) -> None:
        with self._on_stream():
            batch = self._as_batch(batch, ExitBatch)
        with self._lock, self._on_stream():
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            try:
                self._state = timed_call(
                    self.step_timer, "exit", batch.size, self._sync,
                    self._exit_step, self._state, self._rules, batch, now,
                    spec1=self._spec1)
            except Exception as ex:  # noqa: BLE001
                self._state = None
                raise DeviceDispatchError(
                    f"exit dispatch failed: {ex!r:.200}") from ex

    @property
    def _sync(self):
        """Wait for the engine's stream (the step timer's sampled wall);
        None on the CPU, where a step has finished when it returns."""
        return self._stream.synchronize if self._stream is not None else None

    # -- batch API -----------------------------------------------------------

    def check_batch(self, batch, now_ms: Optional[int] = None) -> Decisions:
        """One admission step over a batch (``EntryBatch`` of tensors on
        this engine's device, or a ``make_entry_batch_np`` dict)."""
        with self._lock:
            return self._run_entry_batch_locked(batch, now_ms)

    def complete_batch(self, batch, now_ms: Optional[int] = None) -> None:
        """One completion step (``ExitBatch`` or a numpy staging dict)."""
        self._run_exit_batch(batch, now_ms)

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
        pipeline, then the OS sampler and the trace pump.

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
        self.traces.stop()

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
        reason, wait_us = self._submit_entry(
            resource, cluster_row, dn_row, origin_row, origin_id,
            reg.context_id(ctx.name), count, prioritized, entry_in, params)
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
                      params, pre_blocked=False) -> Tuple[int, int]:
        """One entry's device verdict, (reason, wait_us): a ticket of the
        pipeline's when it runs, else one width-1 step. A failed step or
        cycle fails open, counted."""
        fields = dict(
            cluster_row=cluster_row, dn_row=dn_row, origin_row=origin_row,
            origin_id=origin_id,
            origin_named=origin_id in self._named_origins.get(resource, ()),
            context_id=context_id, count=count, prioritized=prioritized,
            entry_in=entry_in, skip_cluster=False, pre_blocked=pre_blocked,
            params=params)
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

    def _do_exit(self, handle: EntryHandle, count: int) -> None:
        ctx = handle.context
        if ctx.entry_stack and ctx.entry_stack[-1] is handle:
            ctx.entry_stack.pop()
        elif handle in ctx.entry_stack:
            ctx.entry_stack.remove(handle)
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
        are skipped."""
        from sentinel_tpu_torch.metrics.metric_node import MetricNode

        now = now_ms if now_ms is not None else self.now_ms()
        now_sec = now // 1000
        self._flush_committer()  # leased commits land before sealing
        with self._lock, self._on_stream():
            self._ensure_compiled()
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
            metas = self.registry.meta
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

    def tree_dict(self) -> Dict:
        """Call tree rooted at machine-root (command API ``jsonTree``;
        reference: ``FetchJsonTreeCommandHandler``)."""
        totals, threads = self.row_stats()
        metas = self.registry.meta

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
        for res, row in self.registry.resources().items():
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
