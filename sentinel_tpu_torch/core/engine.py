"""A slim engine around the fused step (the main-path part of
``sentinel_tpu/core/engine.py``).

What it has: rule loading for the five families with per-family
recompilation on push (mirroring the JAX engine's ``_ensure_compiled``
and its slot-floor ratchet), the batch API (``check_batch`` /
``complete_batch`` / ``harvest_decisions``) and a width-1 ``entry`` that
raises the typed ``BlockException`` subclasses and whose handle's
``exit()`` commits the completion.

What it does not have yet (later slices): the host token lease, the slot
table, the context tree, the pipeline, the cluster path, SPI slots, the
system-status sampler (the caller sets load / CPU with
``set_system_signals``; -1 means not sampled), metric sealing and the
telemetry readers.

Device: ``cuda`` unless the caller passes ``device="cpu"``; with no card
and no explicit device the constructor raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.batch import (
    MAX_PARAMS, Decisions, EntryBatch, ExitBatch, make_entry_batch_np,
    make_exit_batch_np, to_device)
from sentinel_tpu_torch.core.exceptions import (
    BlockException, exception_for_reason)
from sentinel_tpu_torch.core.registry import NodeRegistry
from sentinel_tpu_torch.models import authority as A
from sentinel_tpu_torch.models import degrade as D
from sentinel_tpu_torch.models import flow as F
from sentinel_tpu_torch.models import param_flow as P
from sentinel_tpu_torch.models import system as Y
from sentinel_tpu_torch.ops import step as S
from sentinel_tpu_torch.utils.device import resolve_device
from sentinel_tpu_torch.utils.param_hash import hash_param

# Per-family slot-count floors at construction (the JAX engine's values).
INITIAL_SLOT_FLOOR = {"flow": 1, "degrade": 0, "authority": 0, "param": 0}


class EntryHandle:
    """A live entry (reference: ``CtEntry``). Use as a context manager."""

    __slots__ = ("engine", "resource", "cluster_row", "dn_row", "origin_row",
                 "entry_in", "count", "created_ms", "error", "exited",
                 "params")

    def __init__(self, engine, resource, cluster_row, dn_row, origin_row,
                 entry_in, count, params, now_ms):
        self.engine = engine
        self.resource = resource
        self.cluster_row = cluster_row
        self.dn_row = dn_row
        self.origin_row = origin_row
        self.entry_in = entry_in
        self.count = count
        self.created_ms = now_ms
        self.error = False
        self.exited = False
        self.params = params

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
    """Owns the device state and compiled rules; thread-safe via one lock."""

    def __init__(self, capacity: int = 4096, device=None, clock=None):
        self.device = resolve_device(device)
        self.capacity = capacity
        self.registry = NodeRegistry(capacity)
        self._clock = clock
        self._spec1 = S.SPEC_1S
        self._occupy_timeout_ms = C.DEFAULT_OCCUPY_TIMEOUT_MS
        self._lock = threading.RLock()
        self._state: Optional[S.SentinelState] = None
        self._rules: Optional[S.RulePack] = None
        self._named_origins: Dict[str, set] = {}
        self._sys_signals = (-1.0, -1.0)
        self._slot_floor = dict(INITIAL_SLOT_FLOOR)
        self._dirty = {k: False for k in
                       ("flow", "degrade", "authority", "system", "param")}
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
        if self._clock is not None:
            return int(self._clock())
        return int(time.time() * 1000)

    def set_system_signals(self, load1: float = -1.0,
                           cpu_usage: float = -1.0) -> None:
        """Host OS signals for the system rules' load / CPU checks (-1 =
        not sampled, which never blocks)."""
        with self._lock:
            self._sys_signals = (float(load1), float(cpu_usage))
            if self._state is not None:
                self._state = self._state._replace(
                    sys_signals=self._signals_tensor())

    def _signals_tensor(self) -> torch.Tensor:
        return torch.tensor(self._sys_signals, dtype=torch.float32,
                            device=self.device)

    @property
    def state(self) -> Optional[S.SentinelState]:
        return self._state

    @property
    def rules(self) -> Optional[S.RulePack]:
        return self._rules

    # -- rule compilation --------------------------------------------------

    def _mark_dirty(self, family: str) -> None:
        self._dirty[family] = True
        if family == "flow":
            # entry() reads the named-origin map before any compile.
            self._named_origins = F.named_origin_map(
                self.flow_rules.get_rules(), self.registry)

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
        survive. Dirty flags clear before their rules are read."""
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
            state = S.make_state(
                self.capacity, ft.num_rules, now,
                degrade=D.make_degrade_state(dt, di),
                param=P.make_param_state(pt.num_rules, device=self.device),
                spec1=self._spec1, device=self.device)
            self._state = state._replace(sys_signals=self._signals_tensor())
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
        if self._dirty["param"]:
            self._dirty["param"] = False
            pt = self._compile_param()
            self._rules = self._rules._replace(param=pt)
            self._state = self._state._replace(
                param=P.make_param_state(pt.num_rules, device=self.device))

    # -- batch API -----------------------------------------------------------

    def _as_batch(self, batch, cls):
        if isinstance(batch, dict):
            return to_device(batch, self.device)
        if not isinstance(batch, cls):
            raise TypeError(f"expected {cls.__name__} or a numpy staging dict")
        return batch

    def check_batch(self, batch, now_ms: Optional[int] = None) -> Decisions:
        """One admission step over a batch (``EntryBatch`` of tensors on
        this engine's device, or a ``make_entry_batch_np`` dict)."""
        batch = self._as_batch(batch, EntryBatch)
        with self._lock:
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            self._state, dec = S.entry_step(
                self._state, self._rules, batch, now, spec1=self._spec1,
                occupy_timeout_ms=self._occupy_timeout_ms)
            return dec

    def complete_batch(self, batch, now_ms: Optional[int] = None) -> None:
        """One completion step (``ExitBatch`` or a numpy staging dict)."""
        batch = self._as_batch(batch, ExitBatch)
        with self._lock:
            self._ensure_compiled()
            now = now_ms if now_ms is not None else self.now_ms()
            self._state = S.exit_step(self._state, self._rules, batch, now,
                                      spec1=self._spec1)

    def harvest_decisions(self, dec: Decisions
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a step's verdicts on the host: (reason, wait_us)."""
        return dec.reason.cpu().numpy(), dec.wait_us.cpu().numpy()

    # -- width-1 API ---------------------------------------------------------

    def entry(self, resource: str, count: int = 1, origin: str = "",
              args: Sequence = (), entry_type: int = C.EntryType.OUT,
              prioritized: bool = False) -> EntryHandle:
        """``SphU.entry``: admit or raise a ``BlockException`` subclass."""
        if count > C.MAX_ACQUIRE_COUNT:
            raise ValueError(
                f"count={count} exceeds MAX_ACQUIRE_COUNT={C.MAX_ACQUIRE_COUNT}")
        reg = self.registry
        ctx = C.CONTEXT_DEFAULT_NAME
        entrance = reg.entrance_row(ctx)
        entry_in = entry_type == C.EntryType.IN
        cluster_row, dn_row, origin_row, origin_id = reg.resolve_entry(
            resource, ctx, origin, entrance, int(entry_type))
        now = self.now_ms()
        if cluster_row < 0:
            # Registry full: pass-through, like the reference's chain cap.
            return EntryHandle(self, resource, -1, -1, -1, entry_in, count,
                               (), now)
        params = tuple(hash_param(a) for a in args[:MAX_PARAMS])
        buf = make_entry_batch_np(1)
        buf["cluster_row"][0] = cluster_row
        buf["dn_row"][0] = dn_row
        buf["origin_row"][0] = origin_row
        buf["origin_id"][0] = origin_id
        buf["origin_named"][0] = origin_id in self._named_origins.get(
            resource, ())
        buf["context_id"][0] = reg.context_id(ctx)
        buf["count"][0] = count
        buf["prioritized"][0] = prioritized
        buf["entry_in"][0] = entry_in
        for i, h in enumerate(params):
            buf["param_hash"][0, i] = h
            buf["param_present"][0, i] = True
        reason, wait_us = self.harvest_decisions(self.check_batch(buf, now))
        reason, wait_us = int(reason[0]), int(wait_us[0])
        if reason > 0 and reason != C.BlockReason.WAIT:
            raise exception_for_reason(reason, resource)
        if wait_us > 0:
            time.sleep(wait_us / 1e6)
        return EntryHandle(self, resource, cluster_row, dn_row, origin_row,
                           entry_in, count, params, now)

    def _do_exit(self, handle: EntryHandle, count: int) -> None:
        if handle.cluster_row < 0:
            return
        now = self.now_ms()
        rt = max(0, now - handle.created_ms)
        buf = make_exit_batch_np(1)
        buf["cluster_row"][0] = handle.cluster_row
        buf["dn_row"][0] = handle.dn_row
        buf["origin_row"][0] = handle.origin_row
        buf["entry_in"][0] = handle.entry_in
        buf["count"][0] = count
        buf["rt_ms"][0] = min(rt, C.DEFAULT_MAX_RT_MS)
        buf["success"][0] = True
        buf["error"][0] = handle.error
        for i, h in enumerate(handle.params):
            buf["param_hash"][0, i] = h
            buf["param_present"][0, i] = True
        self.complete_batch(buf, now)
