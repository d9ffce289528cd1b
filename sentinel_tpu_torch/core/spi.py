"""SPI / extension mechanism, host half (port of
``sentinel_tpu/core/spi.py``: init funcs and host slots).

Reference: ``core:init/InitFunc`` + ``@InitOrder`` + ``spi/SpiLoader``.

  * **Init funcs**: ``@init_func(order=...)`` callables (plus anything on
    the ``sentinel_tpu_torch.init_funcs`` entry-point group) run exactly
    once, when the module API installs its first default engine
    (``InitExecutor.doInit`` firing on the first ``SphU.entry``).
  * **Host slots**: :class:`ProcessorSlot` objects whose ``on_entry`` /
    ``on_exit`` hooks wrap every ``engine.entry()`` call. ``on_entry`` may
    raise a ``BlockException`` subclass to reject the request; the engine
    commits the block to statistics before the exception reaches the
    caller. Discovered from the ``sentinel_tpu_torch.slots`` entry-point
    group or registered directly.

Device checkers (a function spliced into the fused step) are not part of
this package yet: :func:`device_checkers` returns ``()``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

_lock = threading.RLock()

INIT_FUNCS_GROUP = "sentinel_tpu_torch.init_funcs"
SLOTS_GROUP = "sentinel_tpu_torch.slots"


def _entry_points(group: str):
    try:
        from importlib.metadata import entry_points

        return list(entry_points(group=group))
    except Exception:  # noqa: BLE001 — a broken distribution loads nothing
        return []


# ---------------------------------------------------------------------------
# Init funcs
# ---------------------------------------------------------------------------

_init_funcs: List[Tuple[int, Callable[[], None]]] = []
_init_done = False
_init_complete = threading.Event()
_init_thread: Optional[threading.Thread] = None


def init_func(order: int = 0):
    """Register a one-shot boot hook (reference: ``@InitOrder`` +
    ``InitFunc``). Runs when the first default engine is installed;
    registering after boot runs the hook immediately."""

    def deco(fn: Callable[[], None]):
        with _lock:
            if _init_done:
                fn()
            else:
                _init_funcs.append((order, fn))
        return fn

    return deco


def run_init_funcs() -> None:
    """Idempotent ``InitExecutor.doInit``: entry-point group first, then
    registered funcs, ordered. Losers of the boot race wait until the
    winner's hooks finish; a hook calling back into this module from the
    boot thread returns at once instead of deadlocking."""
    global _init_done, _init_thread
    with _lock:
        if _init_done:
            runner = False
        else:
            _init_done = True
            _init_thread = threading.current_thread()
            runner = True
            for ep in _entry_points(INIT_FUNCS_GROUP):
                try:
                    fn = ep.load()
                    _init_funcs.append((getattr(fn, "__init_order__", 0), fn))
                except Exception:  # noqa: BLE001 — logged, boot goes on
                    from sentinel_tpu_torch.log.record_log import record_log

                    record_log.warn("init entry point %s failed to load", ep)
            funcs = sorted(_init_funcs, key=lambda t: t[0])
    if not runner:
        if threading.current_thread() is _init_thread:
            return  # re-entrant call from inside an init func
        _init_complete.wait(timeout=60)
        return
    try:
        for _, fn in funcs:
            try:
                fn()
            except Exception as ex:  # noqa: BLE001 — logged, boot goes on
                from sentinel_tpu_torch.log.record_log import record_log

                record_log.warn("init func %r failed: %r", fn, ex)
    finally:
        _init_complete.set()


# ---------------------------------------------------------------------------
# Host slots
# ---------------------------------------------------------------------------


@dataclass
class EntryInfo:
    """What a host slot sees (reference: the slot-chain arguments)."""

    resource: str
    origin: str
    count: int
    entry_type: int
    prioritized: bool
    args: Sequence
    context_name: str


class ProcessorSlot:
    """Host-side custom slot. Subclass and override either hook."""

    def on_entry(self, info: EntryInfo) -> None:
        """Raise a BlockException subclass to reject the entry."""

    def on_exit(self, info: EntryInfo, rt_ms: int, error: bool) -> None:
        pass


_slots: List[Tuple[int, ProcessorSlot]] = []
_slots_loaded = False
# Immutable snapshot read lock-free on the hot path, rebuilt under the
# lock on every mutation: a deployment with no slot pays one tuple read
# per entry and exit.
_slots_cache: Tuple[ProcessorSlot, ...] = ()


def _rebuild_slot_cache() -> None:
    global _slots_cache
    _slots.sort(key=lambda t: t[0])
    _slots_cache = tuple(s for _, s in _slots)


def register_slot(slot: ProcessorSlot, order: int = 0) -> None:
    with _lock:
        _slots.append((order, slot))
        _rebuild_slot_cache()


def unregister_slot(slot: ProcessorSlot) -> None:
    with _lock:
        _slots[:] = [(o, s) for o, s in _slots if s is not slot]
        _rebuild_slot_cache()


def _load_slot_entry_points() -> None:
    global _slots_loaded
    with _lock:
        if _slots_loaded:
            return
        _slots_loaded = True
        for ep in _entry_points(SLOTS_GROUP):
            try:
                slot = ep.load()()
                _slots.append((getattr(slot, "__slot_order__", 0), slot))
            except Exception:  # noqa: BLE001 — logged, loading goes on
                from sentinel_tpu_torch.log.record_log import record_log

                record_log.warn("slot entry point %s failed to load", ep)
        _rebuild_slot_cache()


def host_slots() -> Tuple[ProcessorSlot, ...]:
    if not _slots_loaded:
        _load_slot_entry_points()
    return _slots_cache


def device_checkers() -> Tuple[Callable, ...]:
    """Device checkers spliced into the fused step: none in this package
    yet, so the fast paths never stand down for one."""
    return ()
