"""asyncio adapter (reference: ``sentinel-reactor-adapter``'s
``SentinelReactorTransformer`` — SURVEY.md §2.5): guard coroutines the way
the reactor adapter guards subscriptions — the entry happens on
subscription (here: await), completion/cancellation exits it, and errors
feed exception metrics.

The engine's ``entry()`` may run a device step; ``entry_async``
runs it in the default executor so the event loop never blocks, while the
engine's ContextVar-based context propagates into the coroutine (contexts
work per-task, matching the reference's per-subscription context).

Port of ``sentinel_tpu/adapters/aio.py``. Admission goes through the
module API's default engine (``cuda`` unless ``st.reset(device="cpu")``
built it; raises with no card).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Callable, Optional

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException


async def entry_async(resource: str, entry_type: int = C.EntryType.OUT,
                      count: int = 1, args=()):
    """``await``-able ``SphU.entry``: raises BlockException when rejected.

    Returns the EntryHandle; exit via :func:`exit_async` (or use
    :class:`entry_scope`). ``asyncio.to_thread`` (not run_in_executor)
    so the task's ContextVar context — the engine's Context — propagates
    into the worker thread.

    Cancellation-safe: a worker thread cannot be interrupted, so if the
    awaiting task is cancelled mid-admission the entry may still COMMIT
    afterwards — shielded here, with an undo callback that exits the
    orphaned handle the moment the thread finishes (otherwise a cancelled
    task would leak a concurrency slot forever).
    """
    fut = asyncio.ensure_future(
        asyncio.to_thread(st.entry, resource, entry_type, count, list(args)))
    try:
        return await asyncio.shield(fut)
    except asyncio.CancelledError:
        def _undo(f):
            if not f.cancelled() and f.exception() is None:
                f.result().exit()

        fut.add_done_callback(_undo)
        raise


async def exit_async(handle) -> None:
    """``await``-able exit for explicit callers on uncancelled paths.

    The adapter's own cleanup paths exit SYNCHRONOUSLY instead: awaiting
    inside a cancelled task's ``finally``/``__aexit__`` raises
    CancelledError at the first suspension, which would leak the entry
    (a permanently-held concurrency slot). The sync commit is short —
    acceptable on completion paths; admission stays async.
    """
    await asyncio.to_thread(handle.exit)


class entry_scope:
    """``async with entry_scope("res"):`` — the async twin of
    ``with st.entry("res"):`` (auto-exit + business-exception tracing)."""

    def __init__(self, resource: str, entry_type: int = C.EntryType.OUT,
                 count: int = 1, args=()):
        self.resource = resource
        self.entry_type = entry_type
        self.count = count
        self.args = args
        self._handle = None

    async def __aenter__(self):
        self._handle = await entry_async(self.resource, self.entry_type,
                                         self.count, self.args)
        return self._handle

    async def __aexit__(self, exc_type, exc, tb):
        if self._handle is not None:
            if (exc is not None
                    and not BlockException.is_block_exception(exc)
                    and not isinstance(exc, asyncio.CancelledError)):
                # cancellation is not a service error (a wait_for timeout
                # must not feed an exception-ratio breaker) — same stance
                # as sentinel_coroutine's ignore list
                self._handle.trace(exc)
            self._handle.exit()  # sync: survives task cancellation
        return False


def sentinel_coroutine(value: Optional[str] = None,
                       entry_type: int = C.EntryType.OUT,
                       block_handler: Optional[Callable] = None,
                       fallback: Optional[Callable] = None,
                       default_fallback: Optional[Callable] = None,
                       exceptions_to_ignore=(),
                       args_from: Optional[Callable] = None):
    """The asyncio twin of :func:`~sentinel_tpu_torch.adapters.annotation.
    sentinel_resource`, sharing its exact routing semantics (handlers get
    ``*args, ex=ex, **kwargs``; a nested BlockException routes to the
    block handler untraced) via the same router factory — the differences
    are that admission runs off-loop (``entry_async``) and exit is
    cancellation-proof. Cancellation propagates untraced (it is not a
    service error)."""
    from sentinel_tpu_torch.adapters.annotation import make_routers

    def deco(fn):
        resource = value or f"{fn.__module__}:{fn.__qualname__}"
        on_blocked, on_error = make_routers(
            block_handler, fallback, default_fallback,
            tuple(exceptions_to_ignore) + (asyncio.CancelledError,))

        async def _maybe(out):
            import inspect

            if inspect.isawaitable(out):  # same test as sentinel_resource's
                out = await out
            return out

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            params = args_from(*args, **kwargs) if args_from else args
            try:
                handle = await entry_async(resource, entry_type, args=params)
            except BlockException as ex:
                return await _maybe(on_blocked(ex, args, kwargs))
            try:
                return await fn(*args, **kwargs)
            except BaseException as ex:
                return await _maybe(on_error(handle, ex, args, kwargs))
            finally:
                handle.exit()  # sync: survives task cancellation

        wrapper.__sentinel_resource__ = resource
        return wrapper

    return deco
