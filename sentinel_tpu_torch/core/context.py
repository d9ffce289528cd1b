"""Per-thread call context (port of ``sentinel_tpu/core/context.py``).

Reference: ``core:context/Context.java`` + ``ContextUtil``. A context names
the entrance (call chain root) and carries the caller origin; entries nest
in a stack per thread. Oversized or empty context names yield a
``NullContext``: pass-through entries with no protection, exactly like
the reference (``MAX_CONTEXT_NAME_SIZE``).
"""

from __future__ import annotations

import contextvars
from typing import List, Optional

from sentinel_tpu_torch.core.constants import (CONTEXT_DEFAULT_NAME,
                                               MAX_CONTEXT_NAME_SIZE)

# Bumped on every engine reset: a context created under a previous engine
# holds row ids interned in that engine's registry, and using them against
# a fresh (possibly smaller) registry corrupts stats or raises. The stamp
# invalidates stale contexts on EVERY thread, not just the resetting one.
_generation = 0


def bump_generation() -> None:
    global _generation
    _generation += 1


class Context:
    __slots__ = ("name", "origin", "entry_stack", "entrance_row", "is_null",
                 "auto_created", "generation")

    def __init__(self, name: str, origin: str = "", entrance_row: int = -1):
        self.name = name
        self.origin = origin
        self.entrance_row = entrance_row
        self.entry_stack: List = []
        self.is_null = False
        # True when the engine materialized the default context itself; such
        # contexts are torn down automatically when their last entry exits
        # (reference: default-context auto-exit in CtEntry.trueExit).
        self.auto_created = False
        self.generation = _generation

    @property
    def cur_entry(self):
        return self.entry_stack[-1] if self.entry_stack else None


class NullContext(Context):
    def __init__(self):
        super().__init__("", "")
        self.is_null = True


# A ContextVar isolates the call context per thread AND per asyncio task.
_ctx_var: contextvars.ContextVar[Optional[Context]] = contextvars.ContextVar(
    "sentinel_torch_context", default=None)


def get_context() -> Optional[Context]:
    ctx = _ctx_var.get()
    if ctx is not None and ctx.generation != _generation:
        _ctx_var.set(None)  # stale: predates the current engine
        return None
    return ctx


def enter(name: str = CONTEXT_DEFAULT_NAME, origin: str = "") -> Context:
    """``ContextUtil.enter``. Idempotent for the same name on one thread."""
    ctx = get_context()
    if ctx is not None and not ctx.is_null:
        return ctx
    if len(name) > MAX_CONTEXT_NAME_SIZE or not name:
        ctx = NullContext()
    else:
        ctx = Context(name, origin)
    _ctx_var.set(ctx)
    return ctx


# Pool of ONE auto-created default context per thread/task, so an entry
# with no explicit context neither allocates a Context nor re-resolves its
# entrance row on every entry/exit pair. The pooled object is reused only
# when its entry stack drained and its generation is current.
_auto_pool: contextvars.ContextVar[Optional[Context]] = contextvars.ContextVar(
    "sentinel_torch_auto_context", default=None)


def enter_auto() -> Context:
    """Engine-internal: materialize (or reuse) the auto default context."""
    ctx = _auto_pool.get()
    if (ctx is None or ctx.generation != _generation or ctx.entry_stack
            or ctx.origin):
        ctx = Context(CONTEXT_DEFAULT_NAME, "")
        ctx.auto_created = True
        _auto_pool.set(ctx)
    _ctx_var.set(ctx)
    return ctx


def exit_context() -> None:
    """``ContextUtil.exit``: drop the context if no entries remain."""
    ctx = get_context()
    if ctx is not None and not ctx.entry_stack:
        _ctx_var.set(None)


def auto_exit_context() -> None:
    """Drop only an engine-created default context once its entries drain."""
    ctx = get_context()
    if ctx is not None and ctx.auto_created and not ctx.entry_stack:
        _ctx_var.set(None)


def replace_context(ctx: Optional[Context]) -> None:
    _ctx_var.set(ctx)
