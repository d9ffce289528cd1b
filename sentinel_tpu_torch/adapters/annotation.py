"""``@sentinel_resource`` decorator (reference:
``sentinel-annotation-aspectj``'s ``SentinelResourceAspect`` +
``AbstractSentinelAspectSupport`` — SURVEY.md §2.2): wrap a function in an
entry, route ``BlockException`` to the block handler, route traced business
exceptions to the fallback.

Handler resolution mirrors the aspect: ``block_handler`` gets the original
arguments plus the exception as a trailing ``ex=`` kwarg; ``fallback``
likewise. When neither matches, the exception propagates (and business
exceptions are recorded to the entry via ``Tracer`` semantics unless listed
in ``exceptions_to_ignore``).

Port of ``sentinel_tpu/adapters/annotation.py``. Admission goes through
the module API's default engine (``cuda`` unless
``st.reset(device="cpu")`` built it; raises with no card).
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional, Sequence, Tuple, Type

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException


def make_routers(block_handler, fallback, default_fallback,
                 exceptions_to_ignore):
    """(on_blocked, on_error) with the reference aspect's resolution order —
    shared by this decorator and the asyncio variant (adapters/aio.py) so
    their semantics cannot drift."""

    def on_blocked(ex, args, kwargs):
        # Reference resolution order: blockHandler, else the fallback
        # chain may handle BlockException too.
        for handler in (block_handler, fallback, default_fallback):
            if handler is not None:
                return handler(*args, ex=ex, **kwargs)
        raise ex

    def on_error(entry, ex, args, kwargs):
        if isinstance(ex, BlockException):
            # A nested guarded call blocked: route to the block handler,
            # not the business fallback (reference aspect catches
            # BlockException around proceed() too).
            return on_blocked(ex, args, kwargs)
        if not isinstance(ex, exceptions_to_ignore):
            entry.trace(ex)
            handler = fallback or default_fallback
            if handler is not None:
                return handler(*args, ex=ex, **kwargs)
        raise ex

    return on_blocked, on_error


def sentinel_resource(
    value: Optional[str] = None,
    entry_type: int = C.EntryType.OUT,
    resource_type: int = 0,
    block_handler: Optional[Callable] = None,
    fallback: Optional[Callable] = None,
    default_fallback: Optional[Callable] = None,
    exceptions_to_ignore: Tuple[Type[BaseException], ...] = (),
    args_from: Optional[Callable] = None,
):
    """Decorator form of ``@SentinelResource``.

    ``args_from(*args, **kwargs)`` optionally derives the hot-param argument
    list for param-flow rules; by default positional args are used.
    """

    def deco(fn: Callable) -> Callable:
        resource = value or f"{fn.__module__}:{fn.__qualname__}"
        on_blocked, on_error = make_routers(
            block_handler, fallback, default_fallback, exceptions_to_ignore)

        async def _maybe_await(value):
            if inspect.isawaitable(value):  # async handlers are awaited
                return await value
            return value

        if inspect.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def wrapper(*args, **kwargs):
                params = args_from(*args, **kwargs) if args_from else args
                try:
                    entry = st.entry(resource, entry_type=entry_type, args=params)
                except BlockException as ex:
                    return await _maybe_await(on_blocked(ex, args, kwargs))
                try:
                    return await fn(*args, **kwargs)
                except BaseException as ex:
                    return await _maybe_await(on_error(entry, ex, args, kwargs))
                finally:
                    entry.exit()
        else:
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                params = args_from(*args, **kwargs) if args_from else args
                try:
                    entry = st.entry(resource, entry_type=entry_type, args=params)
                except BlockException as ex:
                    return on_blocked(ex, args, kwargs)
                try:
                    return fn(*args, **kwargs)
                except BaseException as ex:
                    return on_error(entry, ex, args, kwargs)
                finally:
                    entry.exit()

        wrapper.__sentinel_resource__ = resource
        return wrapper

    return deco
