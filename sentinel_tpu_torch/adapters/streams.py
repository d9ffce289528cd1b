"""Async-stream adapter (reference: ``sentinel-reactor-adapter``'s
``SentinelReactorTransformer`` / ``SentinelReactorSubscriber`` —
SURVEY.md §2.5).

The reactor adapter guards a *subscription*: the entry happens when the
subscriber subscribes (an ``AsyncEntry`` around the whole stream, not one
per element), a rejection surfaces as ``onError(BlockException)``, the
entry exits on terminate (complete | error | cancel), and stream errors
feed exception metrics. Python's twin of a ``Flux`` is the async
iterator, and the twin of "subscribe time" is the first ``__anext__``
pull — so :func:`guard_aiter` wraps any async iterable and defers
admission to the first pull, and :func:`sentinel_stream` decorates async
generator functions wholesale.

Port of ``sentinel_tpu/adapters/streams.py``.
"""

from __future__ import annotations

import asyncio
import functools
from typing import AsyncIterable, AsyncIterator, Callable, Optional

from sentinel_tpu_torch.adapters.aio import entry_async
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException


async def guard_aiter(resource: str, source: AsyncIterable,
                      entry_type: int = C.EntryType.OUT,
                      count: int = 1, args=()) -> AsyncIterator:
    """Guard an async iterable as ONE entry spanning the whole stream.

    Admission runs at the first pull (= subscribe time): a rejected
    stream raises ``BlockException`` out of the first ``__anext__``, so
    the consumer's except-clause is the ``onError`` hook. Business
    errors raised by the source are traced (exception metrics + breaker
    food), cancellation/abandonment is not (it exits the entry but feeds
    no error, like a reactor ``cancel()``).
    """
    handle = await entry_async(resource, entry_type, count, args)
    try:
        async for item in source:
            yield item
    except BaseException as ex:
        if not BlockException.is_block_exception(ex) and not isinstance(
                ex, (asyncio.CancelledError, GeneratorExit)):
            handle.trace(ex)
        raise
    finally:
        # Sync exit FIRST: it cannot be interrupted, so the concurrency
        # slot is released even if the awaited cleanup below is itself
        # cancelled (see adapters/aio.py on cancellation-proof exits).
        handle.exit()
        # Then propagate the cancel upstream (the reactor adapter cancels
        # its upstream subscription): aclose the source NOW so its finally
        # blocks run at abandonment time, not at GC. Awaiting inside an
        # async generator's GeneratorExit path is legal while not yielding.
        aclose = getattr(source, "aclose", None)
        if aclose is not None:
            await aclose()


def sentinel_stream(value: Optional[str] = None,
                    entry_type: int = C.EntryType.OUT,
                    args_from: Optional[Callable] = None):
    """Decorator form for async generator functions: the stream analog of
    ``@sentinel_coroutine`` (no handler routing — stream consumers handle
    ``BlockException`` where they iterate, as reactor subscribers do in
    ``onError``)."""

    def deco(fn):
        resource = value or f"{fn.__module__}:{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*fargs, **kwargs):
            params = args_from(*fargs, **kwargs) if args_from else ()
            return guard_aiter(resource, fn(*fargs, **kwargs),
                               entry_type, args=params)

        wrapper.__sentinel_resource__ = resource
        return wrapper

    return deco
