"""WSGI middleware (reference: ``sentinel-web-servlet``'s ``CommonFilter`` +
``WebCallbackManager`` — SURVEY.md §2.5): each request enters a web context
with the parsed caller origin and an entry named by the (cleaned) URL path;
blocked requests get a 429 by default.

Port of ``sentinel_tpu/adapters/wsgi.py``. Admission goes through the
module API's default engine (``cuda`` unless ``st.reset(device="cpu")``
built it; raises with no card).
"""

from __future__ import annotations

from typing import Callable, Optional

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException

WEB_CONTEXT_NAME = "sentinel_web_context"
DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"


def enter_web_entries(resource: str, origin: str,
                      total_resource: Optional[str]):
    """Shared web-adapter choreography (WSGI + Django middlewares):
    enter the web context, make the CommonTotalFilter-style aggregate
    entry then the resource entry, and return ``(entries, cleanup)``.
    On a BlockException any partial entries AND the context are rolled
    back before the exception propagates to the adapter's block handler.
    ``cleanup`` must be called exactly once, after the response body is
    fully produced (streaming bodies defer it to exhaustion/close)."""
    st.context_enter(WEB_CONTEXT_NAME, origin)
    entries = []

    def cleanup():
        for e in reversed(entries):
            e.exit()
        st.exit_context()

    try:
        if total_resource:
            entries.append(st.entry(total_resource, entry_type=C.EntryType.IN))
        if resource:
            entries.append(st.entry(resource, entry_type=C.EntryType.IN))
    except BaseException:
        # BlockException AND unexpected errors (an SPI host slot raising,
        # say) both roll back: a leaked partial entry would pin the
        # aggregate resource's thread gauge and leave the web context on
        # the worker thread for the NEXT request.
        cleanup()
        raise
    return entries, cleanup


class SentinelWSGIMiddleware:
    def __init__(
        self,
        app,
        url_cleaner: Optional[Callable[[str], str]] = None,
        origin_parser: Optional[Callable[[dict], str]] = None,
        block_handler: Optional[Callable] = None,
        total_resource: Optional[str] = None,
    ):
        """``url_cleaner`` maps raw paths to resource names (UrlCleaner);
        ``origin_parser(environ)`` extracts the caller origin
        (RequestOriginParser); ``block_handler(environ, start_response, ex)``
        overrides the 429 response (UrlBlockHandler). ``total_resource``
        adds a CommonTotalFilter-style aggregate entry when set."""
        self.app = app
        self.url_cleaner = url_cleaner or (lambda p: p)
        self.origin_parser = origin_parser or (lambda environ: "")
        self.block_handler = block_handler
        self.total_resource = total_resource

    def __call__(self, environ, start_response):
        path = environ.get("PATH_INFO", "/")
        resource = self.url_cleaner(path)
        origin = self.origin_parser(environ)
        try:
            entries, cleanup = enter_web_entries(resource, origin,
                                                 self.total_resource)
        except BlockException as ex:
            if self.block_handler is not None:
                return self.block_handler(environ, start_response, ex)
            start_response("429 Too Many Requests",
                           [("Content-Type", "text/plain")])
            return [DEFAULT_BLOCK_BODY]
        try:
            result = self.app(environ, start_response)
        except BaseException as ex:
            for e in entries:
                e.trace(ex)
            cleanup()
            raise
        # Entries stay live while the (possibly streaming) body is
        # consumed — RT covers body generation and mid-stream errors
        # are traced (reference CommonFilter completes after the chain).
        return _GuardedIterable(result, entries, cleanup)


class _GuardedIterable:
    """Wraps the app's response iterable; exits entries on exhaustion/close."""

    def __init__(self, result, entries, cleanup):
        self._result = result
        self._entries = entries
        self._cleanup = cleanup
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._cleanup()

    def __iter__(self):
        try:
            for chunk in self._result:
                yield chunk
        except BaseException as ex:
            for e in self._entries:
                e.trace(ex)
            raise
        finally:
            self._finish()

    def close(self):
        try:
            close = getattr(self._result, "close", None)
            if close is not None:
                close()
        finally:
            self._finish()
