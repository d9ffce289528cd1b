"""ASGI middleware (reference: ``sentinel-spring-webflux-adapter``'s
``SentinelWebFluxFilter`` + ``SentinelBlockExceptionHandler`` — SURVEY.md
§2.5): the async-web analog of the WSGI filter. The admission check itself
is a fast device micro-step, invoked inline (the reference's reactive
subscriber likewise performs the entry on the subscription signal).

Port of ``sentinel_tpu/adapters/asgi.py``. Admission goes through the
module API's default engine (``cuda`` unless ``st.reset(device="cpu")``
built it; raises with no card). The call context is the port's
``ContextVar`` (``core/context.py``), so each task sees its own.
"""

from __future__ import annotations

from typing import Callable, Optional

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException

ASGI_CONTEXT_NAME = "sentinel_web_context"
DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"


class SentinelASGIMiddleware:
    def __init__(
        self,
        app,
        url_cleaner: Optional[Callable[[str], str]] = None,
        origin_parser: Optional[Callable[[dict], str]] = None,
        block_status: int = 429,
    ):
        self.app = app
        self.url_cleaner = url_cleaner or (lambda p: p)
        self.origin_parser = origin_parser or (lambda scope: "")
        self.block_status = block_status

    async def __call__(self, scope, receive, send):
        if scope.get("type") != "http":
            await self.app(scope, receive, send)
            return
        resource = self.url_cleaner(scope.get("path", "/"))
        origin = self.origin_parser(scope)
        st.context_enter(ASGI_CONTEXT_NAME, origin)
        try:
            try:
                entry = st.entry(resource, entry_type=C.EntryType.IN)
            except BlockException:
                await send({
                    "type": "http.response.start",
                    "status": self.block_status,
                    "headers": [(b"content-type", b"text/plain")],
                })
                await send({
                    "type": "http.response.body",
                    "body": DEFAULT_BLOCK_BODY,
                })
                return
            try:
                await self.app(scope, receive, send)
            except BaseException as ex:
                entry.trace(ex)
                raise
            finally:
                entry.exit()
        finally:
            st.exit_context()
