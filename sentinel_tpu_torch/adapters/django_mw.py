"""Django-style middleware (reference: ``sentinel-spring-webmvc-adapter``'s
``SentinelWebInterceptor`` / ``AbstractSentinelInterceptor`` —
SURVEY.md §2.5).

Duck-typed against Django's middleware protocol, so it imports no Django:
construct with ``get_response``, call with a request object exposing
``.path`` and ``.META`` / ``.headers``, return the downstream response or
a 429. Register as usual::

    MIDDLEWARE = ["sentinel_tpu_torch.adapters.django_mw.SentinelMiddleware", ...]

Configuration mirrors the webmvc adapter's ``SentinelWebMvcConfig``: set
class attributes (or subclass) for ``url_cleaner`` / ``origin_parser`` /
``block_handler``, matching the WSGI middleware's callbacks.

Port of ``sentinel_tpu/adapters/django_mw.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

from sentinel_tpu_torch.adapters.wsgi import _GuardedIterable, enter_web_entries
from sentinel_tpu_torch.core.exceptions import BlockException

DEFAULT_BLOCK_STATUS = 429
DEFAULT_BLOCK_BODY = b"Blocked by Sentinel (flow limiting)"


class _PlainResponse:
    """Minimal response stand-in used when Django isn't importable (tests,
    non-Django callers). Real deployments get a django HttpResponse."""

    def __init__(self, content: bytes, status: int):
        self.content = content
        self.status_code = status


def _make_response(content: bytes, status: int):
    try:  # pragma: no cover - exercised only with Django installed
        from django.http import HttpResponse

        return HttpResponse(content, status=status)
    except ImportError:
        return _PlainResponse(content, status)


class SentinelMiddleware:
    """``__init__(get_response)`` + ``__call__(request)`` — the modern
    Django middleware shape."""

    url_cleaner: Optional[Callable[[str], str]] = None
    origin_parser: Optional[Callable] = None
    block_handler: Optional[Callable] = None
    total_resource: Optional[str] = None

    def __init__(self, get_response):
        self.get_response = get_response

    def __call__(self, request):
        clean = type(self).url_cleaner or (lambda p: p)
        parse_origin = type(self).origin_parser or (lambda req: "")
        resource = clean(getattr(request, "path", "/"))
        origin = parse_origin(request)
        try:
            entries, cleanup = enter_web_entries(resource, origin,
                                                 type(self).total_resource)
        except BlockException as ex:
            if type(self).block_handler is not None:
                return type(self).block_handler(request, ex)
            return _make_response(DEFAULT_BLOCK_BODY, DEFAULT_BLOCK_STATUS)
        try:
            response = self.get_response(request)
        except BaseException as ex:
            for e in entries:
                e.trace(ex)
            cleanup()
            raise
        # Streaming responses keep their entries live until the body is
        # exhausted — RT covers generation, mid-stream errors are traced
        # (same stance as the WSGI middleware's _GuardedIterable).
        streaming = getattr(response, "streaming_content", None)
        if streaming is not None:
            response.streaming_content = _GuardedIterable(
                streaming, entries, cleanup)
            return response
        cleanup()
        return response
