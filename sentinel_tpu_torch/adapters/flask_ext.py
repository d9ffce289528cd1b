"""Flask extension (reference: the per-framework convenience modules of
``sentinel-adapter/`` — e.g. ``sentinel-spring-webmvc-adapter``'s
config-object registration — SURVEY.md §2.5).

Flask is WSGI, so the enforcement IS ``SentinelWSGIMiddleware``; this
extension only supplies the idiomatic ``init_app`` registration and
callback plumbing::

    sentinel = SentinelFlask(url_cleaner=clean, origin_parser=parse)
    sentinel.init_app(app)          # or SentinelFlask(app=app, ...)

Duck-typed: ``app`` needs only a ``wsgi_app`` attribute, so tests (and
any WSGI framework with the same convention, e.g. Bottle via ``wsgi``)
run without Flask installed.

Port of ``sentinel_tpu/adapters/flask_ext.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

from sentinel_tpu_torch.adapters.wsgi import SentinelWSGIMiddleware


class SentinelFlask:
    def __init__(self, app=None,
                 url_cleaner: Optional[Callable[[str], str]] = None,
                 origin_parser: Optional[Callable[[dict], str]] = None,
                 block_handler: Optional[Callable] = None,
                 total_resource: Optional[str] = None):
        self.url_cleaner = url_cleaner
        self.origin_parser = origin_parser
        self.block_handler = block_handler
        self.total_resource = total_resource
        if app is not None:
            self.init_app(app)

    def init_app(self, app) -> None:
        """Wrap ``app.wsgi_app`` (the Flask extension convention).

        Idempotent: the app-factory pattern often calls both
        ``SentinelFlask(app=app)`` and ``init_app(app)``; a second wrap
        would double-count every request (two entries per resource)."""
        if isinstance(app.wsgi_app, SentinelWSGIMiddleware):
            return
        app.wsgi_app = SentinelWSGIMiddleware(
            app.wsgi_app,
            url_cleaner=self.url_cleaner,
            origin_parser=self.origin_parser,
            block_handler=self.block_handler,
            total_resource=self.total_resource,
        )
