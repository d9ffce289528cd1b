"""Outbound HTTP client adapter (reference: ``sentinel-okhttp-adapter`` /
``sentinel-apache-httpclient-adapter`` — SURVEY.md §2.5): guard outgoing
HTTP calls as OUT-type entries named ``METHOD:host/path`` (the reference's
cleaner-configurable convention), tracing non-2xx/transport failures into
exception metrics so degrade rules can break on a failing dependency.

Port of ``sentinel_tpu/adapters/http_client.py``.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

import sentinel_tpu_torch as st
from sentinel_tpu_torch.core import constants as C
from sentinel_tpu_torch.core.exceptions import BlockException  # noqa: F401 (re-export)


def default_resource_extractor(method: str, url: str) -> str:
    """``METHOD:host/path`` — query strings dropped (unbounded cardinality)."""
    parts = urllib.parse.urlsplit(url)
    return f"{method.upper()}:{parts.netloc}{parts.path}"


class SentinelHttpClient:
    """A guarded ``urllib`` wrapper; swap in any transport via ``send``."""

    def __init__(self,
                 resource_extractor: Optional[Callable[[str, str], str]] = None,
                 timeout_s: float = 10.0):
        self.extract = resource_extractor or default_resource_extractor
        self.timeout_s = timeout_s

    def request(self, method: str, url: str, data: Optional[bytes] = None,
                headers: Optional[dict] = None):
        """Raises BlockException when the resource is over its rules;
        transport errors / 5xx feed exception metrics and re-raise. 4xx is
        a CALLER error — it re-raises but does NOT count as a dependency
        exception (a degrade rule must not break a healthy dependency), so
        the handle is managed explicitly rather than via the with-block's
        auto-trace."""
        resource = self.extract(method, url)
        handle = st.entry(resource, entry_type=C.EntryType.OUT)
        try:
            req = urllib.request.Request(url, data=data, method=method.upper(),
                                         headers=dict(headers or {}))
            try:
                return urllib.request.urlopen(req, timeout=self.timeout_s)
            except urllib.error.HTTPError as ex:
                if ex.code >= 500:
                    handle.trace(ex)
                raise
            except OSError as ex:
                handle.trace(ex)
                raise
        finally:
            handle.exit()

    def get(self, url: str, **kw):
        return self.request("GET", url, **kw)

    def post(self, url: str, data: bytes = b"", **kw):
        return self.request("POST", url, data=data, **kw)


def guarded(fn: Callable, resource: str,
            entry_type: int = C.EntryType.OUT) -> Callable:
    """Wrap ANY outbound client callable (requests.get, a session method)
    in an entry — the adapter-of-last-resort for clients without a
    dedicated module. Thin alias over :func:`sentinel_resource` (same
    blocking/tracing semantics; use the decorator directly for fallback
    and block-handler routing)."""
    from sentinel_tpu_torch.adapters.annotation import sentinel_resource

    return sentinel_resource(value=resource, entry_type=entry_type)(fn)
