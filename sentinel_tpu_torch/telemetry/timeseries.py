"""Host helpers of the flight recorder (the part of
``sentinel_tpu/telemetry/timeseries.py`` the decision traces use; the
recorder itself is not ported yet)."""

from __future__ import annotations

from typing import List, Optional


def page_newest_first(items: List, limit: Optional[int] = None,
                      offset: int = 0) -> List:
    """Newest-first pagination over a CHRONOLOGICALLY ordered list:
    ``offset`` skips the newest entries, ``limit`` caps the page size, and
    the page comes back still in chronological order. A limit larger than
    the list is the whole list, never a wrapped slice."""
    offset = max(0, int(offset))
    if offset:
        items = items[:-offset] if offset < len(items) else []
    if limit is not None:
        items = items[max(0, len(items) - max(0, int(limit))):]
    return items
