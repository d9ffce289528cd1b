"""Test-only reintroduction of KNOWN-FIXED bugs (shrinker proof-of-life;
port of ``sentinel_tpu/chaos/regressions.py``).

The chaos campaign's detection story is only credible if a bug the repo
has already fixed, put back deliberately, is (a) caught by the invariant
catalogue and (b) shrunk to a minimal fault schedule. This registry is
the flag rack those reintroductions hide behind: production code guards
a fixed behavior with ``reintroduced("<name>")`` — False always, unless
a test flipped the flag through :func:`reintroduce`.

This module imports nothing from the package (the hooks live on cold
paths and import IT lazily), and the flags are process-global on
purpose: the campaign drives a whole in-process mesh, and the bug must
come back everywhere at once, exactly like the original.
"""

from __future__ import annotations

import contextlib

# name -> what the fixed bug was (the catalogue the chaos command lists).
KNOWN = {
    # Pre-HA behavior DegradedQuota (cluster/ha.py) fixed:
    # degraded mode handed every client FULL-LOCAL AMNESTY instead of a
    # per-client share of the global threshold, so N clients could
    # admit N x the global quota while the leader was down. Reintroduced,
    # the chaos campaign's degraded-quota-sum invariant must catch it
    # and shrink the schedule to the single crash that triggers it.
    "degraded-amnesty": (
        "degraded mode grants full-local amnesty instead of the "
        "per-client DegradedQuota share (pre-HA behavior)"),
}

_active: set = set()


def reintroduced(name: str) -> bool:
    """True while a test has deliberately put the named bug back."""
    return name in _active


@contextlib.contextmanager
def reintroduce(name: str):
    """Put a known-fixed bug back for the duration of the block."""
    if name not in KNOWN:
        raise ValueError(f"unknown regression {name!r}; known: "
                         f"{sorted(KNOWN)}")
    _active.add(name)
    try:
        yield
    finally:
        _active.discard(name)
