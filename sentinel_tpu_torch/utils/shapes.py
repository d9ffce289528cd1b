"""Shared shape helpers for rule-tensor compilation."""

from __future__ import annotations


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= max(n, 1).

    Rule tensors pad to a small multiple so reloading one extra rule keeps
    the jit cache warm (same shapes, no recompile).
    """
    return ((max(n, 1) + m - 1) // m) * m
