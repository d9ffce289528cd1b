"""Deterministic canary assignment for staged rollouts (port of
``sentinel_tpu/rollout/canary.py``).

A request's rollout stage must be STABLE: the same caller (context,
origin) lands on the same side of the canary split on every step, or a
paced client would flap between the live and candidate rulesets and see
neither's semantics. The canary key is the (origin, context) pair the
flow checker already carries on the device.

The assignment is a pure function of (origin_id, context_id, salt): a
32-bit multiplicative mix hashed into basis points and compared against
the candidate's ``canary_bps``. ``canary_hash`` / ``canary_bucket`` /
``in_canary`` run on Python ints (and numpy arrays) as the reference's
do; :func:`device_in_canary` runs the same arithmetic on torch tensors
inside the fused step, so a host prediction equals the device verdict
bit for bit.

torch has no arithmetic on ``uint32`` beyond ``*`` and ``^`` (``+``,
``>>``, ``%`` and ``<`` raise on it), so the device form works in int64
and masks to 32 bits after every step. A product of two 32-bit values
can pass 2^63, so each multiply splits its tensor operand into 16-bit
halves: ``a * b mod 2^32 == (a_lo * b + ((a_hi * b_lo) << 16)) mod 2^32``,
every partial below 2^49.
"""

from __future__ import annotations

import torch

# Odd multiplicative constants (Knuth / murmur-finalizer lineage), the
# reference's. Arithmetic is mod 2^32 throughout.
_MIX_A = 0x9E3779B1
_MIX_B = 0x85EBCA77
_MIX_C = 0xC2B2AE3D
_M32 = 0xFFFFFFFF

CANARY_BPS_MAX = 10_000  # basis points: 10000 == 100% of traffic


def canary_hash(origin_id, context_id, salt):
    """uint32 mix of the canary key, on Python ints or numpy arrays (all
    ops are +, *, ^, >> reduced mod 2^32).

    origin_id may be negative (ORIGIN_ID_NONE / padding); the +0x101
    offset keeps distinct small negatives distinct after the reduction.
    """
    h = ((origin_id + 0x101) * _MIX_A + (context_id + 0x7F) * _MIX_B) & _M32
    h ^= (salt * _MIX_C) & _M32
    h = (h ^ (h >> 15)) * _MIX_B & _M32
    h ^= h >> 13
    return h & _M32


def canary_bucket(origin_id, context_id, salt):
    """Basis-point bucket in [0, 10000) for the canary key."""
    return canary_hash(origin_id, context_id, salt) % CANARY_BPS_MAX


def in_canary(origin_id, context_id, salt, bps):
    """True when the key falls inside the canary slice of ``bps`` basis
    points. ``bps=0`` selects nobody, ``bps=10000`` everybody."""
    return canary_bucket(origin_id, context_id, salt) < bps


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2^32`` for int64 ``a`` in [0, 2^32) and a constant
    ``b`` in [0, 2^32), with no intermediate at or above 2^49."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * (b & 0xFFFF)) << 16
    return (lo + hi) & _M32


def device_in_canary(origin_id: torch.Tensor, context_id: torch.Tensor,
                     salt: int, bps: int) -> torch.Tensor:
    """bool[N] from the int32[N] batch lanes: :func:`in_canary` on the
    device. ``salt`` and ``bps`` are host ints (the engine's canary
    scalars), so the step reads nothing back from the device."""
    o = ((origin_id.to(torch.int64) & _M32) + 0x101) & _M32
    c = ((context_id.to(torch.int64) & _M32) + 0x7F) & _M32
    h = (_mul32(o, _MIX_A) + _mul32(c, _MIX_B)) & _M32
    h = h ^ ((int(salt) & _M32) * _MIX_C & _M32)
    h = _mul32(h ^ (h >> 15), _MIX_B)
    h = h ^ (h >> 13)
    return (h % CANARY_BPS_MAX) < int(bps)
