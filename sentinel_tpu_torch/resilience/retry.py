"""Seedable retry schedules (port of ``sentinel_tpu/resilience/retry.py``):
exponential backoff + decorrelated jitter.

One policy object describes the schedule (base, cap, growth, jitter
mode, seed); each retrying loop gets its own :class:`RetrySession` so
independent loops (token-client reconnect, datasource poll, heartbeat
rotation) never share mutable state. Sessions are deterministic for a
given seed — the chaos suite pins seeds and asserts exact delays.

Jitter modes ("Exponential Backoff And Jitter", AWS architecture blog —
the scheme the reference ecosystem's clients converged on):

* ``decorrelated`` (default): ``next = min(cap, uniform(base, prev * mult))``
  — spreads a thundering herd without ever dropping below ``base``.
* ``full``: ``next = uniform(0, min(cap, base * mult**attempt))``.
* ``none``: plain exponential ``min(cap, base * mult**attempt)`` —
  bit-reproducible schedules for tests that want exact values.

The FIRST delay of every session is exactly ``base_ms`` in all modes, so
swapping a fixed-interval loop for a policy keeps its steady-state
cadence until something actually fails repeatedly.
"""

from __future__ import annotations

import random
from typing import Optional


class RetrySession:
    """Mutable per-loop state: call :meth:`next_delay_ms` before each
    retry, :meth:`reset` after any success."""

    __slots__ = ("policy", "_rng", "_prev_ms", "attempt")

    def __init__(self, policy: "RetryPolicy", rng: random.Random):
        self.policy = policy
        self._rng = rng
        self._prev_ms = None
        self.attempt = 0

    def next_delay_ms(self) -> int:
        p = self.policy
        self.attempt += 1
        if self._prev_ms is None:
            self._prev_ms = p.base_ms
            return p.base_ms
        if p.jitter == "decorrelated":
            nxt = self._rng.uniform(p.base_ms, self._prev_ms * p.multiplier)
        elif p.jitter == "full":
            nxt = self._rng.uniform(
                0, min(p.max_ms, p.base_ms * p.multiplier ** (self.attempt - 1)))
        else:  # "none"
            nxt = self._prev_ms * p.multiplier
        self._prev_ms = min(int(nxt), p.max_ms)
        return max(0, self._prev_ms)

    def reset(self) -> None:
        self._prev_ms = None
        self.attempt = 0


class RetryPolicy:
    """Immutable schedule description; :meth:`session` mints loop state."""

    def __init__(self, base_ms: int = 500, max_ms: int = 30_000,
                 multiplier: float = 3.0, jitter: str = "decorrelated",
                 seed: Optional[int] = None):
        if base_ms <= 0 or max_ms < base_ms or multiplier < 1.0:
            raise ValueError(
                f"invalid retry policy: base={base_ms}ms max={max_ms}ms "
                f"multiplier={multiplier}")
        if jitter not in ("decorrelated", "full", "none"):
            raise ValueError(f"unknown jitter mode {jitter!r}")
        self.base_ms = int(base_ms)
        self.max_ms = int(max_ms)
        self.multiplier = float(multiplier)
        self.jitter = jitter
        self.seed = seed

    def session(self) -> RetrySession:
        # A fresh seeded stream per session: two sessions of one policy
        # replay the same schedule (determinism beats decorrelation
        # between loops of one process — cross-process herds decorrelate
        # via per-process seeds).
        return RetrySession(self, random.Random(self.seed))

    @classmethod
    def from_config(cls, component: str, base_ms: int, max_ms: int,
                    multiplier: float = 3.0,
                    jitter: str = "decorrelated") -> "RetryPolicy":
        """Build from ``csp.sentinel.resilience.*`` config, most-specific
        key first: ``…resilience.<component>.retry.base.ms`` overrides
        ``…resilience.retry.base.ms`` overrides the caller's default.
        The shared ``csp.sentinel.resilience.seed`` pins every policy in
        the process (the chaos suite sets it)."""
        from sentinel_tpu_torch.core.config import RESILIENCE_SEED, config

        def _get(suffix: str, default):
            for key in (f"csp.sentinel.resilience.{component}.{suffix}",
                        f"csp.sentinel.resilience.{suffix}"):
                v = config.get(key)
                if v is not None:
                    try:
                        return type(default)(v)
                    except (TypeError, ValueError):
                        pass
            return default

        seed_raw = config.get(RESILIENCE_SEED)
        try:
            seed = int(seed_raw) if seed_raw is not None else None
        except ValueError:
            seed = None
        cfg_base = _get("retry.base.ms", int(base_ms))
        cfg_max = max(_get("retry.max.ms", int(max_ms)), cfg_base)
        try:
            return cls(base_ms=cfg_base, max_ms=cfg_max,
                       multiplier=_get("retry.multiplier", float(multiplier)),
                       jitter=_get("retry.jitter", jitter),
                       seed=seed)
        except ValueError as ex:
            # A config typo must not turn into a component-startup crash
            # (same warn-and-default stance as the engine's budget key).
            from sentinel_tpu_torch.log.record_log import record_log

            record_log.warn("invalid resilience retry config for %r (%s); "
                            "using defaults", component, ex)
            return cls(base_ms=base_ms, max_ms=max_ms,
                       multiplier=multiplier, jitter=jitter, seed=seed)
