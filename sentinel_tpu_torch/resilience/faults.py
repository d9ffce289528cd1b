"""Deterministic fault injection (port of
``sentinel_tpu/resilience/faults.py``: the injector and the hooks, with
the seams of the modules this package has).

Named fault points:

* ``cluster.client.send`` -- token client, before each frame write.
* ``cluster.server.frame`` -- token server, every reply write (the bytes
  pass through :func:`mutate`, so garbage mode can corrupt the stream).
* ``cluster.ha.leader.crash`` -- fired by the token server's batcher
  before each device step; an armed error hard-kills the server
  (listener and connections closed, no drain).
* ``cluster.ha.halfopen`` -- mutate seam on every server reply write;
  ``garbage=b""`` swallows replies while the connection stays up (a
  half-open socket the client must time out of).
* ``cluster.ha.stale.epoch`` -- mutate seam on the epoch-TLV payload of
  each response, so a test can replay a deposed leader's epoch.
* ``cluster.reactor.conn.drop`` / ``cluster.reactor.conn.stall`` --
  fired per connection read in the wire reactor (``cluster/reactor.py``):
  an armed error drops that connection mid-stream, delay mode stalls the
  read.
* ``slots.evict.storm`` -- fired at the top of every slot-table rebalance
  tick (``core/slots.py``, ABOVE the freeze gate); an armed error evicts
  EVERY unpinned occupant that cycle.
* ``slots.spill.torn`` -- mutate seam inside the per-victim eviction
  spill: garbage OR error mode tears the spill record, so the victim's
  window state drops on the floor (counted) and it rehydrates cold.
* ``checkpoint.torn.write`` -- mutate seam inside the atomic checkpoint
  writer (``core/checkpoint.py``): garbage mode TEARS the temp file before
  the rename publishes it (a power cut midway through the data blocks),
  error mode aborts before the rename (a crash before publishing; the
  previous file survives).
* ``journal.disk.full`` -- fired before every durable journal append
  (``telemetry/journal.py``); an armed error is the disk-full / EIO path:
  the journal degrades to its in-memory tail, loudly.

A :class:`FaultInjector` arms specs per point -- ``error`` (raise),
``delay`` (sleep), ``garbage`` (replace bytes) -- triggered by a schedule
(``after`` N calls, at most ``times`` fires) and/or a seeded probability.
Each armed point draws from its own ``random.Random`` stream derived from
``(seed, point)``, so arming a point never shifts another point's draws
and a run replays exactly.

Zero overhead when disabled: the module-level ``fire`` / ``mutate`` hooks
test one global against ``None`` and return.

    with FaultInjector(seed=7) as inj:
        inj.arm("slots.evict.storm", "error", after=2, times=3)
        ...
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

FAULT_POINTS = (
    "cluster.client.send",
    "cluster.server.frame",
    "cluster.ha.leader.crash",
    "cluster.ha.halfopen",
    "cluster.ha.stale.epoch",
    "cluster.reactor.conn.drop",
    "cluster.reactor.conn.stall",
    "slots.evict.storm",
    "slots.spill.torn",
    "checkpoint.torn.write",
    "journal.disk.full",
)


class FaultInjected(OSError):
    """Default injected error: an OSError subclass so every remote seam's
    existing except-clause treats it exactly like a real I/O failure."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


@dataclass
class FaultSpec:
    mode: str                       # "error" | "delay" | "garbage"
    probability: float = 1.0        # seeded coin per triggering call
    after: int = 0                  # skip the first N calls at this point
    times: Optional[int] = None     # max fires (None = unlimited)
    delay_ms: int = 0               # delay mode
    error: Optional[BaseException] = None  # error mode override
    garbage: Optional[bytes] = None  # garbage mode payload (None = random)
    calls: int = 0
    fires: int = 0
    rng: object = None              # per-point stream, set by arm()

    def __post_init__(self):
        if self.mode not in ("error", "delay", "garbage"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability {self.probability} not in [0, 1]")


class FaultInjector:
    def __init__(self, seed: int = 0, scope_thread: bool = False):
        self.seed = seed
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}
        # ``scope_thread=True`` arms the injector for the CONSTRUCTING
        # thread only: every other thread's fire()/mutate() is a no-op
        # that consumes nothing (no spec call/fire budget, no RNG draw),
        # so the engine's own threads can neither see its faults nor use
        # up its schedule.
        self._thread = threading.current_thread() if scope_thread else None

    def _foreign_thread(self) -> bool:
        return (self._thread is not None
                and threading.current_thread() is not self._thread)

    def _point_rng(self, point: str):
        """The point's own deterministic stream: seeded from
        ``(injector seed, point name)`` via a stable digest (no
        ``hash()`` — process-stable), so each point's draws are a pure
        function of the seed and ITS OWN call sequence. Arming a new
        point mid-run can never shift another point's sequence — the
        replay-stability contract chaos campaigns lean on (pinned by
        the JAX package's tests/test_chaos.py)."""
        import hashlib
        import random

        digest = hashlib.sha256(point.encode("utf-8")).digest()
        return random.Random(self.seed ^ int.from_bytes(digest[:8], "big"))

    # -- configuration ----------------------------------------------------

    def arm(self, point: str, mode: str, probability: float = 1.0,
            after: int = 0, times: Optional[int] = None, delay_ms: int = 0,
            error: Optional[BaseException] = None,
            garbage: Optional[bytes] = None) -> FaultSpec:
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {FAULT_POINTS}")
        spec = FaultSpec(mode=mode, probability=probability, after=after,
                         times=times, delay_ms=delay_ms, error=error,
                         garbage=garbage, rng=self._point_rng(point))
        with self._lock:
            self._specs[point] = spec
        return spec

    def disarm(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)

    def fires(self, point: str) -> int:
        with self._lock:
            spec = self._specs.get(point)
            return spec.fires if spec is not None else 0

    # -- hook implementation ----------------------------------------------

    def _should_fire(self, spec: FaultSpec) -> bool:
        # Caller holds self._lock.
        spec.calls += 1
        if spec.calls <= spec.after:
            return False
        if spec.times is not None and spec.fires >= spec.times:
            return False
        if spec.probability < 1.0 and spec.rng.random() >= spec.probability:
            return False
        spec.fires += 1
        return True

    def _fire(self, point: str) -> None:
        if self._foreign_thread():
            return
        with self._lock:
            spec = self._specs.get(point)
            if spec is None or not self._should_fire(spec):
                return
            mode, delay_ms, error = spec.mode, spec.delay_ms, spec.error
        if mode == "delay":
            time.sleep(delay_ms / 1000.0)
        elif mode == "error":
            raise error if error is not None else FaultInjected(point)
        # garbage mode is a no-op at a fire-only point: there are no
        # bytes to corrupt.

    def _mutate(self, point: str, data: bytes) -> bytes:
        if self._foreign_thread():
            return data
        with self._lock:
            spec = self._specs.get(point)
            if spec is None or not self._should_fire(spec):
                return data
            mode, delay_ms, error = spec.mode, spec.delay_ms, spec.error
            if mode == "garbage":
                if spec.garbage is not None:
                    return spec.garbage
                n = max(8, len(data))
                return bytes(spec.rng.randrange(256) for _ in range(n))
        if mode == "delay":
            time.sleep(delay_ms / 1000.0)
            return data
        raise error if error is not None else FaultInjected(point)

    # -- process-wide installation ----------------------------------------

    def install(self) -> "FaultInjector":
        global _active
        if _active is not None and _active is not self:
            raise RuntimeError("another FaultInjector is already installed")
        _active = self
        return self

    def uninstall(self) -> None:
        global _active
        if _active is self:
            _active = None

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


_active: Optional[FaultInjector] = None


def fire(point: str) -> None:
    """Hook at a control-flow seam: may raise or delay per the armed spec.
    One global None-check when no injector is installed."""
    inj = _active
    if inj is not None:
        inj._fire(point)


def mutate(point: str, data: bytes) -> bytes:
    """Hook at a byte-stream seam: may corrupt/replace ``data`` (garbage
    mode), delay, or raise per the armed spec."""
    inj = _active
    if inj is None:
        return data
    return inj._mutate(point, data)
