"""The one traffic generator: reads a mix's parameters (``traffic/*.json``)
and draws every round's entries and exits from ``--seed``.

A round's inputs depend only on ``(seed, round)``: each round has its own
``numpy`` generator seeded by ``[seed, round, stream]``, so any round can be
drawn again without the ones before it (the reference replays a run this
way) and every seed makes the same amount of work.

Parameters a mix may set:

- ``width``: entries a round; ``step_ms``: trace time a round;
  ``warm_rounds``: rounds run in set-up, before the window;
- ``resources``: ``{"dist": "uniform"}`` or ``{"dist": "zipf", "s": s}``
  (rank r is resource r - 1, whatever the seed);
- ``keys`` (argument 0): ``{"dist": "unique"}``, a 31-bit value that never
  repeats within a run, or ``{"dist": "zipf", "s": s, "n": n}``, key rank r
  of n, mapped to a 31-bit value by a table drawn from the seed;
- ``origin_share``: the share of lanes that carry the configuration's
  origin (0 where the configuration names none); ``count``: tokens an
  entry acquires;
- ``rt_ms`` ``[lo, hi]`` and ``error_share``: what each admitted entry's
  exit reports.

This module imports neither the program nor the reference.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

# Keys that never repeat: lane number l -> 1 + (l * A + B) mod P, a
# bijection of [0, P) for the prime P = 2^31 - 1, so no two lanes of a run
# share a key and no key is 0 (0 marks an empty hot-parameter slot).
_P31 = (1 << 31) - 1
_KEY_MULT = 1_103_515_245

ENTRY, EXIT = 0, 1


class Lanes(NamedTuple):
    """One round's entries, by what a caller knows of them."""

    resource: np.ndarray  # int64[N] resource index
    origin: np.ndarray    # bool[N] carries the configuration's origin
    key: np.ndarray       # int64[N] argument 0's 31-bit hash (> 0)
    count: np.ndarray     # int64[N] tokens acquired


class Exits(NamedTuple):
    """What each lane's exit reports, were it admitted."""

    rt_ms: np.ndarray     # int64[N]
    error: np.ndarray     # bool[N]


def _zipf_cdf(n: int, s: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** (-float(s))
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


class Traffic:
    def __init__(self, mix: Dict, resources: int, seed: int,
                 width: int | None = None):
        self.mix = mix
        self.seed = int(seed)
        self.resources = int(resources)
        self.width = int(width if width is not None else mix["width"])
        self.step_ms = int(mix["step_ms"])
        self.warm_rounds = int(mix["warm_rounds"])
        rd = mix["resources"]
        self._res_cdf = (_zipf_cdf(self.resources, rd["s"])
                         if rd["dist"] == "zipf" else None)
        kd = mix["keys"]
        self._key_cdf = None
        self._key_table = None
        if kd["dist"] == "zipf":
            n = int(kd["n"])
            self._key_cdf = _zipf_cdf(n, kd["s"])
            rng = np.random.default_rng([self.seed, 2**32 - 1])
            table = np.zeros(0, np.int64)
            while table.size < n:
                draw = rng.integers(1, 1 << 31, size=n + n // 8)
                table = np.concatenate([table, draw])
                _, first = np.unique(table, return_index=True)
                table = table[np.sort(first)]
            self._key_table = table[:n]
        elif kd["dist"] != "unique":
            raise ValueError(f"unknown key distribution {kd['dist']!r}")
        self._key_offset = self.seed % _P31

    def _rank(self, rng, cdf, size) -> np.ndarray:
        idx = np.searchsorted(cdf, rng.random(size), side="right")
        return np.minimum(idx, cdf.size - 1)

    def entries(self, r: int) -> Lanes:
        rng = np.random.default_rng([self.seed, int(r), ENTRY])
        n = self.width
        if self._res_cdf is None:
            res = rng.integers(0, self.resources, size=n)
        else:
            res = self._rank(rng, self._res_cdf, n)
        if self._key_table is None:
            lane = np.arange(n, dtype=np.int64) + int(r) * n
            key = 1 + (lane * _KEY_MULT + self._key_offset) % _P31
        else:
            key = self._key_table[self._rank(rng, self._key_cdf, n)]
        origin = rng.random(n) < float(self.mix["origin_share"])
        count = np.full(n, int(self.mix["count"]), np.int64)
        return Lanes(res.astype(np.int64), origin, key.astype(np.int64),
                     count)

    def exits(self, r: int) -> Exits:
        rng = np.random.default_rng([self.seed, int(r), EXIT])
        lo, hi = self.mix["rt_ms"]
        n = self.width
        rt = rng.integers(int(lo), int(hi) + 1, size=n)
        error = rng.random(n) < float(self.mix["error_share"])
        return Exits(rt.astype(np.int64), error)
