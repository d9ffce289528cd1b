"""Rolling anomaly baseline: EWMA mean/variance + z-score breach (a copy
of ``sentinel_tpu/slo/baseline.py``; the population telescope's
cardinality alarm uses it).

One :class:`EwmaBaseline` tracks one signal and flags samples whose
z-score against the baseline *before* that sample exceeds a threshold.

The update is the standard exponentially-weighted mean/variance
recursion (West 1979 form — one multiply-free pass, no window buffer):

    diff  = x - mean
    incr  = alpha * diff
    mean' = mean + incr
    var'  = (1 - alpha) * (var + diff * incr)

The z-score of a NEW sample is computed against the PRIOR (mean, var) —
scoring against the post-update baseline would let the sample dampen
its own anomaly. Anomalous samples still update the baseline (a real
level shift becomes the new normal instead of alerting forever; a
one-second spike barely moves the mean at the default alpha).

All arithmetic is float64 in a fixed order, so a numpy oracle reproduces
every value bit-exactly.
"""

from __future__ import annotations

import math


class EwmaBaseline:
    """One signal's rolling mean/variance + breach detector."""

    __slots__ = ("alpha", "zscore", "warmup", "mean", "var", "samples",
                 "last_z", "breached")

    def __init__(self, alpha: float = 0.2, zscore: float = 4.0,
                 warmup: int = 30):
        self.alpha = float(alpha)
        self.zscore = float(zscore)
        self.warmup = int(warmup)
        self.mean = 0.0
        self.var = 0.0
        self.samples = 0
        self.last_z = 0.0
        self.breached = False

    def update(self, x: float) -> bool:
        """Score ``x`` against the prior baseline, then fold it in.
        Returns the breach verdict for THIS sample (False during
        warmup — the baseline has nothing to compare against yet, and a
        zero-variance start would make any nonzero sample infinite)."""
        x = float(x)
        if self.samples >= self.warmup and self.var > 0.0:
            self.last_z = (x - self.mean) / math.sqrt(self.var)
        else:
            self.last_z = 0.0
        self.breached = self.last_z >= self.zscore
        diff = x - self.mean
        incr = self.alpha * diff
        self.mean = self.mean + incr
        self.var = (1.0 - self.alpha) * (self.var + diff * incr)
        self.samples += 1
        return self.breached

    def snapshot(self) -> dict:
        return {
            "mean": self.mean,
            "var": self.var,
            "samples": self.samples,
            "lastZ": round(self.last_z, 6),
            "breached": self.breached,
            "warmedUp": self.samples >= self.warmup,
        }
