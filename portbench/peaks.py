"""The yardstick's table of peaks and the least work of the program's
kernels, computed from their shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit; a run
prints the card's name and power limit beside what it measures.
"""

from __future__ import annotations

import math

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops_per_s": 67e12,
    },
}
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


def peaks_of(kind: str) -> dict:
    return PEAKS.get(kind, DEFAULT_PEAKS)


def prefix_least_s(k: int, n: int, m: int, peaks: dict = DEFAULT_PEAKS
                   ) -> float:
    """Least time of one segmented prefix call over K pairs of N lanes and
    M value columns: the larger of its bytes (int32 ids and float32 values
    read once; float32 prefixes and bool first-flags written once) over
    the HBM rate, and a sort and a scan, ``K * N * ceil(log2 N) * (M+1)``
    operations, over the fp32 rate."""
    nbytes = k * n * (4 + 4 * m + 4 * m + 1)
    ops = k * n * max(1, math.ceil(math.log2(max(n, 2)))) * (m + 1)
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["fp32_flops_per_s"])
