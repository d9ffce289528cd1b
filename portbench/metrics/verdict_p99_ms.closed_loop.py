"""The 99th percentile over the window's entries of the wall time from a
batch's ``check_batch`` call to ``harvest_decisions`` returning, in ms
(nearest rank; every entry of a round shares its round's time). The
profiled slice's rounds are left out."""

import math


def read(t):
    if not t.verdict_s:
        return None
    v = sorted(t.verdict_s)
    return v[math.ceil(0.99 * len(v)) - 1] * 1e3
