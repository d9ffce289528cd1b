"""The segmented prefix's share of its roofline, in %: the least time of
every call in the profiled slice, from its shapes alone
(``portbench/peaks.py:prefix_least_s``), over the device time of the
operations those calls ran. The same work is counted whatever implements
the prefix."""

from portbench.peaks import peaks_of, prefix_least_s


def read(t):
    if not t.prefix_device_s or not t.prefix_shapes:
        return None
    peaks = peaks_of(t.peaks.get("kind", ""))
    least = sum(prefix_least_s(k, n, m, peaks) for k, n, m in t.prefix_shapes)
    return 100.0 * least / t.prefix_device_s
