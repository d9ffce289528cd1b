"""The device's idle share of the profiled slice, in %: one less the union
of its operations' intervals over the slice's wall time."""


def read(t):
    if t.busy_s is None or not t.slice_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.slice_s)
