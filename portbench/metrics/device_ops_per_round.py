"""Device operations (kernels, copies, fills) in the profiled slice of the
window, a round."""


def read(t):
    if t.busy_s is None or not t.slice_rounds:
        return None
    return t.device_ops / t.slice_rounds
