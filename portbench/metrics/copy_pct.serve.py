"""Serving's transfers: the share of the traced window in which a copy
between host and card ran, in percent."""


def read(trace, outcome, run):
    if not outcome.window.get("requests"):
        return None
    return 100.0 * trace.busy_s(("gpu_memcpy",)) / trace.window_s
