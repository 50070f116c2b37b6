"""Serving: the forward's product FLOPs at the traced window's windows a
second, over the compute dtype's peak, in percent (``inference/
predict_long.py``)."""

from portbench import counts


def read(trace, outcome, run):
    w = outcome.window
    if not w.get("windows"):
        return None
    rate = counts.forward_flops(run.config) * sum(w["windows"]) / trace.window_s
    return 100.0 * rate / counts.PEAK_FLOPS[w["dtype"]]
