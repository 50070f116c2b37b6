"""The whole train step: the model's product FLOPs at the traced window's
examples a second, over the compute dtype's peak, in percent."""

from portbench import counts


def read(trace, outcome, run):
    w = outcome.window
    if not w.get("examples"):
        return None
    rate = counts.train_step_flops(run.config) * w["examples"] / trace.window_s
    return 100.0 * rate / counts.PEAK_FLOPS[w["dtype"]]
