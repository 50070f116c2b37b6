"""TCN-300-C's whole train step: the dilated convolutions' operations
(``counts_tcn.train_step_flops``) at the traced window's examples a second,
over the compute dtype's peak, in percent (``mfu.train``'s yardstick)."""

from portbench import counts_tcn


def read(trace, outcome, run):
    w = outcome.window
    if run.device.type != "cuda" or not w.get("examples"):
        return None
    rate = counts_tcn.train_step_flops(run.config) * w["examples"] / trace.window_s
    return 100.0 * rate / counts_tcn.PEAK_FLOPS[w["dtype"]]
