"""TCN-300-C's dilated convolutions in training: the sum of each
convolution product's bound (``counts_tcn.conv_calls``: forward, data and
weight gradients, each the larger of its operations at the dtype's peak and
its bytes at the HBM rate) over the card time of the convolution kernels
listed in ``portbench/kernels/tcn/``, in percent (``models/tcn.py`` through
cuDNN)."""

from portbench import counts_tcn


def read(trace, outcome, run):
    w = outcome.window
    seconds = trace.layer_s("tcn")
    if not w.get("steps") or seconds <= 0:
        return None
    bound = counts_tcn.train_conv_bound_s(run.config, w["batch"], w["dtype"]) * w["steps"]
    return 100.0 * bound / seconds
