"""Kernels A, B, D and E in training: the sum of each front-end call's bound
over the card time of the front-end's kernels in the traced window, in
percent (``ops/cuda_frontend.py``, ``csrc/frontend*.cu``)."""

from portbench import counts


def read(trace, outcome, run):
    w = outcome.window
    seconds = trace.layer_s("frontend")
    if not w.get("steps") or seconds <= 0:
        return None
    bound = counts.train_frontend_bound_s(run.config, w["batch"], w["dtype"]) * w["steps"]
    return 100.0 * bound / seconds
