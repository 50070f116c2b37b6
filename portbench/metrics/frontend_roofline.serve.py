"""Kernels A and B in serving: the sum of the bounds of predict_long's A
and B calls over the card time of the front-end's kernels in the traced
window, in percent."""

from portbench import counts


def read(trace, outcome, run):
    w = outcome.window
    seconds = trace.layer_s("frontend")
    if not w.get("windows") or seconds <= 0:
        return None
    bound = 0.0
    for n in w["windows"]:
        for b in counts.super_batches(n):
            bound += counts.bound_s(*counts.analysis_call(run.config, b), w["dtype"])
            bound += counts.bound_s(*counts.synthesis_call(run.config, b), w["dtype"])
    return 100.0 * bound / seconds
