"""The training loop and dispatch: the host's launch calls a step (kernel
and graph launches, async copies and fills) inside the trace's
``train.step`` spans (``phases.launches_per_step``): the graph launch and
the host's writes to the card for the reseed and the learning rate."""

from portbench import phases


def read(trace, outcome, run):
    return None if run.device.type != "cuda" else phases.launches_per_step(trace)
