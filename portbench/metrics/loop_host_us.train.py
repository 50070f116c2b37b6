"""The training loop and dispatch: the host's own us a step, the mean of
the trace's ``train.step`` spans less the CUDA API calls inside them
(``training/graphs.py`` ``TrainGraph.__call__``: the reseed and the lr fill,
``phases.host_self_us``). The calls are left out: the host waits in its
launches while the card works through a queue of replays, so their time
reads the card's pace."""

from portbench import phases


def read(trace, outcome, run):
    return None if run.device.type != "cuda" else phases.host_self_us(trace)
