"""The device inside the train graph: the card's idle ms a step between a
replay's first and last device event (the bubbles between a replay's
kernels; ``phases.phase_split``)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    return None if split is None else split["idle"] * 1e3
