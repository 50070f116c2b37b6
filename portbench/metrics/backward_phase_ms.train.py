"""The train step's backward, by the program's phase marks: the card's busy
ms a step in each replay's ``backward`` node range (kernels D and E, the
autoencoders' gradients)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    return None if split is None or "backward" not in split else split["backward"] * 1e3
