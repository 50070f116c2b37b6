"""The train step's forward and loss, by the program's phase marks: the
card's busy ms a step in each replay's ``forward`` and ``loss`` node ranges
(``models/*``, kernels A and B, ``training/loss.py``)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    if split is None or "forward" not in split:
        return None
    return (split["forward"] + split.get("loss", 0.0)) * 1e3
