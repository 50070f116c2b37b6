"""TCN-300-C's BatchNorm, FiLM, PReLU and residual in the forward, by the
program's phase marks: the card's busy ms a step in each replay's
``tcn.norm`` node ranges, summed over the blocks (``models/tcn.py``,
``phases.phase_split``)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    return None if split is None or "tcn.norm" not in split else split["tcn.norm"] * 1e3
