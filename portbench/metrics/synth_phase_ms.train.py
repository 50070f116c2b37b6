"""Data synthesis, by the program's own phase marks: the card's busy ms a
step in each replay's ``synthesis`` node range (``phases.phase_split``;
``data/synth_data.py``, ``dsp/*``, kernels C and L)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    return None if split is None or "synthesis" not in split else split["synthesis"] * 1e3
