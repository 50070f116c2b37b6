"""Data synthesis: the card's ms a step before each replay's first
front-end kernel (``data/synth_data.py``, ``dsp/*``, kernels C and L)."""


def read(trace, outcome, run):
    if not outcome.window.get("steps"):
        return None
    split = trace.block_split(outcome.window["steps_per_block"])
    return None if split is None else split["data_synthesis"] * 1e3
