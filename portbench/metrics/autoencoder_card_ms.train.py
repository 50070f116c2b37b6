"""The train step's autoencoders: the card's ms a step between the
front-end kernels' runs, the loss left out (``models/autoencoder.py``,
``models/mpaec.py``)."""


def read(trace, outcome, run):
    if not outcome.window.get("steps"):
        return None
    split = trace.block_split(outcome.window["steps_per_block"])
    return None if split is None else split["autoencoders"] * 1e3
