"""Serving: the share of the time inside the program's ``predict_long``
spans with no operation on the card, in percent
(``inference/predict_long.py``; ``phases.request_idle``)."""

from portbench import phases


def read(trace, outcome, run):
    return phases.request_idle_share(trace, run)
