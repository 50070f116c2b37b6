"""The train step's update, by the program's phase marks: the card's busy
ms a step in each replay's ``update`` node range (the front-end clip,
``Adam(capturable=True)``, the loss appended to the graph's buffer)."""

from portbench import phases


def read(trace, outcome, run):
    split = phases.train_split(trace, run)
    return None if split is None or "update" not in split else split["update"] * 1e3
