"""Serving: the share of the time inside the program's ``predict_long``
spans in which the card idles inside ``predict_long.upload`` or
``predict_long.pull`` (the host side of the pageable copies), in percent; a
part of ``request_idle_pct.serve`` (``phases.request_idle``)."""

from portbench import phases


def read(trace, outcome, run):
    return phases.request_idle_share(trace, run, ("predict_long.upload", "predict_long.pull"))
