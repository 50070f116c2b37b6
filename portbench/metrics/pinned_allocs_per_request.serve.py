"""Serving: the mean ``pinned_allocs`` (new blocks of the caching host
allocator, pinned for a request's result because no freed one of its size
was there) of the window's ``predict_long`` requests, from the program's
span records (``inference/predict_long.py``)."""

from portbench import phases


def read(trace, outcome, run):
    recs = phases.records(run, outcome)
    counts = [r.counts["pinned_allocs"] for r in recs or ()
              if r.name == "predict_long" and r.counts and "pinned_allocs" in r.counts]
    return sum(counts) / len(counts) if counts else None
