"""Serving: the mean ``device_allocs`` (the caching allocator's cudaMalloc
calls) of the window's ``predict_long`` requests, from the program's span
records (``inference/predict_long.py``)."""

from portbench import phases


def read(trace, outcome, run):
    recs = phases.records(run, outcome)
    counts = [r.counts["device_allocs"] for r in recs or ()
              if r.name == "predict_long" and r.counts and "device_allocs" in r.counts]
    return sum(counts) / len(counts) if counts else None
