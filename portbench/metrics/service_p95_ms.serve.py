"""Serving: the 95th percentile of the time ``predict_long`` took for the
traced window's requests, from the call to the array (host clock)."""


def read(trace, outcome, run):
    if not outcome.window.get("requests"):
        return None
    return outcome.window["latency_p95_ms"]
