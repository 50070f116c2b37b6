"""One reader a per-layer metric, ``<metric name>.py``, found by the name in
``BENCHMARK.json``: ``read(trace, outcome, run)`` returns the number, or
None where the traced window holds nothing it reads (the metric is then
left out of the result)."""
