"""The benchmark of ``signaltrain_tpu_torch`` on one card.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once and prints one JSON line last. Everything is found by
name: a cell's traffic in ``workloads/<cell>.json``, the configuration it
names in ``configs/<config>.json``, the driver the traffic names in
``drivers/<driver>.py``, each per-layer metric in ``metrics/<metric>.py``
and the kernel names of a layer in ``kernels/<layer>/*.txt``. A new cell, a
new configuration or a new metric is new files and new ``BENCHMARK.json``
entries. ``reference/`` holds the plain PyTorch reference that decides
``correct``; it imports nothing of the program.
"""
