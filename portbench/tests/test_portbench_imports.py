"""What the benchmark loads: never JAX, flax or the JAX package
(``signaltrain_tpu``), compared by whole top-level names; and the reference
loads nothing of the program (``signaltrain_tpu_torch``)."""

import subprocess
import sys

from portbench import run

RUN_A_CELL = """
import sys
sys.path.insert(0, {root!r})
from portbench import run
full = run.workload_files
def small(name):
    wl, cfg = full(name)
    wl = dict(wl, batch=6, n_data_points=12, status_every=1, trace_blocks=1)
    return wl, cfg
run.workload_files = small
import importlib
for m in ("portbench.calibrate", "portbench.drivers.serve"):
    importlib.import_module(m)
result, _ = run.execute("train-8k2k-bf16", 2**40 + 7, 0.2, True, "cpu")
assert result["correct"], result
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.model, portbench.reference.synth, portbench.compare
import portbench.weights, portbench.counts, portbench.songs, portbench.trace
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(run.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package():
    loaded = _top_level(RUN_A_CELL)
    assert "signaltrain_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(REFERENCE_ONLY)
    assert not loaded & {"signaltrain_tpu_torch", *run.FORBIDDEN}


def test_the_names_are_compared_whole():
    sys.modules.setdefault("signaltrain_tpu_torch_probe_only", sys)
    try:
        assert "signaltrain_tpu_torch_probe_only" not in run.loaded_forbidden()
    finally:
        del sys.modules["signaltrain_tpu_torch_probe_only"]
