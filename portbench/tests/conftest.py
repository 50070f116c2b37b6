"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
repository root. They run on the CPU at tiny sizes; the one marked ``cuda``
runs a cell on a card and skips without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny(monkeypatch):
    """Every cell at a size the CPU runs in seconds: a batch of 6 and a
    block of 2 steps for training, songs of 1-3 s for serving; the limits
    are the cell's own."""
    from portbench import run

    full = run.workload_files

    def small(name):
        wl, cfg = full(name)
        wl = dict(wl)
        if wl["driver"] == "train":
            wl.update(batch=6, n_data_points=12, status_every=1, trace_blocks=1)
        else:
            wl.update(song_s=[1.0, 3.0], song_grid=4, base_song_s=2.0, sample_requests=2,
                      trace_seconds=0.5)
        return wl, cfg

    monkeypatch.setattr(run, "workload_files", small)
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield run
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
