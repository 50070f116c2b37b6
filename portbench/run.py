"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of a shorter window (``metrics/<name>.py`` each). Every run checks
the outputs of the timed path against the plain reference and prints each
number compared beside its limit, last on standard error and last in the
result line. A line before the result holds the card's state: its name,
power limit, and its SM clock, power draw and clock-limit reasons sampled
through the window (``card.Sampler``), and the kernels' launch counts over
the window.

The run needs as many CUDA cards as the cell asks for, and exits with 3
and no result without them.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

from . import card as card_mod, compare
from .trace import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "signaltrain_tpu")


def _process_start() -> float:
    """The epoch seconds this process started, from /proc (the clock-tick
    resolution); the module's import time where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload_files(name: str) -> tuple[dict, dict]:
    """(traffic, configuration) of the cell ``name``."""
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def derive_seed(seed: int, stream: int, bits: int) -> int:
    """A ``bits``-bit seed for one stream of the run, from the whole --seed."""
    import numpy as np

    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(seed) >> 64, stream])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << bits) - 1)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    numbers: dict
    memory_peak: int
    end_to_end: dict
    window: dict


class Run:
    """What a driver is given: the cell's files, the seeds, the window's
    length, the device, and the window's clock and spans."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device):
        import torch

        self.name = workload
        self.workload, self.config = workload_files(workload)
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device = torch.device(device)
        self.data_seed = derive_seed(seed, 1, 31)
        self.weight_seed = derive_seed(seed, 2, 48)
        self.setup_s = None
        self.prof = None
        self.trace_path = None
        self._t0 = None
        self._window = None
        self._launches0 = {}
        self.sampler = None

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def note(self, what: str) -> None:
        """A set-up phase's end, in seconds since the process started, on stderr."""
        print(f"setup: {what} at {time.time() - PROCESS_START:.3f} s", file=sys.stderr, flush=True)

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def start_time(self) -> float:
        """The window's start on ``time.perf_counter``'s clock."""
        return self._t0

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def open_window(self) -> None:
        """Set-up ends here: start the profiler in a traced run, and the clock."""
        import torch
        from signaltrain_tpu_torch.ops import _cuda

        self.synchronize()
        self._launches0 = _cuda.launch_counts()
        if self.device.type == "cuda":
            self.sampler = card_mod.Sampler(self.device.index or 0)
            self.sampler.start()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.setup_s = time.time() - PROCESS_START
        self._t0 = time.perf_counter()
        if self.prof is not None:
            self._window = torch.profiler.record_function("portbench_window")
            self._window.__enter__()

    def close_window(self) -> float:
        """The window's seconds, from its start to the end of its last work."""
        self.synchronize()
        seconds = time.perf_counter() - self._t0
        if self.sampler is not None:
            self.sampler.stop()
        if self.prof is not None:
            self._window.__exit__(None, None, None)
            self.synchronize()
            self.prof.__exit__(None, None, None)
            fd, self.trace_path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
            os.close(fd)
            self.prof.export_chrome_trace(self.trace_path)
            self.prof = None
        return seconds

    def launches(self) -> dict:
        from signaltrain_tpu_torch.ops import _cuda

        now = _cuda.launch_counts()
        return {k: v - self._launches0.get(k, 0) for k, v in now.items()
                if v != self._launches0.get(k, 0)}

    def plain_calls(self) -> dict:
        from signaltrain_tpu_torch.ops import _cuda

        return {n: c.plain_calls for n, c in _cuda.COUNTERS.items() if c.plain_calls}

    def memory_peak(self) -> int:
        """The most the caching allocator held on the card since the process
        started: set-up and window, before the reference runs."""
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def load_metric(name: str):
    """The reader ``metrics/<name>.py``: its ``read(trace, outcome, run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_entries(name: str) -> tuple[dict, list, list]:
    """(the cell's entry, its end-to-end metrics, its per-layer metrics) in
    BENCHMARK.json."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name]) and m["moves"] in reported]
    return cell, e2e, layer


def card_state(r: Run) -> dict:
    """The card's name, and its state through the window (``card.Sampler``)."""
    import torch

    if r.device.type != "cuda":
        return {"kind": "cpu"}
    state = r.sampler.state() if r.sampler is not None else card_mod.smi_state(r.device.index or 0)
    return {"kind": torch.cuda.get_device_name(r.device), **state}


def loaded_forbidden() -> list[str]:
    """Modules in sys.modules whose top-level name is JAX's, flax's or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def execute(workload: str, seed: int, seconds: float, trace: bool, device) -> tuple[dict, dict]:
    """One run of the cell: (result, card line). Needs nothing of a card
    itself: ``device`` may be the CPU, as the benchmark's own tests run it."""
    cell, e2e, layer = cell_entries(workload)
    r = Run(workload, seed, seconds, trace, device)
    driver = importlib.import_module(f"portbench.drivers.{r.workload['driver']}")
    out = driver.run(r)
    card = card_state(r)
    use = resource.getrusage(resource.RUSAGE_SELF)
    card_line = {"card": card, "launches": r.launches(), "plain_calls": r.plain_calls(),
                 "process": {"user_s": use.ru_utime, "sys_s": use.ru_stime,
                             "minor_faults": use.ru_minflt, "max_rss_kib": use.ru_maxrss},
                 "window": {k: v for k, v in out.window.items() if not isinstance(v, list)}}
    correct, checks = compare.judge(out.numbers, r.workload["limits"], out.failed)
    import torch

    if r.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(r.device),
               "count": cell["chips"], "memory_peak_bytes": out.memory_peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": {}, "device": dev}
    if trace:
        tr = Trace(r.trace_path)
        try:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            for m in layer:
                value = load_metric(m["name"])(tr, out, r)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = tr.breakdown()
        finally:
            os.unlink(r.trace_path)
    else:
        values = dict(out.end_to_end, setup_s=r.setup_s)
        for m in e2e:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["checks"] = checks
    return result, card_line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    cell, _, _ = cell_entries(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {a.workload} needs {cell['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    result, card_line = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                                torch.device("cuda", 0))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(card_line))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
