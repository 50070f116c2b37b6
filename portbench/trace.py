"""Reading a torch.profiler trace: device time, idle gaps and the split of a
train step's replays.

``Trace(path)`` loads a Chrome-format trace that ``torch.profiler`` exported
and keeps its window: the ``portbench_window`` range that the driver put
around the traced work. ``block_split`` is a frozen copy of
``chip_smoke.block_split`` (``chip_smoke.py:1536``) and ``kernel_base`` of
``chip_smoke.kernel_base`` (:1527); the kernel names of a layer are the
lines of ``kernels/<layer>/*.txt``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_EVENTS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
KERNELS = Path(__file__).resolve().parent / "kernels"


def kernel_names(layer: str) -> set[str]:
    """Every name listed in ``kernels/<layer>/*.txt`` (``#`` starts a comment)."""
    names = set()
    for f in sorted((KERNELS / layer).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.add(line)
    return names


def kernel_base(name: str) -> str:
    """A kernel's function name without namespaces, template arguments or
    parameters."""
    n = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", n, 1)[0].split("::")[-1].strip()


def union_s(intervals) -> float:
    """Seconds covered by a list of (start_us, end_us)."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, path, window: str = "portbench_window"):
        with open(path) as f:
            self.events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        spans = [e for e in self.events if e.get("name") == window
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise RuntimeError(f"trace: {len(spans)} {window} ranges, not 1")
        self.t0, self.t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_EVENTS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def clipped(self, events):
        return [(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)) for e in events]

    def busy_s(self, cats=DEVICE_EVENTS) -> float:
        """Seconds of the window in which an operation of ``cats`` ran."""
        return union_s(self.clipped(e for e in self.device if e["cat"] in cats))

    def layer_s(self, layer: str) -> float:
        """Seconds of the window in kernels listed for ``layer``."""
        names = kernel_names(layer)
        return union_s(self.clipped(e for e in self.device if e["cat"] == "kernel"
                                    and kernel_base(e["name"]) in names))

    def spans(self, name: str) -> list:
        return [e for e in self.events if e.get("name") == name
                and e.get("cat") == "user_annotation" and self.t0 <= e["ts"] <= self.t1]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations of most time, and the longest idle gaps named
        by the innermost host event that was running at the gap's middle."""
        by_name = {}
        for e in self.device:
            key = kernel_base(e["name"]) if e["cat"] == "kernel" else e["name"]
            by_name[key or e["name"]] = by_name.get(key or e["name"], 0.0) + e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        busy = merged(self.clipped(self.device))
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        host = [e for e in self.events if e.get("cat") in HOST_EVENTS]
        named = []
        for s, e in gaps:
            mid = (s + e) / 2
            over = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
            who = min(over, key=lambda h: h["dur"])["name"] if over else "host: no traced call"
            named.append([who, (e - s) / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}

    def block_split(self, steps_per_block: int, layer: str = "frontend") -> dict:
        """The card's time a step over the window's ``train_block`` ranges
        (all graph replays), in five groups by each replay's kernel order:
        its device events grouped by the correlation of their
        cudaGraphLaunch, the layer's kernels in four runs (A; B; E; D),
        data synthesis before the first run, the autoencoders and the loss
        between them (the loss between the second and the third), clip +
        Adam after the last. Returns seconds a step by group; None where the
        window replayed no graph."""
        lib_names = kernel_names(layer)
        blocks = self.spans("train_block")
        launches = set()
        for b in blocks:
            launches |= {e["args"]["correlation"] for e in self.events
                         if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")
                         and b["ts"] <= e["ts"] <= b["ts"] + b["dur"]}
        steps = len(blocks) * steps_per_block
        if not launches:  # no graph replays (a run on the CPU): nothing to split
            return None
        if len(launches) != steps:
            raise RuntimeError(f"trace: {len(launches)} graph launches, not {steps}")
        replays = {}
        for e in self.events:
            if e.get("cat") in DEVICE_EVENTS and e.get("args", {}).get("correlation") in launches:
                replays.setdefault(e["args"]["correlation"], []).append(e)
        if len(replays) != steps:
            raise RuntimeError(f"trace: device events of {len(replays)} replays, not {steps}")
        groups = ("data_synthesis", "frontend_kernels", "autoencoders", "loss", "clip_adam")
        s = dict.fromkeys(groups, 0.0)
        for evs in replays.values():
            evs.sort(key=lambda e: e["ts"])
            lib = [kernel_base(e["name"]) in lib_names for e in evs]
            starts = [i for i in range(len(evs)) if lib[i] and (i == 0 or not lib[i - 1])]
            ends = [i for i in range(len(evs)) if lib[i] and (i + 1 == len(evs) or not lib[i + 1])]
            if len(starts) != 4:
                raise RuntimeError(f"trace: a replay's front-end kernels in {len(starts)} runs, "
                                   "not 4")
            for i, e in enumerate(evs):
                if lib[i]:
                    g = "frontend_kernels"
                elif i < starts[0]:
                    g = "data_synthesis"
                elif i > ends[3]:
                    g = "clip_adam"
                elif ends[1] < i < starts[2]:
                    g = "loss"
                else:
                    g = "autoencoders"
                s[g] += e["dur"] / 1e6 / steps
        return s
