"""Profiling for the port: a trace file, and the program's own spans and counts.

Counterpart of signaltrain_tpu/utils/profiling.py:

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that records the host and, for a run on the card, CUDA activity, and
  writes a Chrome-format trace (``*.pt.trace.json``, loadable by
  TensorBoard's profiler plugin and by Perfetto) into ``logdir``. On the
  card, a trace that holds no CUDA kernel raises: the profiler did not see
  the device.

The program's spans (``span``) and counts (``count``) are **active** while a
``torch.profiler`` session records or inside ``recording(True)`` (``train()``'s
loop under ``ST_TPU_TIMING=1``, on the primary rank). Inactive, a
span is one flag check and one shared no-op object. An active span enters
``torch.profiler.record_function(name)`` when the profiler records, so it
sits on the trace's host timeline, on the clock of the card's events, and
appends a ``Record`` to a bounded buffer that ``take()`` empties: its name,
its ``perf_counter_ns`` start and end, its parent's ``seq``, the ``id`` it
shares with the spans of its request or step, and its counts. Names carry a
``train.`` or ``predict_long`` prefix.

The train step's phases (``phase``: synthesis, forward, loss, backward,
update) are marked where the step's code crosses them. Inside a CUDA graph's
capture (``GraphMarks``, ``training/graphs.py``) a mark records how many
device nodes (kernel, memcpy and memset: what CUPTI traces) the graph holds
so far, through ``csrc/graph_nodes.cu``; a replay of a single-stream
capture runs its nodes in that order, so the marks split every replay's
device events at no cost a replay. ``graph_phases(name)`` gives a named
graph's marks. Outside a capture, inside an open span, a phase is a host
span ``train.<name>``, which ends at the next phase or with the span around
it; outside any span it records nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 17  # records kept until ``take``; later ones are counted and dropped


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    seq: int
    parent: int | None  # the enclosing span's seq
    id: int  # shared by the spans of one request or step
    counts: dict | None


class GraphPhases(NamedTuple):
    """A captured graph's phase marks: (name, device nodes before it), in
    capture order, and its device nodes in all."""

    marks: tuple
    total: int


_recording = False
_records: list[Record] = []
_dropped = 0
_ids = itertools.count()
_seqs = itertools.count()
_local = threading.local()  # .top: the innermost open span; .phase: the open phase span
_capture: GraphMarks | None = None
_graphs: dict[str, GraphPhases] = {}


def active() -> bool:
    """Whether spans record now: a profiler session records, or
    ``recording`` turned them on."""
    return _recording or _autograd_profiler._is_profiler_enabled


@contextlib.contextmanager
def recording(on: bool):
    """Spans on (or off, but for a profiler session) for the block."""
    global _recording
    before, _recording = _recording, on
    try:
        yield
    finally:
        _recording = before


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "counts", "parent", "seq", "start", "fn")

    def __init__(self, name: str, id: int | None):
        self.name, self.id, self.counts = name, id, None

    def _open(self) -> None:
        self.parent = getattr(_local, "top", None)
        if self.id is None:
            self.id = self.parent.id if self.parent is not None else next(_ids)
        self.seq = next(_seqs)
        self.fn = None
        if _autograd_profiler._is_profiler_enabled:
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        self.start = time.perf_counter_ns()

    def _close(self, end: int) -> None:
        global _dropped
        if self.fn is not None:
            self.fn.__exit__(None, None, None)
        if len(_records) < CAPACITY:
            _records.append(Record(self.name, self.start, end, self.seq,
                                   None if self.parent is None else self.parent.seq, self.id,
                                   self.counts))
        else:
            _dropped += 1

    def __enter__(self):
        self._open()
        _local.top = self
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        ph = getattr(_local, "phase", None)
        if ph is not None and ph.parent is self:
            _local.phase = None
            ph._close(end)
        _local.top = self.parent
        self._close(end)
        return False


def span(name: str, id: int | None = None):
    """``with span("predict_long.pull"): ...``: an active span is recorded
    (module docstring); an inactive one is the shared no-op. ``id`` names the
    step or request; without it a span takes its parent's, and a span with
    no parent a new process-wide number."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, id)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``key`` in the innermost open span's counts; nothing
    when no span is open."""
    top = getattr(_local, "top", None)
    if top is not None:
        if top.counts is None:
            top.counts = {}
        top.counts[key] = top.counts.get(key, 0) + n


def phase(name: str) -> None:
    """The train step enters phase ``name``: a mark in the capture in
    progress, else, inside an open span (``train.step``), the host span
    ``train.<name>`` in place of the open phase span. A phase outside any
    span records nothing: its span would have nothing to end it."""
    if _capture is not None:
        _capture.mark(name)
        return
    top = getattr(_local, "top", None)
    if top is None:
        return
    ph = getattr(_local, "phase", None)
    if ph is not None:
        ph._close(time.perf_counter_ns())
    ph = _Span("train." + name, None)
    ph._open()
    _local.phase = ph


def take() -> tuple[list[Record], int]:
    """(the records kept since the last take, in the order the spans ended;
    how many the full buffer dropped), and an empty buffer."""
    global _records, _dropped
    out, dropped = _records, _dropped
    _records, _dropped = [], 0
    return out, dropped


def self_times(records, names) -> dict[str, float]:
    """Seconds of each span named in ``names``, less the time of the spans
    of ``names`` inside it (at any depth, through spans of other names):
    the buckets' self times, summed by name."""
    by_seq = {r.seq: r for r in records}
    out = dict.fromkeys(names, 0.0)
    for r in records:
        if r.name not in out:
            continue
        s = (r.end_ns - r.start_ns) / 1e9
        out[r.name] += s
        up = by_seq.get(r.parent)
        while up is not None and up.name not in out:
            up = by_seq.get(up.parent)
        if up is not None:
            out[up.name] -= s
    return out


def _device_nodes_fn():
    from ..ops import _cuda

    return _cuda.function("graph_nodes", "st_capture_device_nodes",
                          [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)])


class GraphMarks:
    """The phase marks of one CUDA graph's capture on ``stream``: ``with
    marks: body()`` inside ``torch.cuda.graph``; then the marks and the
    graph's device nodes when the body ended are published as
    ``graph_phases(name)``. The node counter is loaded when the object is
    made, before the capture."""

    def __init__(self, stream: torch.cuda.Stream, name: str):
        self.stream = ctypes.c_void_p(stream.cuda_stream)
        self.name = name
        self.fn = _device_nodes_fn()
        self.marks: list[tuple[str, int]] = []

    def nodes(self) -> int:
        from ..ops import _cuda

        n = ctypes.c_longlong()
        _cuda.check(self.fn, self.fn(self.stream, ctypes.byref(n)))
        return n.value

    def mark(self, name: str) -> None:
        self.marks.append((name, self.nodes()))

    def __enter__(self):
        global _capture
        _capture = self
        return self

    def __exit__(self, *exc):
        global _capture
        _capture = None
        if exc[0] is None:
            _graphs[self.name] = GraphPhases(tuple(self.marks), self.nodes())
        return False


def graph_phases(name: str) -> GraphPhases | None:
    """The phase marks of the last graph captured under ``name`` in this
    process (``"train"``: ``graphs.TrainGraph``'s step), or None."""
    return _graphs.get(name)


@contextlib.contextmanager
def trace(logdir: str = "signaltrain_trace", cuda: bool | None = None):
    """Capture a trace: ``with profiling.trace("dir"): run_steps()``.
    ``cuda`` (default: whether a card is present) adds CUDA activity. Yields
    the ``torch.profiler.profile``; the trace file is written when the block
    ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    before = set(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    written = sorted(set(glob.glob(os.path.join(logdir, "*.pt.trace.json"))) - before)
    if not written:
        raise RuntimeError(f"profiler: no trace written into {logdir}")
    if cuda:
        with open(written[-1]) as f:
            if '"cat": "kernel"' not in f.read():
                raise RuntimeError(f"profiler: {written[-1]} holds no CUDA kernel")
    print(f"profiler trace written to {written[-1]}")
