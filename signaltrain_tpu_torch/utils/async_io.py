"""Background writing for the training loop: checkpoints and plots off the
loop's thread.

Counterpart of signaltrain_tpu/utils/async_io.py. Two pieces:

* ``AsyncWriter``: one daemon thread draining a FIFO of closures. One thread,
  not a pool, so writes to the same files (checkpoints, PNGs) keep their
  submission order. A failing closure is printed at once (the loop goes on
  training) and the first failure is raised from ``close()``, so a run whose
  checkpoint save failed cannot end looking successful.
* ``snapshot(obj)``: an on-card copy of every tensor of a nested
  dict / list / tuple, taken on the current stream, with one
  ``torch.cuda.Event`` recorded after the copies. The training step's CUDA
  graph updates the parameters and Adam's state in place on its next replay,
  so the writer reads the copies, never the live tensors: ``Snapshot.to_host``
  waits on the event on a stream of its own, copies to pinned host memory
  there, and marks each copy as used on that stream (``record_stream``), so
  the caching allocator cannot hand the memory out again before the reads
  are done. On the CPU a snapshot is a plain clone.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable

import torch


def _map(fn, obj):
    """``obj`` with ``fn`` applied to every tensor of its nested dicts, lists
    and tuples; other leaves pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    return obj


def _devices(obj) -> set:
    found = set()
    _map(lambda t: found.add(t.device), obj)
    return found


class Snapshot:
    """Copies of a nested structure's tensors, and the event after them (None
    on the CPU)."""

    def __init__(self, tree, event: torch.cuda.Event | None):
        self.tree = tree
        self.event = event

    def to_host(self) -> Any:
        """The structure with every tensor on the CPU. From any thread: on the
        card it waits on the snapshot's event on a side stream, then copies
        there and waits for the copies."""
        if self.event is None:
            return self.tree
        dev = next(iter(_devices(self.tree)))
        stream = torch.cuda.Stream(dev)
        stream.wait_event(self.event)

        def fetch(t):
            t.record_stream(stream)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            return host

        with torch.cuda.stream(stream):
            out = _map(fetch, self.tree)
        stream.synchronize()
        return out


def snapshot(obj) -> Snapshot:
    """On-device copies of every tensor of ``obj`` (nested dicts, lists,
    tuples), enqueued on the current stream; returns at once. On a CUDA
    device one event is recorded after the copies, and ``Snapshot.to_host``
    waits on it. All tensors must lie on one device."""
    devs = _devices(obj)
    if len(devs) > 1:
        raise ValueError(f"snapshot: tensors on several devices {sorted(map(str, devs))}")
    tree = _map(lambda t: t.detach().clone(), obj)
    event = None
    if devs and next(iter(devs)).type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(next(iter(devs))))
    return Snapshot(tree, event)


class AsyncWriter:
    """FIFO background executor for the loop's writes (plots, checkpoints)."""

    def __init__(self, name: str = "st-obs-writer"):
        self._q: queue.Queue = queue.Queue()
        self._first_error: Exception | None = None
        self._thread = threading.Thread(target=self._work, name=name, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def _work(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:  # the loop keeps training; close() raises it
                traceback.print_exc()
                if self._first_error is None:
                    self._first_error = e

    def close(self, timeout: float | None = None) -> None:
        """Drain the queue and join the worker (once, at the end of the run).
        Raises the first closure failure, if any."""
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._first_error is not None:
            raise RuntimeError("a background write failed during the run") from self._first_error
