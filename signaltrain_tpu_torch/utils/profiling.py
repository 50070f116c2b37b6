"""Profiling helpers for the port.

Counterpart of signaltrain_tpu/utils/profiling.py:

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that records the host and, for a run on the card, CUDA activity, and
  writes a Chrome-format trace (``*.pt.trace.json``, loadable by
  TensorBoard's profiler plugin and by Perfetto) into ``logdir``. On the
  card, a trace that holds no CUDA kernel raises: the profiler did not see
  the device.
* ``StepTimer(warmup)``: wall-clock time a step that skips the first
  ``warmup`` steps (the capture's warm-up, the first kernel builds), with
  ``torch.cuda.synchronize`` of the result's device where the JAX package
  blocks until it is ready.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import torch


def _synchronize(result) -> None:
    if isinstance(result, torch.Tensor) and result.device.type == "cuda":
        torch.cuda.synchronize(result.device)


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


class StepTimer:
    """Wall-clock time a step that skips warmup iterations.

    >>> timer = StepTimer(warmup=5)
    >>> for i in range(100):
    ...     out = step(...)
    ...     timer.tick(out)
    >>> timer.mean_ms
    """

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self._count = 0
        self._t0: float | None = None
        self._timed_steps = 0
        self._last_result = None

    def tick(self, result=None) -> None:
        self._count += 1
        if self._count == self.warmup:
            _synchronize(result)
            self._t0 = time.perf_counter()
        elif self._count > self.warmup:
            self._timed_steps += 1
            self._last_result = result

    @property
    def mean_ms(self) -> float:
        if self._t0 is None or self._timed_steps == 0:
            return float("nan")
        _synchronize(self._last_result)
        return (time.perf_counter() - self._t0) / self._timed_steps * 1e3
