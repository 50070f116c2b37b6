"""The switched one-pole envelope smoother (kernel C).

Counterpart of signaltrain_tpu/ops/pallas_kernels.py
``switched_one_pole_batched``. The kernel is hand-written CUDA C++ for
Hopper in ``csrc/smoother.cu`` (its header says what bounds it on the card
and how its design answers that); its plain version is
``dsp/iir.switched_one_pole``.

The wrapper dispatches on the device of ``g``: a CPU tensor goes to the
plain version, a CUDA tensor launches the kernel or raises. On the card it
chooses one of the kernel's two schedules by shape (``uses_chunks``); both
are exact and give bit-equal results. The TPU wrapper's
custom_partitioning / custom_vmap shells have no counterpart: a batch is one
(B, N) call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..dsp import iir
from . import _cuda

SMOOTHER = iir.SMOOTHER
# the launches of SMOOTHER that ran the chunked schedule (the rest ran the row one)
SMOOTHER_CHUNKED = _cuda.counter("switched_one_pole_chunked")
switched_one_pole_reference = iir.switched_one_pole

CHUNK = 1024               # samples a chunk (a multiple of the kernel's 256-step tile)
CHUNK_MIN_N = 65536        # rows shorter than this take the row schedule
MAX_VIRTUAL_ROWS = 4096    # ... and so do batches of more chunks than this

_ROWS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
_CHUNKED_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                         ctypes.c_void_p]


def uses_chunks(batch: int, n: int) -> bool:
    """The dispatch rule: a (batch, n) call runs chunked when its rows are at
    least CHUNK_MIN_N long and the batch has at most MAX_VIRTUAL_ROWS chunks
    in all. A few long rows leave the card idle under one thread a row; a
    batch of many rows fills it already, and short rows gain nothing from a
    warm-up of up to 65,536 steps."""
    return n >= CHUNK_MIN_N and batch * math.ceil(n / CHUNK) <= MAX_VIRTUAL_ROWS


def _checked(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor) -> tuple[int, int]:
    if g.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got one on {g.device}")
    if g.dim() != 2:
        raise ValueError(f"switched_one_pole_batched: g must be (B, N), got {tuple(g.shape)}")
    b, n = g.shape
    if b < 1 or n < 1:
        raise ValueError(f"switched_one_pole_batched: empty input {tuple(g.shape)}")
    _cuda.require(g, "g", (b, n), g.device)
    _cuda.require(alpha_a, "alpha_a", (b,), g.device)
    _cuda.require(alpha_r, "alpha_r", (b,), g.device)
    return b, n


def smoother_rows(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor) -> torch.Tensor:
    """Kernel C's row schedule on CUDA tensors: one thread walks each row."""
    b, n = _checked(g, alpha_a, alpha_r)
    out = torch.empty_like(g)
    f = _cuda.function("smoother", "st_smoother", _ROWS_ARGS)
    with torch.cuda.device(g.device):
        status = f(_cuda.ptr(g), _cuda.ptr(alpha_a), _cuda.ptr(alpha_r), _cuda.ptr(out),
                   b, n, _cuda.stream(g.device))
    _cuda.check(f, status)
    SMOOTHER.launches += 1
    return out


def smoother_chunked(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor,
                     chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's chunked schedule on CUDA tensors (speculate, then verify;
    ``csrc/smoother.cu``). Returns s and stats, an int64 (B, 2) tensor on the
    card: each row's warm-up W in steps, and the steps its verification
    re-ran from an exact carry."""
    b, n = _checked(g, alpha_a, alpha_r)
    if chunk <= 0 or chunk % 256:
        raise ValueError(f"smoother_chunked: chunk {chunk} is not a positive multiple of 256")
    out = torch.empty_like(g)
    spec = torch.empty(b, math.ceil(n / chunk), dtype=torch.float32, device=g.device)
    stats = torch.empty(b, 2, dtype=torch.int64, device=g.device)
    f = _cuda.function("smoother", "st_smoother_chunked", _CHUNKED_ARGS)
    with torch.cuda.device(g.device):
        status = f(_cuda.ptr(g), _cuda.ptr(alpha_a), _cuda.ptr(alpha_r), _cuda.ptr(out),
                   _cuda.ptr(spec), _cuda.ptr(stats), b, n, chunk, _cuda.stream(g.device))
    _cuda.check(f, status)
    SMOOTHER.launches += 1
    SMOOTHER_CHUNKED.launches += 1
    return out, stats


def switched_one_pole_batched(g: torch.Tensor, alpha_a: torch.Tensor,
                              alpha_r: torch.Tensor) -> torch.Tensor:
    """g: (B, N) float32; alpha_a, alpha_r: (B,) per-row coefficients.
    Returns s (B, N) with s[:, 0] = 0 and
    s[n] = (1-a)*g[n] + a*s[n-1], a = alpha_a if g[n] < s[n-1] else alpha_r.
    On the card the schedule follows ``uses_chunks(B, N)``."""
    if g.device.type == "cpu":
        return switched_one_pole_reference(g, alpha_a, alpha_r)
    b, n = _checked(g, alpha_a, alpha_r)
    if uses_chunks(b, n):
        return smoother_chunked(g, alpha_a, alpha_r)[0]
    return smoother_rows(g, alpha_a, alpha_r)
