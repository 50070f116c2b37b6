"""The switched one-pole envelope smoother (kernel C).

Counterpart of signaltrain_tpu/ops/pallas_kernels.py
``switched_one_pole_batched``. The kernel is hand-written CUDA C++ for
Hopper in ``csrc/smoother.cu`` (its header says what bounds it on the card
and how its design answers that); its plain version is
``dsp/iir.switched_one_pole``.

The wrapper dispatches on the device of ``g``: a CPU tensor goes to the
plain version, a CUDA tensor launches the kernel or raises. The TPU
wrapper's custom_partitioning / custom_vmap shells have no counterpart: a
batch is one (B, N) call.
"""

from __future__ import annotations

import ctypes

import torch

from ..dsp import iir
from . import _cuda

SMOOTHER = iir.SMOOTHER
switched_one_pole_reference = iir.switched_one_pole

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]


def switched_one_pole_batched(g: torch.Tensor, alpha_a: torch.Tensor,
                              alpha_r: torch.Tensor) -> torch.Tensor:
    """g: (B, N) float32; alpha_a, alpha_r: (B,) per-row coefficients.
    Returns s (B, N) with s[:, 0] = 0 and
    s[n] = (1-a)*g[n] + a*s[n-1], a = alpha_a if g[n] < s[n-1] else alpha_r."""
    if g.device.type == "cpu":
        return switched_one_pole_reference(g, alpha_a, alpha_r)
    if g.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got one on {g.device}")
    dev = g.device
    if g.dim() != 2:
        raise ValueError(f"switched_one_pole_batched: g must be (B, N), got {tuple(g.shape)}")
    b, n = g.shape
    if b < 1 or n < 1:
        raise ValueError(f"switched_one_pole_batched: empty input {tuple(g.shape)}")
    _cuda.require(g, "g", (b, n), dev)
    _cuda.require(alpha_a, "alpha_a", (b,), dev)
    _cuda.require(alpha_r, "alpha_r", (b,), dev)
    out = torch.empty_like(g)
    f = _cuda.function("smoother", "st_smoother", _ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(g), _cuda.ptr(alpha_a), _cuda.ptr(alpha_r), _cuda.ptr(out),
                   b, n, _cuda.stream(dev))
    _cuda.check(f, status)
    SMOOTHER.launches += 1
    return out
