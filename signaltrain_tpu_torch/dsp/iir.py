"""The switched one-pole envelope smoother, plain PyTorch.

This is the plain version of kernel C (``ops/cuda_kernels.py``,
``csrc/smoother.cu``), and what runs for tensors on the CPU:

    s[0] = 0;  for n >= 1:
        alpha = alpha_a if g[n] < s[n-1] else alpha_r
        s[n]  = (1-alpha)*g[n] + alpha*s[n-1]

The switch makes the recursion non-associative, so there is no exact
parallel scan: a sequential loop over time, one row at a time, on Python
floats (a loop of tensor operations costs ~100x more a step).

Rounding: each step is fma(alpha, s[n-1], (1-alpha)*g[n]), one rounding for
the product and the sum, which is what the JAX package's compiled scan and
the kernel compute (a rounding difference would otherwise accumulate through
the recursion, up to ~1/(1-alpha) steps). The products (1-alpha)*g[n] are
formed in float32 by PyTorch; the product of two float32 values is exact in
a Python float (float64), so the step is taken in float64 and rounded to
float32 once more.
"""

from __future__ import annotations

import struct

import torch

from ..ops import _cuda

SMOOTHER = _cuda.counter("switched_one_pole")

_F32 = struct.Struct("f")


def _smooth_row(g: list, cand_a: list, cand_r: list, aa: float, ar: float) -> list:
    """One row of the recursion on Python floats; s[0] = 0."""
    pack, unpack = _F32.pack, _F32.unpack
    out = [0.0] * len(g)
    s = 0.0
    for n in range(1, len(g)):
        if g[n] < s:
            (s,) = unpack(pack(aa * s + cand_a[n]))
        else:
            (s,) = unpack(pack(ar * s + cand_r[n]))
        out[n] = s
    return out


def switched_one_pole(g: torch.Tensor, alpha_a, alpha_r) -> torch.Tensor:
    """g: (..., N) float32; alpha_a, alpha_r: scalars or tensors of shape
    g.shape[:-1] (or broadcastable to it). Computes on the CPU and returns s
    with g's shape, on g's device."""
    SMOOTHER.plain_calls += 1
    if g.dtype != torch.float32:
        raise TypeError(f"switched_one_pole: dtype {g.dtype}, expected torch.float32")
    lead, n = g.shape[:-1], g.shape[-1]
    gc = g.detach().cpu()
    aa = torch.as_tensor(alpha_a, dtype=torch.float32).cpu().expand(lead)
    ar = torch.as_tensor(alpha_r, dtype=torch.float32).cpu().expand(lead)
    cand_a = ((1.0 - aa)[..., None] * gc).reshape(-1, n).tolist()  # (1-alpha)*g[n], float32
    cand_r = ((1.0 - ar)[..., None] * gc).reshape(-1, n).tolist()
    rows = gc.reshape(-1, n).tolist()
    aa, ar = aa.reshape(-1).tolist(), ar.reshape(-1).tolist()
    out = [_smooth_row(rows[i], cand_a[i], cand_r[i], aa[i], ar[i]) for i in range(len(rows))]
    return torch.tensor(out, dtype=torch.float32).reshape(g.shape).to(g.device)
