"""The switched one-pole envelope smoother, plain PyTorch.

This is the plain version of kernel C (``ops/cuda_kernels.py``,
``csrc/smoother.cu``), and what runs for tensors on the CPU:

    s[0] = 0;  for n >= 1:
        alpha = alpha_a if g[n] < s[n-1] else alpha_r
        s[n]  = (1-alpha)*g[n] + alpha*s[n-1]

The switch makes the recursion non-associative, so there is no exact
parallel scan: a Python loop over time, vectorised over the leading axes.

Rounding: each step is fma(alpha, s[n-1], (1-alpha)*g[n]), one rounding for
the product and the sum, which is what the JAX package's compiled scan and
the kernel compute (a rounding difference would otherwise accumulate through
the recursion, up to ~1/(1-alpha) steps). Here the product of two float32
values is exact in float64, so the step is taken in float64 and rounded to
float32 once more.
"""

from __future__ import annotations

import torch

from ..ops import _cuda

SMOOTHER = _cuda.counter("switched_one_pole")


def switched_one_pole(g: torch.Tensor, alpha_a, alpha_r) -> torch.Tensor:
    """g: (..., N); alpha_a, alpha_r: scalars or tensors of shape g.shape[:-1]
    (or broadcastable to it). Returns s with g's shape."""
    SMOOTHER.plain_calls += 1
    lead = g.shape[:-1]
    aa = torch.as_tensor(alpha_a, dtype=g.dtype, device=g.device).expand(lead)
    ar = torch.as_tensor(alpha_r, dtype=g.dtype, device=g.device).expand(lead)
    cand_a = ((1.0 - aa)[..., None] * g).double()  # (1-alpha)*g[n], float32 products
    cand_r = ((1.0 - ar)[..., None] * g).double()
    aa64, ar64 = aa.double(), ar.double()
    out = torch.empty_like(g)
    prev = torch.zeros(lead, dtype=g.dtype, device=g.device)
    out[..., 0] = prev
    for n in range(1, g.shape[-1]):
        attack = g[..., n] < prev
        alpha = torch.where(attack, aa64, ar64)
        cand = torch.where(attack, cand_a[..., n], cand_r[..., n])
        prev = (alpha * prev.double() + cand).to(g.dtype)
        out[..., n] = prev
    return out
