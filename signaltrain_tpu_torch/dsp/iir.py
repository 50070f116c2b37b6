"""IIR filtering, plain PyTorch: the Butterworth design, ``lfilter`` and the
switched one-pole envelope smoother.

Counterparts of signaltrain_tpu/dsp/iir.py. Both recursions are sequential
per-sample loops; on a CUDA tensor each runs as a hand-written kernel
(``ops/cuda_kernels.py``: kernel L, ``csrc/iir.cu``, for ``lfilter``; kernel
C, ``csrc/smoother.cu``, for the smoother), and the plain versions here run
for tensors on the CPU.

``butter_lowpass`` is the JAX package's real-arithmetic design (conjugate
pole pairs as quadratic factors), step for step in float32, so that the
coefficients track the JAX ones and not scipy's float64 ones: a third-order
low-pass at 10 Hz has its poles within 1.5e-3 of z = 1, where an ulp of a
coefficient moves the filter.

``lfilter`` is direct form II transposed with per-row coefficients, b and a
normalised by a[0]. Rounding: the JAX package's compiled scan (XLA on the
CPU) contracts its step into fused multiply-adds, found by matching its
output bit for bit:

    y     = fma(b0, x, z0)
    z_i   = fma(-a_{i+1}, y, fma(b_{i+1}, x, z_{i+1}))    i < order - 1
    z_o-1 = fma(b_o, x, -(a_o * y))

The plain version and kernel L take the same steps. The plain version forms
each fma in a Python float (float64, where the product of two float32 values
is exact) and rounds to float32 once, as the smoother's does.

The smoother (plain version of kernel C):

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

import math
import struct

import numpy as np
import torch

from ..ops import _cuda

SMOOTHER = _cuda.counter("switched_one_pole")
LFILTER = _cuda.counter("lfilter")

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


# ------------------------------------------------------------- Butterworth

def butter_lowpass(order: int, wn) -> tuple[torch.Tensor, torch.Tensor]:
    """Digital Butterworth low-pass design, the JAX package's
    ``butter_lowpass`` step for step: analog prototype, pre-warp, bilinear
    transform with scipy's fs = 2 convention, in real float32 arithmetic.

    order: int; wn: the cutoff over Nyquist (0 < wn < 1), a number or a
    float32 tensor of any shape (per-row cutoffs). Returns (b, a), each of
    shape wn.shape + (order + 1,), a[..., 0] == 1, on wn's device (a number
    goes to the CPU)."""
    wn = wn if isinstance(wn, torch.Tensor) else torch.tensor(float(wn), dtype=torch.float32)
    theta = np.pi * np.arange(-order + 1, order, 2) / (2 * order)
    fs2 = 4.0  # 2 * fs with scipy's fs = 2
    warped = fs2 * torch.tan(math.pi * wn / 2.0)
    one = torch.ones_like(warped)
    a = one[..., None]
    prod_fs2_minus_p = one
    for t in theta:
        if abs(np.sin(t)) < 1e-12:  # the real pole (odd order)
            pr = float(-np.cos(t)) * warped
            pd = (fs2 + pr) / (fs2 - pr)
            a = _polymul(a, torch.stack([one, -pd], -1))
            prod_fs2_minus_p = prod_fs2_minus_p * (fs2 - pr)
        elif t > 0:  # each conjugate pair once
            pr = float(-np.cos(t)) * warped
            pi = float(-np.sin(t)) * warped
            den = (fs2 - pr) ** 2 + pi**2
            pd_re = ((fs2 + pr) * (fs2 - pr) - pi**2) / den
            pd_abs2 = ((fs2 + pr) ** 2 + pi**2) / den
            a = _polymul(a, torch.stack([one, -2.0 * pd_re, pd_abs2], -1))
            prod_fs2_minus_p = prod_fs2_minus_p * den
    kd = _integer_pow(warped, order) / prod_fs2_minus_p
    b = torch.stack([kd * float(math.comb(order, k)) for k in range(order + 1)], -1)
    return b, a


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary exponentiation, the order of products of
    ``lax.integer_pow`` (x**3 = x * (x * x))."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _polymul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Polynomial product over the last axis (highest degree first), adding
    q[i] * p at offset i for i = 0, 1, ... as the JAX ``_polymul`` does."""
    n, m = p.shape[-1], q.shape[-1]
    out = p.new_zeros(p.shape[:-1] + (n + m - 1,))
    for i in range(m):
        out = torch.cat([out[..., :i], out[..., i : i + n] + q[..., i : i + 1] * p,
                         out[..., i + n :]], -1)
    return out


def lfilter_zi(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Initial state for the step response's steady state
    (scipy.signal.lfilter_zi): solves (I - A^T) zi = b[1:] - a[1:] b[0] for
    the direct-form-II-transposed companion matrix A. b, a: (..., order+1)
    with a[..., 0] == 1; returns (..., order)."""
    n = b.shape[-1] - 1
    eye = torch.eye(n, dtype=b.dtype, device=b.device)
    companion = torch.zeros(b.shape[:-1] + (n, n), dtype=b.dtype, device=b.device)
    companion[..., 0, :] = -a[..., 1:]
    companion[..., 1:, :-1] = eye[: n - 1, : n - 1]
    iminus = eye - companion.transpose(-1, -2)
    bvec = b[..., 1:] - a[..., 1:] * b[..., :1]
    return torch.linalg.solve(iminus, bvec)


# ---------------------------------------------------------------- lfilter

def _rows(b, a, x, zi):
    """(b, a, x, zi) as float32 (R, order+1), (R, order+1), (R, N), (R, order)
    on x's device, and the leading shape L the R rows fold: x is (..., N), and
    b, a (..., order+1) and zi (..., order) broadcast with x's leading axes
    into L, as in the JAX package's ``lfilter``; zi None gives zeros."""
    if x.dim() < 1:
        raise ValueError(f"lfilter: x must be (..., N), got {tuple(x.shape)}")
    order = b.shape[-1] - 1
    if order < 1 or a.shape[-1] != order + 1:
        raise ValueError(f"lfilter: b {tuple(b.shape)} and a {tuple(a.shape)} "
                         "need the same length >= 2")
    leads = [x.shape[:-1], b.shape[:-1], a.shape[:-1]] + ([] if zi is None else [zi.shape[:-1]])
    lead = torch.broadcast_shapes(*leads)
    rows = math.prod(lead)

    def fold(t, width):
        return t.to(torch.float32).broadcast_to(lead + (width,)).reshape(rows, width).contiguous()

    if zi is None:
        zi2 = torch.zeros(rows, order, dtype=torch.float32, device=x.device)
    else:
        zi2 = fold(zi, order)
    return fold(b, order + 1), fold(a, order + 1), fold(x, x.shape[-1]), zi2, lead


def _lfilter_row(x: list, bn: list, neg_a: list, z: list) -> list:
    """One row of the DF2T recursion on Python floats, each fma (or product)
    of the module docstring taken in float64 and rounded to float32 once."""
    pack, unpack = _F32.pack, _F32.unpack
    order = len(bn) - 1
    b0, b_last, a_last = bn[0], bn[order], neg_a[order]
    z = list(z)
    out = [0.0] * len(x)
    for n, xn in enumerate(x):
        (y,) = unpack(pack(b0 * xn + z[0]))
        for i in range(order - 1):
            (inner,) = unpack(pack(bn[i + 1] * xn + z[i + 1]))
            (z[i],) = unpack(pack(neg_a[i + 1] * y + inner))
        (t,) = unpack(pack(a_last * y))
        (z[order - 1],) = unpack(pack(b_last * xn + t))
        out[n] = y
    return out


def lfilter_reference(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
                      zi: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of kernel L: direct form II transposed over the last
    axis of x ((..., N) float32), with coefficients b, a of shape
    (..., order+1) and an initial state zi of shape (..., order) (zeros when
    None), broadcast over x's leading axes. Walks each row on Python floats
    on the CPU, as the smoother's plain version does (a loop of tensor
    operations costs ~30x more a step on one row); returns y of the
    broadcast leading shape and N samples, on x's device."""
    LFILTER.plain_calls += 1
    *folded, lead = _rows(b, a, x, zi)
    b2, a2, x2, zi2 = (t.detach().cpu() for t in folded)
    bn = (b2 / a2[:, :1]).tolist()
    neg_a = (-(a2 / a2[:, :1])).tolist()
    rows, z = x2.tolist(), zi2.tolist()
    out = [_lfilter_row(rows[r], bn[r], neg_a[r], z[r]) for r in range(len(rows))]
    return torch.tensor(out, dtype=torch.float32).reshape(lead + x.shape[-1:]).to(x.device)


def lfilter(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
            zi: torch.Tensor | None = None) -> torch.Tensor:
    """Apply an IIR filter along the last axis of x (direct form II
    transposed; the JAX package's ``lfilter``). x: (..., N) float32; b, a:
    (..., order+1); zi: (..., order), or None for a zero initial state; the
    leading axes broadcast, and fold into the rows of one call. Returns y of
    the broadcast leading shape and N samples. A CPU tensor runs the plain
    version, a CUDA tensor kernel L (``ops/cuda_kernels.lfilter_rows``, built
    for orders 1 and 3; another order raises); any other device raises."""
    if x.device.type == "cpu":
        return lfilter_reference(b, a, x, zi)
    from ..ops import cuda_kernels  # it imports this module

    *folded, lead = _rows(b, a, x, zi)
    return cuda_kernels.lfilter_rows(*folded).reshape(lead + x.shape[-1:])
