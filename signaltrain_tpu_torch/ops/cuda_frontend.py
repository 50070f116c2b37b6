"""Fused STFT analysis and iSTFT synthesis: kernels A, B (forward), D, E (backward).

Counterparts of signaltrain_tpu/ops/pallas_frontend.py. Each kernel is
hand-written CUDA C++ for Hopper: A and B in ``csrc/frontend.cu``, D and E in
``csrc/frontend_bwd.cu`` (the headers say what bounds each on the card and
how its design answers that); the products of all four share one
tensor-core main loop, ``csrc/tc_product.cuh``, which forms every f32 product
from three TF32 ones (``split_tf32_matmul`` below is that arithmetic in plain
PyTorch, for the tests and reports; nothing on the main path calls it). This
module holds the wrappers, the plain PyTorch version of every kernel, the two
``torch.autograd.Function``s and the weight stacking.

* ``fused_analysis(xp, w, ft, hop)``: padded signal (B, Lp), NOT pre-halved
  (the kernel applies the model's x/2) -> (mag, phs), each (T, B, half),
  frame-major, with T = (Lp - ft)//hop + 1.
* ``fused_synthesis(mag, phs, w, ft, hop)``: frame-major (OT, B, half)
  magnitude/phase -> trimmed waveform (B, (OT-1)*hop - ft).

Both differentiate: forward is kernel A / B, backward kernel D / E, saving
only (xp, w) and (mag, phs, w) and recomputing the rest.

* ``fused_analysis_bwd(xp, w, dmag, dphs, ft, hop)`` -> (dxp, dw).
* ``fused_synthesis_bwd(mag, phs, w, dout, ft, hop)`` -> (dmag, dphs, dw).

All four are bound by operations (f32-accurate matrix products). A product
whose output has too few tiles to fill the card (dW of D and E, B's frames,
E's dspec) has its K cut into a fixed number of contiguous slices
(``k_slices``), each output tile of a slice owned by one block, and the
slices are added in a fixed order by the pass that follows: no atomics, so
every result is bit-equal from run to run. The overlap-add of dxp (D) and of
the waveform (B) is a gather: each sample is owned by one thread that sums
the frames covering it. B and E work on the live frames only (1 .. OT-2, the
ones with samples inside the trimmed output).

One dispatch rule everywhere: a CPU tensor goes to the plain version, a CUDA
tensor launches the kernel or raises. Nothing gives way to a plain version on
the card.

Weight layouts: analysis (ft, 2*half), column c < half is bin c of the real
part and column half + c bin c of the imaginary part; synthesis (2*half, ft),
rows in the same order, with the conjugate mirror folded in
(``frontend.fold_synthesis_weights``). Unlike the TPU layout there is no
128-lane padding. The gradient of a stacked operand flows back to the
(ft, ft) parameters through the stacking and folding by plain autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda, framing

ANALYSIS = _cuda.counter("fused_analysis")
SYNTHESIS = _cuda.counter("fused_synthesis")
ANALYSIS_BWD = _cuda.counter("fused_analysis_bwd")
SYNTHESIS_BWD = _cuda.counter("fused_synthesis_bwd")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ANALYSIS_ARGS = [_P] * 5 + [_I] * 7 + [_P]
_SYNTHESIS_ARGS = [_P] * 7 + [_I] * 8 + [_P]
_ANALYSIS_BWD_ARGS = [_P] * 10 + [_I] * 10 + [_P]
_SYNTHESIS_BWD_ARGS = [_P] * 12 + [_I] * 10 + [_P]

# A product whose (m x n) output has too few tiles to fill the card has its K
# cut into slices (a fixed number for given shapes) whose partial sums the pass
# that follows adds in order. The tensor-core product (128 x 128 tiles, K step
# 32, two blocks of 110 KB shared memory an SM) takes as many slices as keep
# every full-width block on the card's 132 SMs at once (a second round of a few
# blocks would cost as much as a full one), and at least 8 K steps a slice; the
# blocks of a narrow last column tile are cheap and not counted.
_RESIDENT_BLOCKS = 2 * 132
_TILE = 128
_KSTEP = 32


def k_slices(m: int, n: int, k: int) -> int:
    """How many K slices the tensor-core product of an (m, n) output over K = k
    takes: kernel D's and E's dW, B's frames and E's dspec."""
    tiles = -(-m // _TILE) * max(1, n // _TILE)
    return max(1, min(_RESIDENT_BLOCKS // tiles, -(-k // _KSTEP) // 8))


def packed_width(half: int) -> int:
    """Columns of the repacked weights and of the interleaved spectra (re and
    im of a bin side by side): 2*half rounded up to a multiple of 4, so every
    row starts on 16 bytes."""
    return -(-2 * half // 4) * 4


def copy_width(ft: int, hop: int, lp: int, *tensors: torch.Tensor) -> int:
    """Floats per cp.async copy of the tensor-core products: 4 (16 bytes) when
    the frame offsets b*lp + t*hop, the frame length and every pointer are
    multiples of 4 floats, else 1. Two loaders of the same kernel. Kernel B's
    operands are rows of packed_width floats: only its pointers count."""
    aligned = ft % 4 == 0 and hop % 4 == 0 and lp % 4 == 0
    return 4 if aligned and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def stack_analysis_weights(w_real: torch.Tensor, w_imag: torch.Tensor, half: int) -> torch.Tensor:
    """(ft, ft) real and imaginary analysis matrices (rows are bins) ->
    (ft, 2*half) kernel operand. Rows >= half of the parameters are unused,
    as after the reference's post-conv slice."""
    return torch.cat([w_real[:half], w_imag[:half]], dim=0).t().contiguous()


def stack_synthesis_weights(wr_eff: torch.Tensor, wi_eff: torch.Tensor) -> torch.Tensor:
    """Folded (half, ft) synthesis matrices -> (2*half, ft) kernel operand."""
    return torch.cat([wr_eff, wi_eff], dim=0).contiguous()


def mag_phs(re: torch.Tensor, im: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude with the 1e-36 floor (edge frames that cover only padding
    give exactly 1e-18 and a zero gradient) and phase atan2(im, re + 1e-7)."""
    mag = torch.sqrt(torch.clamp_min(re * re + im * im, 1e-36))
    phs = torch.atan2(im, re + 1e-7)
    return mag, phs


# ------------------------------------- the kernels' arithmetic, in plain torch

def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (float32) -> (hi, lo), both TF32 values held in float32: hi is x
    rounded to 10 mantissa bits as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero: ``(bits + 0x1000) & ~0x1FFF``), lo is x - hi cut to
    10 mantissa bits (the tensor core ignores the low 13 bits of an operand).
    hi + lo recovers x to 2^-21 |x|; zeros split into zeros."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as kernels A, B, D and E form it on the tensor cores: three products
    of TF32 operands summed in float32, the small terms first. Not used on
    the main path: the tests and ``chip_smoke.py`` hold the kernels' accuracy
    against it."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def fused_analysis_bwd_conditioning(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                    dphs: torch.Tensor, ft: int, hop: int,
                                    sigma: float = 5e-7, k: float = 6.0):
    """How far kernel D's (dxp, dw) move, element by element, when every
    component of the recomputed spectrum moves at random by ``sigma``, as
    ``k`` standard deviations, in float64: (dxp_slack, dw_slack). Two f32
    spectra differ by up to ~1e-6 (the order of the sums; sigma is the largest
    error of an f32 product against a float64 one seen on the CPU), and the
    adjoints divide by the magnitude: with r = |spec|, d(re/r) <= 1/r and
    d(im/(rr^2 + im^2)) = 1/r^2 per unit, so dspec moves by
    sigma*(|dmag|/r + |dphs|/r^2), taken at r - k*sigma. That is pushed through
    the two linear products in quadrature (independent errors). It is huge on
    bins of near-zero magnitude (nothing can be said there) and exactly 0
    where the frame is all padding. Not used on the main path: the tests and
    ``chip_smoke.py`` add it to the tolerance of D's ill-conditioned case."""
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp.double(), ft, hop, pad=0).transpose(0, 1) * 0.5
    w = w.double()
    spec = torch.matmul(frames, w)
    re, im = spec[..., :half], spec[..., half:]
    r = torch.sqrt(re * re + im * im)
    r_near = torch.clamp_min(r - k * sigma, 1e-30)
    moved = sigma * (dmag.double().abs() / r_near + dphs.double().abs() / (r_near * r_near))
    moved = torch.where(r > 0, moved, torch.zeros_like(moved))  # an exact 0 stays exact
    var = torch.cat([moved, moved], dim=-1) ** 2
    dxp = framing.overlap_add((torch.matmul(var, (w * w).t()) * 0.25).transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    dw = torch.matmul((frames * frames).reshape(-1, ft).t(), var.reshape(-1, 2 * half))
    return k * torch.sqrt(dxp), k * torch.sqrt(dw)


# ------------------------------------------------------------ plain versions

def fused_analysis_reference(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    """Plain version of kernel A: framing, one GEMM, magnitude and phase."""
    ANALYSIS.plain_calls += 1
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp, ft, hop, pad=0) * 0.5  # (B, T, ft)
    spec = torch.matmul(frames.transpose(0, 1), w)  # (T, B, 2*half)
    return mag_phs(spec[..., :half], spec[..., half:])


def fused_synthesis_reference(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                              ft: int, hop: int) -> torch.Tensor:
    """Plain version of kernel B: trig, one GEMM, overlap-add, trim."""
    SYNTHESIS.plain_calls += 1
    spec = torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], dim=-1)
    frames = torch.matmul(spec, w).transpose(0, 1)  # (B, OT, ft)
    wave = framing.overlap_add(frames, hop)
    return wave[:, ft : wave.shape[1] - ft]


def fused_analysis_bwd_reference(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                                 dphs: torch.Tensor, ft: int, hop: int):
    """Plain version of kernel D, written out: (dxp, dw) from the saved
    (xp, w) and the cotangents of (mag, phs).

    The spectrum is computed again; the magnitude term is zero under the
    1e-36 floor (the gradient of clamp_min passes where sq >= 1e-36); the
    phase term is the adjoint of atan2(im, re + 1e-7) with plain division;
    dframe = 0.5 * dspec @ w.T is overlap-added at t*hop; dw = frame.T @ dspec
    over all (t, b) rows."""
    ANALYSIS_BWD.plain_calls += 1
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp, ft, hop, pad=0).transpose(0, 1) * 0.5  # (T, B, ft)
    spec = torch.matmul(frames, w)
    re, im = spec[..., :half], spec[..., half:]
    sq = re * re + im * im
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(torch.clamp_min(sq, 1e-36)),
                     torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], dim=-1)
    dframes = torch.matmul(dspec, w.t()) * 0.5  # (T, B, ft)
    dxp = framing.overlap_add(dframes.transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))  # samples past the last frame
    dw = torch.matmul(frames.reshape(-1, ft).t(), dspec.reshape(-1, 2 * half))
    return dxp, dw


def fused_synthesis_bwd_reference(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                                  dout: torch.Tensor, ft: int, hop: int):
    """Plain version of kernel E, written out: (dmag, dphs, dw) from the saved
    (mag, phs, w) and the cotangent of the trimmed waveform.

    dout is padded by ft zeros on both sides (the adjoint of the trim) and
    framed (the adjoint of the overlap-add); dspec = dframe @ w.T;
    dw = spec.T @ dframe with spec = (mag*cos, mag*sin) computed again;
    dmag = d_re*cos + d_im*sin, dphs = mag*(d_im*cos - d_re*sin). The first
    and last frame lie wholly in the trimmed margin: exact zeros."""
    SYNTHESIS_BWD.plain_calls += 1
    half = mag.shape[-1]
    dframes = framing.frame_signal(dout, ft, hop, pad=ft).transpose(0, 1)  # (OT, B, ft)
    dspec = torch.matmul(dframes, w.t())
    c, s = torch.cos(phs), torch.sin(phs)
    spec = torch.cat([mag * c, mag * s], dim=-1)
    dw = torch.matmul(spec.reshape(-1, 2 * half).t(), dframes.reshape(-1, ft))
    d_re, d_im = dspec[..., :half], dspec[..., half:]
    return d_re * c + d_im * s, mag * (d_im * c - d_re * s), dw


# ------------------------------------------------------------------ wrappers

def _is_cpu(t: torch.Tensor) -> bool:
    """The dispatch rule: True for a CPU tensor (plain version), False for a
    CUDA tensor (kernel); anything else is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got one on {t.device}")
    return False


def _analysis_dims(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    if xp.dim() != 2 or w.dim() != 2:
        raise ValueError("fused_analysis: xp must be (B, Lp) and w (ft, 2*half)")
    b, lp = xp.shape
    half = w.shape[1] // 2
    t = (lp - ft) // hop + 1
    if b < 1 or t < 1 or lp < ft:
        raise ValueError(f"fused_analysis: no frame fits (B={b}, Lp={lp}, ft={ft})")
    if max(b * lp, t * b * packed_width(half)) >= 2 ** 31:
        raise ValueError(f"fused_analysis: too large for 32-bit offsets (B={b}, Lp={lp}, T={t})")
    return b, lp, half, t


def _synthesis_dims(mag: torch.Tensor, ft: int, hop: int):
    if mag.dim() != 3:
        raise ValueError("fused_synthesis: mag and phs must be (OT, B, half)")
    ot, b, half = mag.shape
    out_len = (ot - 1) * hop - ft
    if b < 1 or out_len < 1:
        raise ValueError(f"fused_synthesis: empty output (OT={ot}, B={b}, ft={ft}, hop={hop})")
    rows = max(0, ot - 2) * b
    if max(b * (out_len + 2 * ft), rows * max(ft, packed_width(half))) >= 2 ** 31:
        raise ValueError(f"fused_synthesis: too large for 32-bit offsets (OT={ot}, B={b}, ft={ft})")
    return ot, b, half, out_len


def _analysis_fwd(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    if _is_cpu(xp):
        return fused_analysis_reference(xp, w, ft, hop)
    dev = xp.device
    b, lp, half, t = _analysis_dims(xp, w, ft, hop)
    _cuda.require(xp, "xp", (b, lp), dev)
    _cuda.require(w, "w", (ft, 2 * half), dev)
    mag = torch.empty((t, b, half), device=dev, dtype=torch.float32)
    phs = torch.empty((t, b, half), device=dev, dtype=torch.float32)
    wp = torch.empty((ft, packed_width(half)), device=dev, dtype=torch.float32)
    f = _cuda.function("frontend", "st_analysis_fwd", _ANALYSIS_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(xp), _cuda.ptr(w), _cuda.ptr(wp), _cuda.ptr(mag), _cuda.ptr(phs),
                   b, lp, ft, hop, half, t, copy_width(ft, hop, lp, xp, wp), _cuda.stream(dev))
    _cuda.check(f, status)
    ANALYSIS.launches += 1
    return mag, phs


def _synthesis_fwd(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                   ft: int, hop: int) -> torch.Tensor:
    if _is_cpu(mag):
        return fused_synthesis_reference(mag, phs, w, ft, hop)
    dev = mag.device
    ot, b, half, out_len = _synthesis_dims(mag, ft, hop)
    _cuda.require(mag, "mag", (ot, b, half), dev)
    _cuda.require(phs, "phs", (ot, b, half), dev)
    _cuda.require(w, "w", (2 * half, ft), dev)
    ldc, rows = packed_width(half), max(0, ot - 2) * b  # the live frames 1 .. OT-2
    nsplit = k_slices(rows, ft, ldc)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    wp, spec, frames, out = empty(ft, ldc), empty(rows, ldc), empty(nsplit, rows, ft), empty(b, out_len)
    f = _cuda.function("frontend", "st_synthesis_fwd", _SYNTHESIS_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(mag), _cuda.ptr(phs), _cuda.ptr(w), _cuda.ptr(wp), _cuda.ptr(spec),
                   _cuda.ptr(frames), _cuda.ptr(out), b, ot, ft, hop, half, out_len, nsplit,
                   copy_width(0, 0, 0, wp, spec), _cuda.stream(dev))
    _cuda.check(f, status)
    SYNTHESIS.launches += 1
    return out


def fused_analysis_bwd(xp: torch.Tensor, w: torch.Tensor, dmag: torch.Tensor,
                       dphs: torch.Tensor, ft: int, hop: int,
                       need_dxp: bool = True, need_dw: bool = True):
    """Kernel D on CUDA tensors, its plain version on CPU tensors:
    (dxp (B, Lp), dw (ft, 2*half)); a gradient that is not needed is None."""
    if _is_cpu(xp):
        dxp, dw = fused_analysis_bwd_reference(xp, w, dmag, dphs, ft, hop)
        return (dxp if need_dxp else None), (dw if need_dw else None)
    dev = xp.device
    b, lp, half, t = _analysis_dims(xp, w, ft, hop)
    _cuda.require(xp, "xp", (b, lp), dev)
    _cuda.require(w, "w", (ft, 2 * half), dev)
    _cuda.require(dmag, "dmag", (t, b, half), dev)
    _cuda.require(dphs, "dphs", (t, b, half), dev)
    ldc = packed_width(half)
    nsplit = k_slices(ft, ldc, t * b)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    wp, dspec = empty(ft, ldc), empty(t * b, ldc)
    dxp = empty(b, lp) if need_dxp else None
    dframes = empty(t * b, ft) if need_dxp else None
    dw = empty(ft, 2 * half) if need_dw else None
    partial = empty(nsplit, ft, ldc) if need_dw else None
    f = _cuda.function("frontend_bwd", "st_analysis_bwd", _ANALYSIS_BWD_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(xp), _cuda.ptr(w), _cuda.ptr(dmag), _cuda.ptr(dphs),
                   _cuda.ptr(wp), _cuda.ptr(dspec), _cuda.ptr(partial), _cuda.ptr(dframes),
                   _cuda.ptr(dxp), _cuda.ptr(dw), b, lp, ft, hop, half, t, nsplit, int(need_dxp), int(need_dw),
                   copy_width(ft, hop, lp, xp, wp, dspec), _cuda.stream(dev))
    _cuda.check(f, status)
    ANALYSIS_BWD.launches += 1
    return dxp, dw


def fused_synthesis_bwd(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                        dout: torch.Tensor, ft: int, hop: int, need_dw: bool = True):
    """Kernel E on CUDA tensors, its plain version on CPU tensors:
    (dmag, dphs (OT, B, half), dw (2*half, ft) or None)."""
    if _is_cpu(mag):
        dmag, dphs, dw = fused_synthesis_bwd_reference(mag, phs, w, dout, ft, hop)
        return dmag, dphs, (dw if need_dw else None)
    dev = mag.device
    ot, b, half, out_len = _synthesis_dims(mag, ft, hop)
    _cuda.require(mag, "mag", (ot, b, half), dev)
    _cuda.require(phs, "phs", (ot, b, half), dev)
    _cuda.require(w, "w", (2 * half, ft), dev)
    _cuda.require(dout, "dout", (b, out_len), dev)
    ldc, rows, lp = packed_width(half), max(0, ot - 2) * b, out_len + 2 * ft
    n_dspec, n_dw = k_slices(rows, ldc, ft), k_slices(ft, ldc, rows)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    wp, doutp, dspec = empty(ft, ldc), empty(b, lp), empty(n_dspec, rows, ldc)
    dmag, dphs = empty(ot, b, half), empty(ot, b, half)
    spec = empty(rows, ldc) if need_dw else None
    partial = empty(n_dw, ft, ldc) if need_dw else None
    dw = empty(2 * half, ft) if need_dw else None
    f = _cuda.function("frontend_bwd", "st_synthesis_bwd", _SYNTHESIS_BWD_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(mag), _cuda.ptr(phs), _cuda.ptr(w), _cuda.ptr(dout),
                   _cuda.ptr(wp), _cuda.ptr(doutp), _cuda.ptr(dspec), _cuda.ptr(spec),
                   _cuda.ptr(partial), _cuda.ptr(dmag), _cuda.ptr(dphs), _cuda.ptr(dw),
                   b, ot, ft, hop, half, out_len, n_dspec, n_dw, int(need_dw),
                   copy_width(ft, hop, lp, doutp, wp, dspec), _cuda.stream(dev))
    _cuda.check(f, status)
    SYNTHESIS_BWD.launches += 1
    return dmag, dphs, dw


# ------------------------------------------------------- autograd Functions

class FusedAnalysis(torch.autograd.Function):
    """(xp, w) -> (mag, phs): kernel A forward, kernel D backward (their plain
    versions on CPU tensors). Saves (xp, w) only; D computes the spectrum
    again."""

    @staticmethod
    def forward(ctx, xp, w, ft, hop):
        ctx.save_for_backward(xp, w)
        ctx.geometry = (ft, hop)
        return _analysis_fwd(xp, w, ft, hop)

    @staticmethod
    def backward(ctx, dmag, dphs):
        xp, w = ctx.saved_tensors
        ft, hop = ctx.geometry
        # the cotangents may be expanded or strided views; the kernels take
        # raw pointers
        dxp, dw = fused_analysis_bwd(xp, w, dmag.contiguous(), dphs.contiguous(), ft, hop,
                                     need_dxp=ctx.needs_input_grad[0],
                                     need_dw=ctx.needs_input_grad[1])
        return dxp, dw, None, None


class FusedSynthesis(torch.autograd.Function):
    """(mag, phs, w) -> waveform: kernel B forward, kernel E backward (their
    plain versions on CPU tensors). Saves (mag, phs, w); E computes the
    spectrum again."""

    @staticmethod
    def forward(ctx, mag, phs, w, ft, hop):
        ctx.save_for_backward(mag, phs, w)
        ctx.geometry = (ft, hop)
        return _synthesis_fwd(mag, phs, w, ft, hop)

    @staticmethod
    def backward(ctx, dout):
        mag, phs, w = ctx.saved_tensors
        ft, hop = ctx.geometry
        dmag, dphs, dw = fused_synthesis_bwd(mag, phs, w, dout.contiguous(), ft, hop,
                                             need_dw=ctx.needs_input_grad[2])
        return (dmag if ctx.needs_input_grad[0] else None,
                dphs if ctx.needs_input_grad[1] else None, dw, None, None)


def fused_analysis(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    """Kernel A (backward: kernel D) on CUDA tensors, the plain versions on
    CPU tensors."""
    return FusedAnalysis.apply(xp, w, ft, hop)


def fused_synthesis(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                    ft: int, hop: int) -> torch.Tensor:
    """Kernel B (backward: kernel E) on CUDA tensors, the plain versions on
    CPU tensors."""
    return FusedSynthesis.apply(mag, phs, w, ft, hop)
