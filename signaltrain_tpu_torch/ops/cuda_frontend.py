"""Fused STFT analysis (kernel A) and iSTFT synthesis (kernel B), forward.

Counterparts of signaltrain_tpu/ops/pallas_frontend.py. Each kernel is
hand-written CUDA C++ for Hopper in ``csrc/frontend.cu`` (its header says
what bounds it on the card and how its design answers that); this module
holds its wrapper, its plain PyTorch version and the weight stacking.

* ``fused_analysis(xp, w, ft, hop)``: padded signal (B, Lp), NOT pre-halved
  (the kernel applies the model's x/2) -> (mag, phs), each (T, B, half),
  frame-major, with T = (Lp - ft)//hop + 1.
* ``fused_synthesis(mag, phs, w, ft, hop)``: frame-major (OT, B, half)
  magnitude/phase -> trimmed waveform (B, (OT-1)*hop - ft).

The wrappers dispatch on the tensors' device: a CPU tensor goes to the plain
version, a CUDA tensor launches the kernel or raises. They are forward-only
(the backward kernels are not ported yet), so they refuse inputs that would
need a gradient.

Weight layouts: analysis (ft, 2*half), column c < half is bin c of the real
part and column half + c bin c of the imaginary part; synthesis (2*half, ft),
rows in the same order, with the conjugate mirror folded in
(``frontend.fold_synthesis_weights``). Unlike the TPU layout there is no
128-lane padding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, framing

ANALYSIS = _cuda.counter("fused_analysis")
SYNTHESIS = _cuda.counter("fused_synthesis")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ANALYSIS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SYNTHESIS_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


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


def _forward_only(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the CUDA front-end kernels are forward-only (their backward "
            "kernels are not ported yet); call under torch.no_grad() or "
            "torch.inference_mode()"
        )


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got one on {t.device}")
    return t.device


def fused_analysis(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int):
    """Kernel A on CUDA tensors, its plain version on CPU tensors."""
    if xp.device.type == "cpu":
        return fused_analysis_reference(xp, w, ft, hop)
    dev = _cuda_device(xp)
    _forward_only(xp, w)
    if xp.dim() != 2 or w.dim() != 2:
        raise ValueError("fused_analysis: xp must be (B, Lp) and w (ft, 2*half)")
    b, lp = xp.shape
    half = w.shape[1] // 2
    t = (lp - ft) // hop + 1
    if b < 1 or t < 1 or lp < ft:
        raise ValueError(f"fused_analysis: no frame fits (B={b}, Lp={lp}, ft={ft})")
    _cuda.require(xp, "xp", (b, lp), dev)
    _cuda.require(w, "w", (ft, 2 * half), dev)
    mag = torch.empty((t, b, half), device=dev, dtype=torch.float32)
    phs = torch.empty((t, b, half), device=dev, dtype=torch.float32)
    f = _cuda.function("frontend", "st_analysis_fwd", _ANALYSIS_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(xp), _cuda.ptr(w), _cuda.ptr(mag), _cuda.ptr(phs),
                   b, lp, ft, hop, half, t, _cuda.stream(dev))
    _cuda.check(f, status)
    ANALYSIS.launches += 1
    return mag, phs


def fused_synthesis(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor,
                    ft: int, hop: int) -> torch.Tensor:
    """Kernel B on CUDA tensors, its plain version on CPU tensors."""
    if mag.device.type == "cpu":
        return fused_synthesis_reference(mag, phs, w, ft, hop)
    dev = _cuda_device(mag)
    _forward_only(mag, phs, w)
    if mag.dim() != 3:
        raise ValueError("fused_synthesis: mag and phs must be (OT, B, half)")
    ot, b, half = mag.shape
    out_len = (ot - 1) * hop - ft
    if b < 1 or out_len < 1:
        raise ValueError(f"fused_synthesis: empty output (OT={ot}, B={b}, ft={ft}, hop={hop})")
    _cuda.require(mag, "mag", (ot, b, half), dev)
    _cuda.require(phs, "phs", (ot, b, half), dev)
    _cuda.require(w, "w", (2 * half, ft), dev)
    out = torch.empty((b, out_len), device=dev, dtype=torch.float32)
    f = _cuda.function("frontend", "st_synthesis_fwd", _SYNTHESIS_ARGS)
    with torch.cuda.device(dev):
        status = f(_cuda.ptr(mag), _cuda.ptr(phs), _cuda.ptr(w), _cuda.ptr(out),
                   b, ot, ft, hop, half, out_len, _cuda.stream(dev))
    _cuda.check(f, status)
    SYNTHESIS.launches += 1
    return out
