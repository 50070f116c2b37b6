"""Trainable STFT analysis / iSTFT synthesis front-end (``nn.Module``s).

The parameters are the reference's: full (ft, ft) real and imaginary
matrices per direction, rows are bins, stored in the reference's conv-weight
layout (ft, 1, ft) under its names (``conv_analysis_real.weight`` ...), so
reference checkpoints load with ``strict=True``. They are plain parameters,
not convolutions: the port computes with the matrices directly.

Two paths over the same parameters:

* ``Analysis.forward`` / ``Synthesis.forward``: the GEMM formulation (frame,
  one matmul against the stacked used rows; one matmul against the
  mirror-folded synthesis rows, overlap-add, trim), batch-major.
* ``Analysis.mag_phs`` / ``Synthesis.from_mag_phs``: the fused kernels A and
  B, with kernels D and E as their backward (``ops/cuda_frontend.py``),
  frame-major (T, B, half) in and out of the autoencoders. On CPU tensors
  they run the kernels' plain versions.

Both paths train: the GEMM path by plain autograd (float32) or through
``Bf16Gemm`` (bfloat16), the fused path through the backward kernels. Both
modules take ``compute_dtype``, as the JAX package's do: the products run in
it, the parameters stay float32.

Synthesis folds the conjugate-symmetric mirror into the weights: full
spectrum channel j in [half, ft) carries bin ft - j with re_full[j] = re[c],
im_full[j] = -im[c], so trainable row ft - c adds onto row c (reversed, and
negated for the imaginary part).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from . import cuda_frontend, framing, windows


class Bf16Gemm(torch.autograd.Function):
    """a @ b under the JAX package's bf16 ``_gemm`` policy
    (signaltrain_tpu/ops/frontend.py:42-99): forward, both operands rounded to
    bf16 and one product with a float32 result; backward, the bf16 operands
    are the residuals, the cotangent is rounded to bf16, and both gradient
    products have float32 results. a: (..., K), b: (K, N). This product sits
    outside any Pallas kernel in JAX, so a library product is the port's
    counterpart."""

    @staticmethod
    def forward(ctx, a, b):
        ac, bc = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(ac, bc)
        out = _mm(ac.reshape(-1, ac.shape[-1]), bc)
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        gc = g.to(torch.bfloat16).reshape(-1, g.shape[-1])
        da = _mm(gc, bc.t()).reshape(ac.shape)
        db = _mm(ac.reshape(-1, ac.shape[-1]).t(), gc)
        return da, db


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product of two bf16 matrices with a float32 result: the exact
    products summed in float32, as JAX's ``preferred_element_type=float32``
    (torch's bf16 matmul would round its result to bf16). On the card one
    bf16 product with a float32 output (``aten::mm.dtype``); on the CPU,
    which has no kernel for that, the bf16 values upcast and multiplied in
    float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def gemm(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """The front-end product a @ b in the compute dtype: plain ``matmul``
    (autograd's float32 gradients) for float32, ``Bf16Gemm`` for bfloat16."""
    if compute_dtype not in cuda_frontend.COMPUTE_DTYPES:
        raise TypeError(f"compute_dtype must be one of {cuda_frontend.COMPUTE_DTYPES}, "
                        f"got {compute_dtype}")
    if compute_dtype == torch.bfloat16:
        return Bf16Gemm.apply(a, b)
    return torch.matmul(a, b)


class ConvWeight(nn.Module):
    """One trainable (ft, ft) matrix kept as ``weight`` of shape (ft, 1, ft),
    the layout and name of the reference's Conv1d weight."""

    def __init__(self, matrix, device: torch.device):
        super().__init__()
        w = torch.as_tensor(matrix, dtype=torch.float32)[:, None, :]
        self.weight = nn.Parameter(w.to(device))

    @property
    def matrix(self) -> torch.Tensor:
        return self.weight[:, 0, :]


def fold_synthesis_weights(w_real: torch.Tensor, w_imag: torch.Tensor, half: int):
    """(ft, ft) synthesis matrices -> (half, ft) each with the mirror folded in."""
    wr = torch.cat([w_real[:1], w_real[1 : half - 1] + torch.flip(w_real[half:], dims=[0]),
                    w_real[half - 1 : half]])
    wi = torch.cat([w_imag[:1], w_imag[1 : half - 1] + (-torch.flip(w_imag[half:], dims=[0])),
                    w_imag[half - 1 : half]])
    return wr, wi


class Analysis(nn.Module):
    """Trainable STFT analysis. Frame t covers padded-input samples
    [t*hop, t*hop+ft) with ft zeros of padding on both sides, as
    Conv1d(1, ft, ft, stride=hop, padding=ft)."""

    def __init__(self, ft_size: int = 1024, hop_size: int = 384,
                 device: str | torch.device = "cuda", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.hop_size = ft_size, hop_size
        self.half = ft_size // 2 + 1
        self.compute_dtype = compute_dtype
        re0, im0 = windows.analysis_init(ft_size)
        self.conv_analysis_real = ConvWeight(re0, dev)
        self.conv_analysis_imag = ConvWeight(im0, dev)

    def stacked_weights(self) -> torch.Tensor:
        return cuda_frontend.stack_analysis_weights(
            self.conv_analysis_real.matrix, self.conv_analysis_imag.matrix, self.half
        )

    def forward(self, wave: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """GEMM path: (B, L) -> (re, im), each (B, T, half)."""
        frames = framing.frame_signal(wave, self.ft_size, self.hop_size, pad=self.ft_size)
        spec = gemm(frames, self.stacked_weights(), self.compute_dtype)
        return spec[..., : self.half], spec[..., self.half :]

    def mag_phs(self, wave: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fused path (kernel A): RAW, un-halved signal (B, L) -> (mag, phs),
        each (T, B, half) frame-major. The kernel applies the x/2."""
        xp = F.pad(wave, (self.ft_size, self.ft_size))
        return cuda_frontend.fused_analysis(xp, self.stacked_weights(), self.ft_size, self.hop_size,
                                            self.compute_dtype)


class Synthesis(nn.Module):
    """Trainable iSTFT synthesis: the transposed-conv output has length
    (OT-1)*hop + ft, and ft samples are trimmed from each end."""

    def __init__(self, ft_size: int = 1024, hop_size: int = 384,
                 device: str | torch.device = "cuda", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.hop_size = ft_size, hop_size
        self.half = ft_size // 2 + 1
        self.compute_dtype = compute_dtype
        re0, im0 = windows.synthesis_init(ft_size, hop_size)
        self.conv_synthesis_real = ConvWeight(re0, dev)
        self.conv_synthesis_imag = ConvWeight(im0, dev)

    def stacked_weights(self) -> torch.Tensor:
        wr, wi = fold_synthesis_weights(
            self.conv_synthesis_real.matrix, self.conv_synthesis_imag.matrix, self.half
        )
        return cuda_frontend.stack_synthesis_weights(wr, wi)

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """GEMM path: (re, im), each (B, OT, half) -> (B, out_len)."""
        ft = self.ft_size
        frames = gemm(torch.cat([re, im], dim=-1), self.stacked_weights(), self.compute_dtype)
        wave = framing.overlap_add(frames, self.hop_size)
        return wave[:, ft : wave.shape[1] - ft]

    def from_mag_phs(self, mag: torch.Tensor, phs: torch.Tensor) -> torch.Tensor:
        """Fused path (kernel B): frame-major (OT, B, half) magnitude and
        phase -> trimmed waveform (B, out_len)."""
        return cuda_frontend.fused_synthesis(
            mag, phs, self.stacked_weights(), self.ft_size, self.hop_size, self.compute_dtype
        )


def glorot_uniform(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """U(-l, l), l = sqrt(6 / (fan_in + fan_out)), drawn on the CPU from
    ``generator``: the distribution of flax's ``glorot_uniform``."""
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=generator, dtype=torch.float64) * 2 - 1).mul_(limit).float()


class FNNAnalysis(nn.Module):
    """Frame-wise linear analysis (cls_fe_dft.py:166-205, a variant the
    reference's main path does not use): a dense DFT of each frame, with no
    window or striding. (B, T, ft) -> (re, im), each (B, T, half). The
    trainable matrices ``w_real`` / ``w_imag`` (ft, ft) start at the
    orthonormal DFT basis; the product is ``gemm`` in ``compute_dtype``."""

    def __init__(self, ft_size: int = 1024, device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.half = ft_size, ft_size // 2 + 1
        self.compute_dtype = compute_dtype
        re0, im0 = windows.dft_basis(ft_size)
        self.w_real = nn.Parameter(torch.as_tensor(re0, dtype=torch.float32).to(dev))
        self.w_imag = nn.Parameter(torch.as_tensor(im0, dtype=torch.float32).to(dev))

    def forward(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        w = torch.cat([self.w_real[: self.half], self.w_imag[: self.half]]).t()
        spec = gemm(frames, w, self.compute_dtype)
        return spec[..., : self.half], spec[..., self.half :]


class FNNSynthesis(nn.Module):
    """Frame-wise linear synthesis (cls_fe_dft.py:208-262): full-spectrum
    frames rebuilt with the conjugate mirror folded into the weights.
    (re, im), each (B, T, half) -> (B, T, ft). ``w_real`` / ``w_imag`` start
    at the DFT basis, or with ``random_init`` glorot-uniform from
    ``generator`` (seed 0 when none is given)."""

    def __init__(self, ft_size: int = 1024, random_init: bool = False,
                 device: str | torch.device = "cuda", compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.half = ft_size, ft_size // 2 + 1
        self.compute_dtype = compute_dtype
        if random_init:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            re0 = glorot_uniform((ft_size, ft_size), gen)
            im0 = glorot_uniform((ft_size, ft_size), gen)
        else:
            re0, im0 = (torch.as_tensor(m, dtype=torch.float32) for m in windows.dft_basis(ft_size))
        self.w_real = nn.Parameter(re0.to(dev))
        self.w_imag = nn.Parameter(im0.to(dev))

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        wr, wi = fold_synthesis_weights(self.w_real, self.w_imag, self.half)
        return gemm(torch.cat([re, im], dim=-1), torch.cat([wr, wi]), self.compute_dtype)
