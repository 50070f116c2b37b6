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
  B (``ops/cuda_frontend.py``), frame-major (T, B, half) in and out of the
  autoencoders. On CPU tensors they run the kernels' plain versions.

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
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.hop_size = ft_size, hop_size
        self.half = ft_size // 2 + 1
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
        spec = torch.matmul(frames, self.stacked_weights())
        return spec[..., : self.half], spec[..., self.half :]

    def mag_phs(self, wave: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fused path (kernel A): RAW, un-halved signal (B, L) -> (mag, phs),
        each (T, B, half) frame-major. The kernel applies the x/2."""
        xp = F.pad(wave, (self.ft_size, self.ft_size))
        return cuda_frontend.fused_analysis(xp, self.stacked_weights(), self.ft_size, self.hop_size)


class Synthesis(nn.Module):
    """Trainable iSTFT synthesis: the transposed-conv output has length
    (OT-1)*hop + ft, and ft samples are trimmed from each end."""

    def __init__(self, ft_size: int = 1024, hop_size: int = 384,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.hop_size = ft_size, hop_size
        self.half = ft_size // 2 + 1
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
        frames = torch.matmul(torch.cat([re, im], dim=-1), self.stacked_weights())
        wave = framing.overlap_add(frames, self.hop_size)
        return wave[:, ft : wave.shape[1] - ft]

    def from_mag_phs(self, mag: torch.Tensor, phs: torch.Tensor) -> torch.Tensor:
        """Fused path (kernel B): frame-major (OT, B, half) magnitude and
        phase -> trimmed waveform (B, out_len)."""
        return cuda_frontend.fused_synthesis(
            mag, phs, self.stacked_weights(), self.ft_size, self.hop_size
        )
