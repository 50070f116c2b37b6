"""Cosine-modulated (MDCT-like) trainable front-end.

Counterpart of signaltrain_tpu/ops/dct_frontend.py (the reference's DCT-basis
front-end, cls_fe_dct_bases.py, which its main model path does not use):
framing and one product, like ``ops/frontend.py``, with the cosine-modulated
polyphase basis

    cos_an[k, n] = w[n] * cos(pi/K * (k+0.5) * (n+0.5+K/2)) * sqrt(2/K)

(w the symmetric cosine window; cls_fe_dct_bases.py:57-97). Synthesis has
trainable weights of its own, or is tied to the analysis weights
(``tied_transform``, cls_fe_dct_bases.py:36-54).

The products go through ``frontend.gemm``, so ``compute_dtype=torch.bfloat16``
follows the JAX package's bf16 ``_gemm`` policy. JAX computes them outside
any Pallas kernel, so they are library products here too: no kernel of the
port sits on this path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from . import framing
from .frontend import gemm


def cosine_window(n: int) -> np.ndarray:
    """scipy.signal.windows.cosine: sin(pi*(k+0.5)/n)."""
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def core_modulation(freq_subbands: int, window_size: int) -> np.ndarray:
    """Cosine-modulated polyphase matrix (freq_subbands, window_size), float32."""
    w = cosine_window(window_size)
    kvec = (np.arange(freq_subbands) + 0.5)[:, None]
    nvec = (np.arange(window_size) + 0.5 + freq_subbands / 2)[None, :]
    cos_an = w * np.cos(np.pi / freq_subbands * kvec * nvec) * np.sqrt(2.0 / freq_subbands)
    return cos_an.astype(np.float32)


def _weight(ft_size: int, w_size: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(core_modulation(ft_size, w_size)).to(device))


class DCTAnalysis(nn.Module):
    """(B, L) -> (B, T, ft_size) subband frames, as Conv1d(1, ft, w_size,
    padding=ft_size, stride=hop) (cls_fe_dct_bases.py:116-135: the padding
    is ft_size, not w_size)."""

    def __init__(self, ft_size: int = 1024, w_size: int = 2048, hop_size: int = 1024,
                 use_bias: bool = True, device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.w_size, self.hop_size = ft_size, w_size, hop_size
        self.compute_dtype = compute_dtype
        self.weight = _weight(ft_size, w_size, dev)
        self.bias = nn.Parameter(torch.zeros(ft_size, device=dev)) if use_bias else None

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        frames = framing.frame_signal(wave, self.w_size, self.hop_size, pad=self.ft_size)
        out = gemm(frames, self.weight.t(), self.compute_dtype)
        return out + self.bias if self.bias is not None else out


def _synthesize(x_ft: torch.Tensor, weight: torch.Tensor, hop_size: int, ft_size: int,
                compute_dtype: torch.dtype) -> torch.Tensor:
    frames = gemm(x_ft, weight, compute_dtype)  # (B, T, w_size)
    wave = framing.overlap_add(frames, hop_size)
    return wave[:, ft_size : wave.shape[1] - ft_size]


class DCTSynthesis(nn.Module):
    """(B, T, ft_size) -> (B, L) as a transposed convolution, with ft_size
    samples trimmed from both ends (cls_fe_dct_bases.py:138-180)."""

    def __init__(self, ft_size: int = 1024, w_size: int = 2048, hop_size: int = 1024,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ft_size, self.w_size, self.hop_size = ft_size, w_size, hop_size
        self.compute_dtype = compute_dtype
        self.weight = _weight(ft_size, w_size, dev)

    def forward(self, x_ft: torch.Tensor) -> torch.Tensor:
        return _synthesize(x_ft, self.weight, self.hop_size, self.ft_size, self.compute_dtype)


def tied_transform(analysis_weight: torch.Tensor, x_ft: torch.Tensor, hop_size: int,
                   ft_size: int, compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct with the ANALYSIS weights (the orthogonal tied transform,
    cls_fe_dct_bases.py:36-54)."""
    return _synthesize(x_ft, analysis_weight, hop_size, ft_size, compute_dtype)
