"""Window functions and Fourier bases that initialise the trainable STFT.

The analysis/synthesis transforms are trainable parameters that start at
windowed orthonormal-DFT matrices (Hamming window for analysis, the
Griffin-Lim LSEE-MSTFT window for synthesis). Everything here runs once when
a model is built, on the host, in numpy; the values equal those of
signaltrain_tpu/ops/windows.py exactly.
"""

from __future__ import annotations

import numpy as np


def hamming(n: int) -> np.ndarray:
    """Symmetric Hamming window, w[k] = 0.54 - 0.46 cos(2 pi k / (n-1))."""
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def dft_basis(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Orthonormal DFT basis (real, imag), each (n, n): row c is bin c,
    real[c, k] = cos(2 pi c k / n) / sqrt(n), imag[c, k] = -sin(...) / sqrt(n)."""
    c = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    ang = 2.0 * np.pi * c * k / n
    scale = 1.0 / np.sqrt(n)
    return np.cos(ang) * scale, -np.sin(ang) * scale


def gla_synthesis_window(wsz: int, hop: int) -> np.ndarray:
    """Griffin-Lim LSEE-MSTFT synthesis window for a Hamming analysis window:
    w / sum_k shift(w^2, k*hop), the sum over the hop-shifts of the squared
    window that land inside [0, wsz)."""
    w = hamming(wsz)
    w2 = w * w
    env = np.zeros(wsz)
    redundancy = wsz // hop
    idx = np.arange(wsz)
    for k in range(-redundancy, redundancy + 1):
        src = idx - k * hop
        valid = (src >= 0) & (src < wsz)
        env[idx[valid]] += w2[src[valid]]
    return w / env


def analysis_init(ft_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Initial analysis weights: Hamming-windowed ortho-DFT rows, (ft, ft) each."""
    re, im = dft_basis(ft_size)
    w = hamming(ft_size)
    return (re * w).astype(np.float32), (im * w).astype(np.float32)


def synthesis_init(ft_size: int, hop_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Initial synthesis weights: GLA-windowed ortho-DFT rows, (ft, ft) each."""
    re, im = dft_basis(ft_size)
    w = gla_synthesis_window(ft_size, hop_size)
    return (re * w).astype(np.float32), (im * w).astype(np.float32)
