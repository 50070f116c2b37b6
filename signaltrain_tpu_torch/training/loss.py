"""Loss functions.

Counterpart of signaltrain_tpu/training/loss.py: calc_loss = logcosh(y_hat, y)
+ an L1 penalty on the predicted magnitude spectrogram, optionally weighted
along the frequency axis by exp(7/n_bins * bin), with lambda/10 in the
weighted case. Everything is float32.
"""

from __future__ import annotations

import functools
import math

import torch


def logcosh(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean(log(cosh(y - y_hat))), stable for large residuals:
    log cosh z = |z| + log1p(exp(-2|z|)) - log 2."""
    z = torch.abs(y.float() - y_hat.float())
    return torch.mean(z + torch.log1p(torch.exp(-2.0 * z)) - math.log(2.0))


def mse(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - x_hat) ** 2)


def mae(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - x_hat))


@functools.lru_cache(maxsize=8)
def freq_scale(n_bins: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """exp(7/n_bins * arange(n_bins)): the spectral L1 weighting."""
    expfac = 7.0 / n_bins
    return torch.exp(expfac * torch.arange(n_bins, dtype=torch.float32, device=device))


def calc_loss(y_hat: torch.Tensor, y: torch.Tensor, mag_hat: torch.Tensor,
              scale_by_freq: torch.Tensor | None = None,
              l1_lambda: float = 2e-5) -> torch.Tensor:
    """Reconstruction + spectral-L1 regularization. ``mag_hat`` may be
    batch-major (B, OT, F) or frame-major (OT, B, F): the weighting
    broadcasts over the last axis either way."""
    rec = logcosh(y_hat, y)
    mag_hat = mag_hat.float()
    if scale_by_freq is None:
        return rec + l1_lambda * torch.mean(torch.abs(mag_hat))
    return rec + (l1_lambda / 10.0) * torch.mean(torch.abs(mag_hat * scale_by_freq))
