"""Dynamic-range compressor and mu-law companding, plain functions on tensors.

Counterparts of signaltrain_tpu/dsp/compressors.py. The static curve (dB
detection, gain computer, make-up) is elementwise PyTorch; the attack/release
envelope goes to kernel C (``ops/cuda_kernels.py``) for CUDA tensors and to
its plain version for CPU tensors. Everything runs on the device of ``x`` and
copies nothing from the host (a knob given as a number is filled in on the
device), so the training step can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels
from ..utils.device import as_device_tensor

# ln 9 in float32 (correctly rounded; what torch.log gives for a float32 9.0)
LN9 = 2.1972246170043945


def _per_example(k, x: torch.Tensor) -> torch.Tensor:
    """A knob value as a float32 tensor on x's device that broadcasts against
    x (..., N): scalars stay 0-d, per-example vectors get a trailing axis. A
    number is filled in on the device (no copy from the host)."""
    k = as_device_tensor(k, torch.float32, x.device)
    if k.dim() == 0:
        return k
    return k.reshape(x.shape[:-1] + (1,))


def _smooth(g: torch.Tensor, alpha_a: torch.Tensor, alpha_r: torch.Tensor) -> torch.Tensor:
    """The switched one-pole smoother over the last axis of a (N,) or (B, N)
    gain curve, with scalar or per-row coefficients."""
    g2 = g[None, :] if g.dim() == 1 else g
    b = g2.shape[0]
    aa = alpha_a.reshape(-1).expand(b).contiguous()
    ar = alpha_r.reshape(-1).expand(b).contiguous()
    out = cuda_kernels.switched_one_pole_batched(g2.contiguous(), aa, ar)
    return out[0] if g.dim() == 1 else out


def gain_curve(x: torch.Tensor, thresh=-24.0, ratio=2.0, attack_time=0.01,
               release_time=0.01, sr: float = 44100.0):
    """The smoother's inputs in compressor_4controls: the gain change gc_dB
    (x's shape) and alpha_a, alpha_r (0-d, or (B, 1) for per-example knobs)."""
    thresh = _per_example(thresh, x)
    ratio = _per_example(ratio, x)
    attack_time = _per_example(attack_time, x)
    release_time = _per_example(release_time, x)
    # one float32 division by the tensor (``-LN9 / t`` would take t's
    # reciprocal, then multiply)
    alpha_a = torch.exp(torch.div(-LN9, sr * attack_time))
    alpha_r = torch.exp(torch.div(-LN9, sr * release_time))

    x_db = 20.0 * torch.log10(torch.abs(x) + 1e-8)
    x_db = torch.clamp_min(x_db, -96.0)
    gain_change_db = torch.where(
        x_db > thresh, thresh + (x_db - thresh) / ratio - x_db, torch.zeros_like(x_db)
    )
    return gain_change_db, alpha_a, alpha_r


def compressor_4controls(x: torch.Tensor, thresh=-24.0, ratio=2.0, attack_time=0.01,
                         release_time=0.01, sr: float = 44100.0) -> torch.Tensor:
    """4-knob feed-forward compressor (Tarr, Hack Audio p.428):

      x_dB  = max(20*log10(|x| + 1e-8), -96)
      gc_dB = thresh + (x_dB - thresh)/ratio - x_dB   where x_dB > thresh else 0
      env   = switched one-pole smoothing of gc_dB with
              alpha_{a,r} = exp(-ln 9 / (sr * t_{attack,release})), env[0] = 0
      y     = x * 10^(env/20)

    x is (N,) or (B, N) float32; each knob is a scalar or a (B,) tensor.
    """
    env = _smooth(*gain_curve(x, thresh, ratio, attack_time, release_time, sr))
    return torch.pow(10.0, env / 20.0) * x


def mu_compand(y: torch.Tensor, mu: float = 32.0) -> torch.Tensor:
    """mu-law companding."""
    return torch.sign(y) * torch.log1p(mu * torch.abs(y)) / math.log1p(mu)


def mu_decompand(y: torch.Tensor, mu: float = 32.0) -> torch.Tensor:
    """Inverse mu-law."""
    return torch.sign(y) / mu * (torch.pow(1.0 + mu, torch.abs(y)) - 1.0)
