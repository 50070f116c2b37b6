"""Dynamic-range compressors, the echo and mu-law companding, plain
functions on tensors.

Counterparts of signaltrain_tpu/dsp/compressors.py. The static curves (dB
detection, gain computer, make-up) are elementwise PyTorch; the envelopes go
to the card's kernels for CUDA tensors and to their plain versions for CPU
tensors: the 4-knob compressor's switched smoother to kernel C, the 3-knob
compressor's Butterworth envelope to kernel L (``dsp/iir.lfilter``).
Everything runs on the device of ``x`` and copies nothing from the host (a
knob given as a number is filled in on the device), so the training step can
be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels
from . import iir
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


def compressor(x: torch.Tensor, thresh=-24.0, ratio=2.0, attackrel=0.045,
               sr: float = 44100.0) -> torch.Tensor:
    """3-knob compressor with a first-order Butterworth dB envelope: the
    envelope filter's cutoff is 1/attack_samples (over Nyquist), and lfilter
    starts from its steady state at the first sample, zi * dB[0].

    x is (N,) or (B, N) float32; each knob is a scalar or a (B,) tensor."""
    thresh = _per_example(thresh, x)
    ratio = _per_example(ratio, x)
    fc = 1.0 / (as_device_tensor(attackrel, torch.float32, x.device) * sr)
    b, a = iir.butter_lowpass(1, fc)

    db = 20.0 * torch.log10(torch.abs(x) + 1e-6)
    # the order-1 steady state (scipy's lfilter_zi in closed form)
    zi = (b[..., 1] - a[..., 1] * b[..., 0]) / (1.0 + a[..., 1])
    in_env = iir.lfilter(b, a, db, zi=(zi * db[..., 0])[..., None])
    out_env = torch.where(in_env > thresh, thresh + (in_env - thresh) / ratio, in_env)
    gain = torch.pow(10.0, (out_env - in_env) / 20.0)
    return x * gain


def echo(x: torch.Tensor, delay_samples=1487.0, ratio=0.6, echoes=1.0,
         max_echoes: int = 4) -> torch.Tensor:
    """Delay/echo with fractional-delay blending: echo i (1-based) is x
    delayed by i * delay_samples (linear between the two nearest whole
    delays) times ratio**i, for i <= round(echoes) <= max_echoes.

    x is (N,) or (B, N) float32; each knob a scalar or a (B,) tensor (each
    row's delays are a gather)."""
    x2 = x[None] if x.dim() == 1 else x
    n = x2.shape[-1]
    delay = _per_example(delay_samples, x2)
    ratio = _per_example(ratio, x2)
    n_echo = torch.round(_per_example(echoes, x2))
    idx = torch.arange(n, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def shift(d):
        src = idx - d
        return torch.where(src >= 0, torch.gather(x2, 1, src.clamp(0, n - 1).expand_as(x2)), zero)

    y = x2
    for i in range(max_echoes):
        ip1 = i + 1
        delay_len = ip1 * delay
        d_int = torch.floor(delay_len).to(torch.int64)
        diff = delay_len - d_int
        x_delayed = (1.0 - diff) * shift(d_int) + diff * shift(d_int + 1)
        gain = torch.where(ip1 <= n_echo, torch.pow(ratio, 1.0 * ip1), zero)
        y = y + gain * x_delayed
    return y[0] if x.dim() == 1 else y


def mu_compand(y: torch.Tensor, mu: float = 32.0) -> torch.Tensor:
    """mu-law companding."""
    return torch.sign(y) * torch.log1p(mu * torch.abs(y)) / math.log1p(mu)


def mu_decompand(y: torch.Tensor, mu: float = 32.0) -> torch.Tensor:
    """Inverse mu-law."""
    return torch.sign(y) / mu * (torch.pow(1.0 + mu, torch.abs(y)) - 1.0)
