"""Semitone pitch shifting: resample, then a phase-vocoder time stretch.

Counterpart of signaltrain_tpu/dsp/pitch.py, batched: x (B, N) with a
per-row shift n_steps (B,), f = 2^(n_steps/12):

  1. resample r(m) = x(f*m) into a 2N buffer by linear interpolation (covers
     f >= 0.5, -12 semitones);
  2. time-stretch by f: Hann-windowed frames of r, their spectrum as two
     products with cos/sin matrices (torch.matmul; full float32 unless the
     caller allows TF32), magnitude and atan2 phase; output frame j reads the
     fractional analysis frame j/f of its row, and the phase advances by the
     wrapped per-bin increment: a running sum over the output frames, added
     frame by frame in float32 as the JAX scan adds (the phases reach ~2e4
     rad at ft 2048, where an ulp is 2e-3 rad; torch.cumsum on the CPU sums
     in float64 and lands further from the JAX output);
  3. the inverse as two products, overlap-add, divided by the Hann^2
     envelope, trimmed (or zero-padded) to N.

The short-signal rules are the JAX package's: n < 16 is the identity, n <
4*ft shrinks ft to a power of two <= n/4 (at least 32), hop ft/4. The
matrices and the window go to each device once (``_tables``), so a step
captured in a CUDA graph copies nothing from the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops import framing
from ..utils.device import as_device_tensor


@functools.lru_cache(maxsize=8)
def _tables(ft: int, device: str) -> dict:
    """The float32 STFT matrices (half, ft) cos and -sin, their inverses
    (scaled for the one-sided spectrum) and the Hann window, on ``device``."""
    k = np.arange(ft // 2 + 1)[:, None]
    ang = 2.0 * np.pi * k * np.arange(ft)[None, :] / ft
    cos_m, sin_m = np.cos(ang).astype(np.float32), -np.sin(ang).astype(np.float32)
    scale = np.full((ft // 2 + 1,), 2.0 / ft, np.float32)
    scale[0] = scale[-1] = 1.0 / ft
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(ft) / ft)).astype(np.float32)
    tabs = {"cos_t": cos_m.T, "sin_t": sin_m.T, "cinv": cos_m * scale[:, None],
            "sinv": sin_m * scale[:, None], "win": win}
    return {name: torch.from_numpy(np.ascontiguousarray(v)).to(device) for name, v in tabs.items()}


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def pitch_shift(x: torch.Tensor, sr: float, n_steps, ft: int = 2048,
                hop: int = 512) -> torch.Tensor:
    """Shift the pitch of each row of x ((N,) or (B, N) float32) by n_steps
    semitones (a number or a (B,) tensor in [-12, 12]), keeping the length.
    ``sr`` is unused (the factor is relative), kept for the JAX signature."""
    del sr
    x2 = x[None] if x.dim() == 1 else x
    bsz, n = x2.shape
    if n < 16:  # no vocoder frame fits in the smallest analysis frame
        return x
    ft, hop, t_out = geometry(n, ft, hop)
    dev = x.device
    steps = as_device_tensor(n_steps, torch.float32, dev)
    f = torch.pow(2.0, steps / 12.0).reshape(-1, 1).expand(bsz, 1)

    # 1. resample into a 2N buffer
    pos = f * torch.arange(2 * n, dtype=torch.float32, device=dev)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0
    zero = torch.zeros((), dtype=x2.dtype, device=dev)

    def at(i):
        return torch.where(i < n, torch.gather(x2, 1, i.clamp(0, n - 1)), zero)

    r = torch.where(pos <= n - 1, (1.0 - frac) * at(i0) + frac * at(i0 + 1), zero)

    # 2. the phase vocoder
    tab = _tables(ft, str(dev))
    frames = framing.frame_signal(r, ft, hop, pad=0) * tab["win"]  # (B, Tr, ft)
    re = frames @ tab["cos_t"]
    im = frames @ tab["sin_t"]
    mag = torch.sqrt(re * re + im * im)
    ph = torch.atan2(im, re + 1e-12)

    t_r = frames.shape[1]
    half = ft // 2 + 1
    omega = 2.0 * math.pi * torch.arange(half, device=dev) / ft * hop  # per-hop advance

    a_pos = torch.arange(t_out, device=dev) / f  # (B, t_out)
    ia = torch.clamp(torch.floor(a_pos).to(torch.int64), 0, t_r - 2)
    fa = torch.clamp(a_pos - ia, 0.0, 1.0)[..., None]

    def rows_frames(v, i):  # v[b, i[b, j]] for each row b and output frame j
        return torch.gather(v, 1, i[..., None].expand(-1, -1, half))

    mag_a, mag_b = rows_frames(mag, ia), rows_frames(mag, ia + 1)
    ph_a, ph_b = rows_frames(ph, ia), rows_frames(ph, ia + 1)
    mag_j = (1.0 - fa) * mag_a + fa * mag_b
    dphi = _wrap_pi(ph_b - ph_a - omega) + omega
    phi = ph[:, 0] - dphi[:, 0]
    acc = []
    for j in range(t_out):
        phi = phi + dphi[:, j]
        acc.append(phi)
    phases = torch.stack(acc, 1)

    out_re = mag_j * torch.cos(phases)
    out_im = mag_j * torch.sin(phases)

    # 3. the inverse
    frames_td = (out_re @ tab["cinv"] + out_im @ tab["sinv"]) * tab["win"]
    y = framing.overlap_add(frames_td, hop) / envelope(n, ft, hop, dev)[: (t_out - 1) * hop + ft]
    y = y[:, :n] if y.shape[-1] >= n else torch.nn.functional.pad(y, (0, n - y.shape[-1]))
    return y[0] if x.dim() == 1 else y


def geometry(n: int, ft: int = 2048, hop: int = 512) -> tuple[int, int, int]:
    """(ft, hop, output frames) of pitch_shift on a signal of n >= 16
    samples: ft shrinks to a power of two <= n/4 (at least 32), hop ft/4,
    for n < 4*ft."""
    if n < 4 * ft:
        ft = max(32, 1 << int(np.floor(np.log2(max(32, n // 4)))))
        hop = ft // 4
    return ft, hop, 1 + (n - ft) // hop


def envelope(n: int, ft: int = 2048, hop: int = 512, device="cpu") -> torch.Tensor:
    """What pitch_shift divides its overlap-add by, over (t_out-1)*hop + ft
    samples: the Hann^2 windows of its output frames added up, at least 1e-6
    (near 0 at the edges, where the output is large)."""
    ft, hop, t_out = geometry(n, ft, hop)
    win = _tables(ft, str(device))["win"]
    return torch.clamp_min(framing.overlap_add((win * win).expand(1, t_out, ft), hop)[0], 1e-6)
