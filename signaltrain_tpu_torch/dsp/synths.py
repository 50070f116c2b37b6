"""Synthetic test-signal generators, batched, on the device.

Counterpart of signaltrain_tpu/dsp/synths.py: the reference's synthesizer zoo
(sines, plucks, boxes, sweeps, spikes, triangles, pink noise) and its 12-way
input chooser, so that a whole training batch of inputs is made on the card
with no host dataloader.

Every generator comes in two parts. The deterministic part takes the time
axis ``t`` (N,) and a dict ``d`` of its random draws as tensors with a
leading batch axis, and returns (B, N); it is what the tests compare with
the JAX function, fed that function's own draws. The sampler ``draw_<name>``
draws the dict from an explicit ``torch.Generator`` on the generator's
device. ``torch`` and ``jax.random`` give different numbers from one seed, so
the samplers are held to the distributions, not the streams.

Quirks of the reference that show are kept: ``box`` leaves index i_up - 1 at
the end level; the location arithmetic of ``spikes`` truncates toward zero
twice; where two spikes land on one sample, which one stays is unspecified.
The JAX package's ``t0_fac`` override (a fixed onset, a fraction of the
clip, in place of the drawn one; TimeAlign synthesizes with 0.5) is
``branch(..., t0_fac=)``; its ``freq`` / ``amp`` overrides (used by its
dataset tool) have no counterpart yet.

``pinknoise`` is ``torch.fft.irfft`` of the shaped spectrum. (The JAX package
multiplies by a cosine matrix because its backend has no FFT.)

``music_like_clip`` is a numpy, host-side test asset for long-audio
inference: the same generator and draws as the JAX package's, so the same
seed and duration give the same samples in both.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..utils.device import as_device_tensor

# chooser set used when synthesizing compressor training data
DEFAULT_CHOOSERS = (0, 1, 2, 4, 6, 7)
N_SPIKES = 50
_BETA_TRIES = 24

Draws = dict


def _u(g: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device)


def _sign(g: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=g, device=g.device).float() * 2.0 - 1.0


def _col(v: torch.Tensor) -> torch.Tensor:
    """(B,) per-example draw -> (B, 1), to broadcast against (B, N)."""
    return v[:, None]


# ------------------------------------------------------------------- knobs

def beta_from_uniforms(u: torch.Tensor, v: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Johnk's Beta(a, b) sampler for a, b <= 1, vectorized: ``u``, ``v`` are
    (tries, ...) uniforms; candidate k is accepted when
    u_k^(1/a) + v_k^(1/b) <= 1 and gives x/(x + y). The first accepted
    candidate is taken (acceptance 0.61 a try at a = b = 0.8; where none of
    the tries is accepted, which 24 tries leave to 2e-10 of the draws, the
    first candidate's ratio stands)."""
    x, y = u ** (1.0 / a), v ** (1.0 / b)
    first = torch.argmax((x + y <= 1.0).to(torch.int8), dim=0, keepdim=True)
    ratio = x / (x + y).clamp_min(1e-30)
    return torch.gather(ratio, 0, first)[0]


def random_ends(g: torch.Generator, *shape: int) -> torch.Tensor:
    """Beta(0.8, 0.8): emphasizes the ends of a knob's range."""
    return beta_from_uniforms(_u(g, _BETA_TRIES, *shape), _u(g, _BETA_TRIES, *shape), 0.8, 0.8)


# -------------------------------------------------------------- generators

def normish(y: torch.Tensor, u_amp: torch.Tensor, amp_range=(0.6, 0.9)) -> torch.Tensor:
    """Normalize each row, then rescale it to amp_range[0] + u*(range)."""
    lo, hi = amp_range
    amp = (hi - lo) * u_amp + lo
    return y / y.abs().amax(dim=1, keepdim=True) * _col(amp)


def draw_pinknoise(g: torch.Generator, batch: int, n: int) -> Draws:
    return {"u": _u(g, batch, n // 2 + 1)}


def pinknoise(n: int, d: Draws) -> torch.Tensor:
    """1/f noise: inverse rFFT of a uniform spectrum shaped by 1/sqrt(f),
    peak-normalized. n must be even."""
    n_f = n // 2 + 1
    noise = 2.0 * d["u"] - 1.0
    s = torch.sqrt(torch.arange(n_f, dtype=torch.float32, device=noise.device) + 1.0)
    y = torch.fft.irfft((noise / s).to(torch.complex64), n=n, dim=1)
    return y / y.abs().amax(dim=1, keepdim=True)


def draw_randsine(g: torch.Generator, batch: int, max_tones: int = 2) -> Draws:
    return {"n_tones": torch.randint(1, max_tones + 1, (batch,), generator=g, device=g.device),
            "amp": _u(g, batch, max_tones), "freq": _u(g, batch, max_tones),
            "t0": _u(g, batch, max_tones), "norm": _u(g, batch)}


def randsine(t: torch.Tensor, d: Draws, amp_range=(0.2, 0.9),
             freq_range=(5.0, 150.0), t0_fac=None) -> torch.Tensor:
    """1-2 random cosines."""
    y = torch.zeros((d["norm"].shape[0], t.shape[0]), dtype=t.dtype, device=t.device)
    for i in range(d["amp"].shape[1]):
        amp = amp_range[0] + (amp_range[1] - amp_range[0]) * d["amp"][:, i]
        freq = freq_range[0] + (freq_range[1] - freq_range[0]) * d["freq"][:, i]
        t0 = d["t0"][:, i] * t[-1] if t0_fac is None else (t0_fac * t[-1]).expand(amp.shape)
        tone = _col(amp) * torch.cos(_col(freq) * (t - _col(t0)))
        y = y + torch.where(_col(i < d["n_tones"]), tone, torch.zeros_like(tone))
    return normish(y, d["norm"])


def draw_box(g: torch.Generator, batch: int) -> Draws:
    return {k: _u(g, batch) for k in ("bgn", "mid", "end", "up", "dn")}


def box(t: torch.Tensor, d: Draws, t0_fac=None) -> torch.Tensor:
    """Step-response box; index i_up - 1 keeps the end level, as in the
    reference. ``t0_fac`` puts the rise at int(t0_fac * N)."""
    h_bgn = 0.15 * d["bgn"]
    h_mid = 0.35 * d["mid"] + 0.6
    h_end = 0.2 * d["end"] + 0.1
    maxi = t.shape[0]
    if t0_fac is None:
        i_up = (0.3 * d["up"] * maxi).to(torch.int32)
    else:
        i_up = torch.full_like(d["up"], int(t0_fac * maxi), dtype=torch.int32)
    i_dn = torch.clamp_max(i_up + ((0.3 + 0.35 * d["dn"]) * maxi).to(torch.int32), maxi - 1)
    n = torch.arange(maxi, device=t.device)
    x = _col(h_end).expand(-1, maxi).to(t.dtype)
    x = torch.where(n < _col(i_up) - 1, _col(h_bgn), x)
    return torch.where((n >= _col(i_up)) & (n < _col(i_dn)), _col(h_mid), x)


def draw_expdecay(g: torch.Generator, batch: int) -> Draws:
    return {k: _u(g, batch) for k in ("t0", "high", "low", "decay")}


def expdecay(t: torch.Tensor, d: Draws, t0_fac=None) -> torch.Tensor:
    """Exponential decay envelope; ``t0_fac`` fixes its onset at t0_fac * t[-1]."""
    t0 = _col(0.35 * d["t0"] * t[-1] if t0_fac is None else (t0_fac * t[-1]).expand(d["t0"].shape))
    h_high = _col(0.35 * d["high"] + 0.6)
    h_low = _col(0.1 * d["low"] + 0.1)
    decay = _col(12.0 * d["decay"])
    x = torch.exp(-decay * (t - t0)) * h_high
    return torch.where(t < t0, h_low.expand_as(x), x)


def draw_pluck(g: torch.Generator, batch: int, max_tones: int = 3) -> Draws:
    return {"n_tones": torch.randint(1, max_tones + 1, (batch,), generator=g, device=g.device),
            "amp": _u(g, batch, max_tones), "sign": _sign(g, batch, max_tones),
            "t0": _u(g, batch, max_tones), "freq": _u(g, batch, max_tones),
            "env": draw_expdecay(g, batch), "norm": _u(g, batch)}


def pluck(t: torch.Tensor, d: Draws, freq_range=(50.0, 6400.0), t0_fac=None) -> torch.Tensor:
    """Plucked-string-ish decaying sines; ``t0_fac`` fixes every tone's and
    the envelope's onset at t0_fac * t[-1]."""
    y = torch.zeros((d["norm"].shape[0], t.shape[0]), dtype=t.dtype, device=t.device)
    for i in range(d["amp"].shape[1]):
        amp0 = (0.45 * d["amp"][:, i] + 0.5) * d["sign"][:, i]
        t0 = ((2.0 * d["t0"][:, i] - 1.0) * 0.3 * t[-1] if t0_fac is None
              else (t0_fac * t[-1]).expand(amp0.shape))
        freq = freq_range[0] + (freq_range[1] - freq_range[0]) * d["freq"][:, i]
        tone = _col(amp0) * torch.sin(_col(freq) * (t - _col(t0)))
        y = y + torch.where(_col(i < d["n_tones"]), tone, torch.zeros_like(tone))
    return normish(y * expdecay(t, d["env"], t0_fac), d["norm"])


def draw_ampexpstepup(g: torch.Generator, batch: int) -> Draws:
    return {"freq": _u(g, batch), "norm": _u(g, batch)}


def ampexpstepup(t: torch.Tensor, d: Draws, freq_range=(400.0, 5000.0),
                 start_db: float = -40.0) -> torch.Tensor:
    """Sine under a 1 dB-stepped amplitude staircase (the AES-6849
    compressor test signal)."""
    n = t.shape[0]
    env_db = torch.floor(torch.linspace(start_db, 0.0, n, dtype=t.dtype, device=t.device))
    env = torch.pow(10.0, env_db / 10.0)
    freq = freq_range[0] + (freq_range[1] - freq_range[0]) * d["freq"]
    return normish(env * torch.sin(_col(freq) * t), d["norm"])


def draw_sweep(g: torch.Generator, batch: int) -> Draws:
    return {"amp": _u(g, batch), "norm": _u(g, batch)}


def sweep(t: torch.Tensor, d: Draws, f_low, f_high, amp_too) -> torch.Tensor:
    """Exponential frequency sweep from f_low to f_high (floats or (B,)
    tensors); amp_too ((B,) bool) makes the amplitude rise with it."""
    tmax = t[-1]
    lnfr = torch.log(as_device_tensor(f_high, t.dtype, t.device)
                     / as_device_tensor(f_low, t.dtype, t.device)).reshape(-1, 1)
    amp = _col(0.9 * d["amp"])
    y = amp * torch.sin(20.0 * 2.0 * math.pi * tmax / lnfr * (torch.exp(t / tmax * lnfr) - 1.0))
    y = torch.where(_col(amp_too), y * torch.exp(lnfr * t / tmax), y)
    return normish(y, d["norm"])


def draw_spikes(g: torch.Generator, batch: int, n: int) -> Draws:
    return {"loc": _u(g, batch, N_SPIKES), "height": _u(g, batch, N_SPIKES),
            "amp": _u(g, batch),
            "noise": torch.randn((batch, n), generator=g, device=g.device)}


def spikes(t: torch.Tensor, d: Draws) -> torch.Tensor:
    """Random spikes (with half-height neighbours) plus gaussian noise."""
    n = t.shape[0]
    inner = torch.trunc(d["loc"] * n - 2.0)  # loc = int(int(u*n - 2) + t[-1])
    loc = torch.trunc(inner + t[-1]).to(torch.int64)
    height = (2.0 * d["height"] - 1.0) * 0.7
    x = torch.zeros((loc.shape[0], n), dtype=t.dtype, device=t.device)
    x.scatter_(1, loc % n, height)
    x.scatter_(1, (loc + 1) % n, height / 2.0)
    x.scatter_(1, (loc - 1) % n, height / 2.0)
    return x + _col(0.1 * d["amp"]) * d["noise"]


def draw_triangle(g: torch.Generator, batch: int, n: int) -> Draws:
    return {"height": _u(g, batch), "sign": _sign(g, batch), "width": _u(g, batch),
            "t0": _u(g, batch), "amp": _u(g, batch), "pink": draw_pinknoise(g, batch, n)}


def triangle(t: torch.Tensor, d: Draws, t0_fac=None) -> torch.Tensor:
    """Ramp up then down, plus pink noise."""
    height = _col((0.4 * d["height"] + 0.4) * d["sign"])
    width = _col(d["width"] / 4.0 * t[-1])
    t0 = 2.0 * width + _col(0.4 * d["t0"] * t[-1]) if t0_fac is None else t0_fac * t[-1]
    x = height * (1.0 - torch.abs(t - t0) / width)
    x = torch.where((t < t0 - width) | (t > t0 + width), torch.zeros_like(x), x)
    return x + _col(0.1 * d["amp"] + 0.02) * pinknoise(t.shape[0], d["pink"])


# ---------------------------------------------------------- chooser branches

def draw_branch(chooser: int, g: torch.Generator, batch: int, n: int) -> Draws:
    """The draws of synth branch ``chooser`` for ``batch`` examples of n samples."""
    if chooser == 0:
        return {"sine": draw_randsine(g, batch)}
    if chooser == 1:
        return {"sine": draw_randsine(g, batch), "pink_amp": _u(g, batch),
                "pink": draw_pinknoise(g, batch, n), "white_amp": _u(g, batch),
                "white": _u(g, batch, n)}
    if chooser == 2:
        return {"pluck": draw_pluck(g, batch)}
    if chooser == 3:
        return {"triangle": draw_triangle(g, batch, n)}
    if chooser == 4:
        return {"box": draw_box(g, batch)}
    if chooser == 5:
        return {"spikes": draw_spikes(g, batch, n)}
    if chooser == 6:
        return {"box": draw_box(g, batch), "white": _u(g, batch, n)}
    if chooser == 7:
        return {"pluck": draw_pluck(g, batch), "pink_amp": _u(g, batch),
                "pink": draw_pinknoise(g, batch, n)}
    if chooser == 8:
        return {"step": draw_ampexpstepup(g, batch)}
    if chooser == 9:
        ri = lambda lo, hi: torch.randint(lo, hi, (batch,), generator=g, device=g.device)
        return {"f_low": ri(20, 1000), "f_high": ri(1000, 20000), "amp_too": ri(0, 3) == 2,
                "sweep": draw_sweep(g, batch)}
    if chooser == 10:
        return {"box": draw_box(g, batch), "white_amp": _u(g, batch), "white": _u(g, batch, n),
                "pink_amp": _u(g, batch), "pink": draw_pinknoise(g, batch, n)}
    if chooser == 11:
        return {"pink_amp": _u(g, batch), "pink": draw_pinknoise(g, batch, n)}
    raise ValueError(f"chooser must be in 0..11, got {chooser}")


def branch(chooser: int, t: torch.Tensor, d: Draws, t0_fac=None) -> torch.Tensor:
    """The body of synth branch ``chooser``: (B, N) from its draws. With
    ``t0_fac`` the onsets of the sines, plucks, triangle and boxes are fixed
    (branch 10's box keeps its drawn one, as in the JAX package)."""
    n = t.shape[0]
    white = lambda: 2.0 * d["white"] - 1.0
    if chooser == 0:
        return randsine(t, d["sine"], t0_fac=t0_fac)
    if chooser == 1:
        return (randsine(t, d["sine"], t0_fac=t0_fac)
                + _col(0.2 * d["pink_amp"]) * pinknoise(n, d["pink"])
                + _col(0.2 * d["white_amp"]) * white())
    if chooser == 2:
        return pluck(t, d["pluck"], t0_fac=t0_fac)
    if chooser == 3:
        return triangle(t, d["triangle"], t0_fac)
    if chooser == 4:
        return box(t, d["box"], t0_fac)
    if chooser == 5:
        return spikes(t, d["spikes"])
    if chooser == 6:
        return box(t, d["box"], t0_fac) * white()
    if chooser == 7:
        return (pluck(t, d["pluck"], t0_fac=t0_fac)
                + _col(0.3 * d["pink_amp"] + 0.1) * pinknoise(n, d["pink"]))
    if chooser == 8:
        return ampexpstepup(t, d["step"], start_db=-30.0)
    if chooser == 9:
        return sweep(t, d["sweep"], d["f_low"].to(t.dtype), d["f_high"].to(t.dtype), d["amp_too"])
    if chooser == 10:
        return (box(t, d["box"]) + _col(0.2 * d["white_amp"]) * white()
                + _col(0.2 * d["pink_amp"]) * pinknoise(n, d["pink"]))
    if chooser == 11:
        return _col(0.6 * d["pink_amp"] + 0.2) * pinknoise(n, d["pink"])
    raise ValueError(f"chooser must be in 0..11, got {chooser}")


def _finish(y: torch.Tensor, sign: torch.Tensor, eps_u: torch.Tensor) -> torch.Tensor:
    """Random polarity flip per example + a tiny noise floor."""
    return y * _col(sign) + eps_u * 1e-8


def synth_input_sample(g: torch.Generator, t: torch.Tensor, chooser: int,
                       batch: int = 1, t0_fac=None) -> torch.Tensor:
    """``batch`` examples of synth branch ``chooser``, finished: (batch, N)."""
    n = t.shape[0]
    y = branch(chooser, t, draw_branch(chooser, g, batch, n), t0_fac)
    return _finish(y, _sign(g, batch), _u(g, batch, n))


def stratified_counts(batch: int, n_branches: int) -> list[int]:
    """Examples per branch: even, the first batch % n_branches get one more."""
    return [batch // n_branches + (1 if i < batch % n_branches else 0) for i in range(n_branches)]


def stratified_synth_batch(g: torch.Generator, t: torch.Tensor,
                           choosers: Sequence[int] = DEFAULT_CHOOSERS, batch: int = 1,
                           return_choosers: bool = False):
    """A batch with exactly even chooser coverage: each branch computes only
    its share, and a random permutation restores exchangeability. Per-batch
    chooser counts are deterministic instead of multinomial, the one
    departure from the reference's sampler. With ``return_choosers`` also the
    (batch,) chooser id of every row."""
    parts, ids = [], []
    for c, cnt in zip(choosers, stratified_counts(batch, len(choosers))):
        if cnt == 0:
            continue
        parts.append(synth_input_sample(g, t, c, cnt))
        ids += [c] * cnt
    perm = torch.randperm(batch, generator=g, device=g.device)
    x = torch.cat(parts, dim=0)[perm]
    if return_choosers:
        return x, torch.as_tensor(ids, device=perm.device)[perm]
    return x


def choose_from(g: torch.Generator, choices: Sequence[int], batch: int) -> torch.Tensor:
    """A chooser id drawn uniformly from ``choices`` for each of ``batch``
    rows: (batch,) int64 on the generator's device, made there (a draw and
    a select a choice, no copy from the host)."""
    idx = torch.randint(0, len(choices), (batch,), generator=g, device=g.device)
    ids = torch.full_like(idx, choices[0])
    for k, c in enumerate(choices[1:], 1):
        ids = torch.where(idx == k, c, ids)
    return ids


def music_like_clip(duration_s: float = 180.0, sr: int = 44100, seed: int = 0) -> np.ndarray:
    """A bass line, a plucked pentatonic melody with exponential decays and
    percussive noise bursts on a 110 bpm grid; peak-normalized to 0.5."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros(n, np.float64)

    beat = 60.0 / 110.0
    penta = 220.0 * 2.0 ** (np.array([0, 3, 5, 7, 10, 12]) / 12.0)

    # bass: root notes per bar, slight detune chorus
    bar = 4 * beat
    for b in range(int(duration_s / bar) + 1):
        f = float(penta[rng.integers(0, 3)]) / 2.0
        s, e = int(b * bar * sr), min(int((b + 1) * bar * sr), n)
        if e <= s:
            continue
        tt = t[s:e] - t[s]
        env = np.minimum(tt / 0.02, 1.0) * np.exp(-tt / (bar * 0.9))
        out[s:e] += 0.35 * env * (
            np.sin(2 * np.pi * f * tt) + 0.3 * np.sin(2 * np.pi * 2.003 * f * tt)
        )

    # melody: plucked notes on eighth notes, random rests
    eighth = beat / 2.0
    for k in range(int(duration_s / eighth)):
        if rng.random() < 0.35:
            continue
        f = float(penta[rng.integers(0, len(penta))])
        s = int(k * eighth * sr)
        dur = int(min(4 * eighth, duration_s - k * eighth) * sr)
        if dur <= 0 or s >= n:
            continue
        tt = t[s : s + dur] - t[s]
        pluck = np.exp(-tt / 0.25) * (
            np.sin(2 * np.pi * f * tt)
            + 0.5 * np.sin(2 * np.pi * 2 * f * tt)
            + 0.25 * np.sin(2 * np.pi * 3 * f * tt)
        )
        out[s : s + dur] += 0.25 * pluck

    # percussion: noise bursts on beats (hat-like), heavier every 4th (kick-ish)
    for k in range(int(duration_s / beat)):
        s = int(k * beat * sr)
        dur = min(int(0.05 * sr), n - s)
        if dur <= 0:
            continue
        tt = t[s : s + dur] - t[s]
        burst = rng.standard_normal(dur) * np.exp(-tt / 0.008)
        out[s : s + dur] += (0.22 if k % 4 == 0 else 0.08) * burst
        if k % 4 == 0:  # kick: 60 Hz thump
            out[s : s + dur] += 0.3 * np.exp(-tt / 0.05) * np.sin(2 * np.pi * 60 * tt)

    out = 0.5 * out / np.max(np.abs(out))
    return out.astype(np.float32)
