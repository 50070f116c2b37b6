"""The synthesized training batch, in plain PyTorch and numpy.

A frozen copy of the program's data path for the comp_4c effect:
``data/synth_data.py`` ``make_synth_batch_fn`` and ``step_generator``,
``dsp/synths.py`` (``stratified_synth_batch`` with the default choosers 0,
1, 2, 4, 6, 7, ``random_ends``), ``dsp/effects.py`` ``Compressor_4c`` and
``dsp/compressors.py`` ``compressor_4controls``. It draws from a
``torch.Generator`` seeded as the program seeds it for (seed, step), in the
program's order, so that the same seed gives the same draws; the switched
one-pole envelope is a numpy loop over time that rounds each step to float32
as one fused multiply-add would (the recursion switches on a comparison, so
it is followed in the precision the data path states, float32).
"""

from __future__ import annotations

import numpy as np
import torch

CHOOSERS = (0, 1, 2, 4, 6, 7)
BETA_TRIES = 24
LN9 = 2.1972246170043945


def step_generator(gen: torch.Generator, seed: int, step: int) -> torch.Generator:
    """The stream of (seed, step) for a single-process run's whole batch."""
    gen.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) + int(step))
    return gen


def _u(g, *shape):
    return torch.rand(shape, generator=g, device=g.device)


def _sign(g, *shape):
    return torch.randint(0, 2, shape, generator=g, device=g.device).float() * 2.0 - 1.0


def _col(v):
    return v[:, None]


def random_ends(g, *shape):
    u, v = _u(g, BETA_TRIES, *shape), _u(g, BETA_TRIES, *shape)
    x, y = u ** (1.0 / 0.8), v ** (1.0 / 0.8)
    first = torch.argmax((x + y <= 1.0).to(torch.int8), dim=0, keepdim=True)
    ratio = x / (x + y).clamp_min(1e-30)
    return torch.gather(ratio, 0, first)[0]


def normish(y, u_amp, lo=0.6, hi=0.9):
    amp = (hi - lo) * u_amp + lo
    return y / y.abs().amax(dim=1, keepdim=True) * _col(amp)


def pinknoise(n, u):
    n_f = n // 2 + 1
    noise = 2.0 * u - 1.0
    s = torch.sqrt(torch.arange(n_f, dtype=torch.float32, device=noise.device) + 1.0)
    y = torch.fft.irfft((noise / s).to(torch.complex64), n=n, dim=1)
    return y / y.abs().amax(dim=1, keepdim=True)


def draw_randsine(g, b):
    return {"n_tones": torch.randint(1, 3, (b,), generator=g, device=g.device),
            "amp": _u(g, b, 2), "freq": _u(g, b, 2), "t0": _u(g, b, 2), "norm": _u(g, b)}


def randsine(t, d):
    y = torch.zeros((d["norm"].shape[0], t.shape[0]), dtype=t.dtype, device=t.device)
    for i in range(d["amp"].shape[1]):
        amp = 0.2 + (0.9 - 0.2) * d["amp"][:, i]
        freq = 5.0 + (150.0 - 5.0) * d["freq"][:, i]
        t0 = d["t0"][:, i] * t[-1]
        tone = _col(amp) * torch.cos(_col(freq) * (t - _col(t0)))
        y = y + torch.where(_col(i < d["n_tones"]), tone, torch.zeros_like(tone))
    return normish(y, d["norm"])


def draw_box(g, b):
    return {k: _u(g, b) for k in ("bgn", "mid", "end", "up", "dn")}


def box(t, d):
    h_bgn, h_mid, h_end = 0.15 * d["bgn"], 0.35 * d["mid"] + 0.6, 0.2 * d["end"] + 0.1
    maxi = t.shape[0]
    i_up = (0.3 * d["up"] * maxi).to(torch.int32)
    i_dn = torch.clamp_max(i_up + ((0.3 + 0.35 * d["dn"]) * maxi).to(torch.int32), maxi - 1)
    n = torch.arange(maxi, device=t.device)
    x = _col(h_end).expand(-1, maxi).to(t.dtype)
    x = torch.where(n < _col(i_up) - 1, _col(h_bgn), x)
    return torch.where((n >= _col(i_up)) & (n < _col(i_dn)), _col(h_mid), x)


def expdecay(t, d):
    t0 = _col(0.35 * d["t0"] * t[-1])
    h_high, h_low, decay = _col(0.35 * d["high"] + 0.6), _col(0.1 * d["low"] + 0.1), \
        _col(12.0 * d["decay"])
    x = torch.exp(-decay * (t - t0)) * h_high
    return torch.where(t < t0, h_low.expand_as(x), x)


def draw_pluck(g, b):
    return {"n_tones": torch.randint(1, 4, (b,), generator=g, device=g.device),
            "amp": _u(g, b, 3), "sign": _sign(g, b, 3), "t0": _u(g, b, 3), "freq": _u(g, b, 3),
            "env": {k: _u(g, b) for k in ("t0", "high", "low", "decay")}, "norm": _u(g, b)}


def pluck(t, d):
    y = torch.zeros((d["norm"].shape[0], t.shape[0]), dtype=t.dtype, device=t.device)
    for i in range(d["amp"].shape[1]):
        amp0 = (0.45 * d["amp"][:, i] + 0.5) * d["sign"][:, i]
        t0 = (2.0 * d["t0"][:, i] - 1.0) * 0.3 * t[-1]
        freq = 50.0 + (6400.0 - 50.0) * d["freq"][:, i]
        tone = _col(amp0) * torch.sin(_col(freq) * (t - _col(t0)))
        y = y + torch.where(_col(i < d["n_tones"]), tone, torch.zeros_like(tone))
    return normish(y * expdecay(t, d["env"]), d["norm"])


def draw_branch(c, g, b, n):
    if c == 0:
        return {"sine": draw_randsine(g, b)}
    if c == 1:
        return {"sine": draw_randsine(g, b), "pink_amp": _u(g, b), "pink": _u(g, b, n // 2 + 1),
                "white_amp": _u(g, b), "white": _u(g, b, n)}
    if c == 2:
        return {"pluck": draw_pluck(g, b)}
    if c == 4:
        return {"box": draw_box(g, b)}
    if c == 6:
        return {"box": draw_box(g, b), "white": _u(g, b, n)}
    if c == 7:
        return {"pluck": draw_pluck(g, b), "pink_amp": _u(g, b), "pink": _u(g, b, n // 2 + 1)}
    raise ValueError(f"chooser {c} is not among {CHOOSERS}")


def branch(c, t, d):
    n = t.shape[0]
    white = lambda: 2.0 * d["white"] - 1.0
    if c == 0:
        return randsine(t, d["sine"])
    if c == 1:
        return (randsine(t, d["sine"]) + _col(0.2 * d["pink_amp"]) * pinknoise(n, d["pink"])
                + _col(0.2 * d["white_amp"]) * white())
    if c == 2:
        return pluck(t, d["pluck"])
    if c == 4:
        return box(t, d["box"])
    if c == 6:
        return box(t, d["box"]) * white()
    if c == 7:
        return pluck(t, d["pluck"]) + _col(0.3 * d["pink_amp"] + 0.1) * pinknoise(n, d["pink"])
    raise ValueError(f"chooser {c} is not among {CHOOSERS}")


def stratified_batch(g, t, batch):
    parts = []
    k = len(CHOOSERS)
    for i, c in enumerate(CHOOSERS):
        cnt = batch // k + (1 if i < batch % k else 0)
        if cnt == 0:
            continue
        y = branch(c, t, draw_branch(c, g, cnt, t.shape[0]))
        parts.append(y * _col(_sign(g, cnt)) + _u(g, cnt, t.shape[0]) * 1e-8)
    perm = torch.randperm(batch, generator=g, device=g.device)
    return torch.cat(parts, dim=0)[perm]


def switched_one_pole(g: np.ndarray, aa: np.ndarray, ar: np.ndarray) -> np.ndarray:
    """(B, N) float32 gain change -> its envelope: s[0] = 0, then
    s[n] = a * s[n-1] + (1 - a) * g[n], a = aa where g[n] < s[n-1] else ar,
    each step rounded to float32 once."""
    b, n = g.shape
    one = np.float32(1.0)
    ca = ((one - aa)[:, None] * g).astype(np.float64)
    cr = ((one - ar)[:, None] * g).astype(np.float64)
    a64, r64 = aa.astype(np.float64), ar.astype(np.float64)
    out = np.zeros((b, n), np.float32)
    s = np.zeros(b, np.float64)
    for i in range(1, n):
        s = np.where(g[:, i] < s, a64 * s + ca[:, i], r64 * s + cr[:, i])
        s = s.astype(np.float32)
        out[:, i] = s
        s = s.astype(np.float64)
    return out


def compressor_4c(x: torch.Tensor, wc: torch.Tensor, sr: float, bypass: bool = False):
    """The 4-knob compressor over rows of x with world knobs wc (B, 4).
    ``bypass`` returns x itself: the target altered where it is produced,
    the fault the calibration reads."""
    if bypass:
        return x
    thresh, ratio, att, rel = (wc[:, i].reshape(-1, 1) for i in range(4))
    alpha_a = torch.exp(torch.div(-LN9, sr * att))
    alpha_r = torch.exp(torch.div(-LN9, sr * rel))
    x_db = torch.clamp_min(20.0 * torch.log10(torch.abs(x) + 1e-8), -96.0)
    gc = torch.where(x_db > thresh, thresh + (x_db - thresh) / ratio - x_db, torch.zeros_like(x_db))
    env = switched_one_pole(gc.cpu().numpy(), alpha_a.reshape(-1).cpu().numpy(),
                            alpha_r.reshape(-1).cpu().numpy())
    return torch.pow(10.0, torch.from_numpy(env).to(x.device) / 20.0) * x


def batch(config: dict, seed: int, step: int, size: int, device, augment: bool = True,
          bypass: bool = False):
    """(x (B, chunk), y (B, out_chunk), knobs (B, 4)), float32 on ``device``,
    of step ``step`` of the run seeded ``seed``."""
    g = step_generator(torch.Generator(device=device), seed, step)
    t = torch.arange(config["in_chunk_size"], dtype=torch.float32, device=device) / config["sr"]
    xs = stratified_batch(g, t, size)
    knobs = random_ends(g, size, config["num_knobs"]) - 0.5
    kr = torch.tensor(config["knob_ranges"], dtype=torch.float32, device=device)
    wc = kr[:, 0] + (knobs + 0.5) * (kr[:, 1] - kr[:, 0])
    y = compressor_4c(xs, wc, float(config["sr"]), bypass)[:, -config["out_chunk_size"]:]
    x = xs
    if augment:
        flip = torch.rand(size, generator=g, device=g.device) < 0.5
        sign = torch.where(flip, -1.0, 1.0)[:, None].to(x.dtype)
        x, y = x * sign, y * sign
    return x.float(), y.float().contiguous(), knobs.float()
