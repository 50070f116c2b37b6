"""Deterministic music-like test signal (numpy, host side).

The port's copy of signaltrain_tpu/dsp/synths.py ``music_like_clip``: the
same generator and draws, so the same seed and duration give the same
samples in both packages. It is a test asset for long-audio inference, not
part of any device path.
"""

from __future__ import annotations

import numpy as np


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
