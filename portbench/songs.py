"""Music-like audio made from a seed, in numpy: the songs a serving cell
sends.

A frozen copy of ``signaltrain_tpu_torch/dsp/synths.py`` ``music_like_clip``
(:381-436): a bass line, a plucked pentatonic melody and percussive noise
bursts on a 110 bpm grid, peak-normalized to 0.5.
"""

from __future__ import annotations

import numpy as np


def music_like(duration_s: float, sr: int, rng: np.random.Generator) -> np.ndarray:
    n = int(duration_s * sr)
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros(n, np.float64)
    beat = 60.0 / 110.0
    penta = 220.0 * 2.0 ** (np.array([0, 3, 5, 7, 10, 12]) / 12.0)
    bar = 4 * beat
    for b in range(int(duration_s / bar) + 1):
        f = float(penta[rng.integers(0, 3)]) / 2.0
        s, e = int(b * bar * sr), min(int((b + 1) * bar * sr), n)
        if e <= s:
            continue
        tt = t[s:e] - t[s]
        env = np.minimum(tt / 0.02, 1.0) * np.exp(-tt / (bar * 0.9))
        out[s:e] += 0.35 * env * (np.sin(2 * np.pi * f * tt)
                                  + 0.3 * np.sin(2 * np.pi * 2.003 * f * tt))
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
        out[s : s + dur] += 0.25 * np.exp(-tt / 0.25) * (
            np.sin(2 * np.pi * f * tt) + 0.5 * np.sin(2 * np.pi * 2 * f * tt)
            + 0.25 * np.sin(2 * np.pi * 3 * f * tt))
    for k in range(int(duration_s / beat)):
        s = int(k * beat * sr)
        dur = min(int(0.05 * sr), n - s)
        if dur <= 0:
            continue
        tt = t[s : s + dur] - t[s]
        burst = rng.standard_normal(dur) * np.exp(-tt / 0.008)
        out[s : s + dur] += (0.22 if k % 4 == 0 else 0.08) * burst
        if k % 4 == 0:
            out[s : s + dur] += 0.3 * np.exp(-tt / 0.05) * np.sin(2 * np.pi * 60 * tt)
    return (0.5 * out / np.max(np.abs(out))).astype(np.float32)


class Traffic:
    """Requests for whole songs: song lengths log-spaced over ``song_s`` in
    ``song_grid`` steps, every length once in each cycle in an order drawn
    from the seed; each song a slice of a looped base of ``base_song_s``
    seconds at an offset drawn from the seed, and its knobs uniform over the
    configuration's ranges, normalized to [-0.5, 0.5]."""

    def __init__(self, workload: dict, config: dict, rng: np.random.Generator):
        sr = config["sr"]
        lo, hi = workload["song_s"]
        g = workload["song_grid"]
        self.lengths = [int(round(sr * lo * (hi / lo) ** ((i + 0.5) / g))) for i in range(g)]
        base = music_like(workload["base_song_s"], sr, rng)
        reps = -(-(max(self.lengths) + len(base)) // len(base))
        self.audio = np.tile(base, reps)
        self.base_len = len(base)
        self.ranges = np.asarray(config["knob_ranges"], np.float64)
        self.rng = rng
        self.order: list[int] = []

    def song(self, length: int) -> np.ndarray:
        off = int(self.rng.integers(0, self.base_len))
        return self.audio[off : off + length]

    def knobs(self) -> np.ndarray:
        wc = self.rng.uniform(self.ranges[:, 0], self.ranges[:, 1])
        return ((wc - self.ranges[:, 0]) / (self.ranges[:, 1] - self.ranges[:, 0])
                - 0.5).astype(np.float32)

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """The next request: (song, knobs_nn)."""
        if not self.order:
            self.order = list(self.rng.permutation(len(self.lengths)))
        return self.song(self.lengths[self.order.pop()]), self.knobs()
