"""Knob-value utilities, host-side numpy, used by dataset generation.

Counterpart of signaltrain_tpu/dsp/knobs.py. ``int2knobs`` maps an integer
to an evenly spaced grid of knob settings in little-endian order (the last
knob varies fastest): the scheme ``cli/gen_dataset.py`` covers the knob
space with.
"""

from __future__ import annotations

import numpy as np


def int2knobs(idx: int, knob_ranges, settings_per: int) -> list:
    """Integer -> grid knob settings, little-endian.

    Examples:
        int2knobs(12345, [[-0.5, 0.5]]*4, 12)
          -> [0.136363..., -0.409090..., 0.227272..., 0.318181...]
        int2knobs(100, [[1, 6]]*3, 6) -> [3.0, 5.0, 5.0]
        int2knobs(1234, [[0, 9]]*4, 10) -> [1.0, 2.0, 3.0, 4.0]
    """
    sp, nk = settings_per, len(knob_ranges)
    assert idx < sp**nk, (
        f"idx ({idx}) must be less than max range of possible values ({sp ** nk})"
    )
    knobs = []
    for i in range(nk - 1, -1, -1):
        sp_pow = sp**i
        setting = idx // sp_pow
        ik = nk - 1 - i  # the ranges are taken in forward order
        dkval = (knob_ranges[ik][1] - knob_ranges[ik][0]) / (sp - 1)
        knobs.append(knob_ranges[ik][0] + dkval * setting)
        idx -= setting * sp_pow
    return knobs


def random_ends_np(size: int = 1, rng: np.random.Generator | None = None):
    """Host-side Beta(0.8, 0.8) knob sampler."""
    rng = rng or np.random.default_rng()
    return rng.beta(0.8, 0.8, size=size)


def knobs_nn_from_wc(knobs_wc, knob_ranges):
    """World coordinates -> normalized [-0.5, 0.5]."""
    kr = np.asarray(knob_ranges)
    return (np.asarray(knobs_wc) - kr[:, 0]) / (kr[:, 1] - kr[:, 0]) - 0.5
