"""1cycle learning-rate / momentum schedule, on host scalars.

Counterpart of signaltrain_tpu/training/schedule.py. Two forms of the same
schedule:

* ``one_cycle_lut``: numpy look-up tables as the reference builds them
  (cosine ramp to lr_max over the first 30% of iterations, cosine anneal to
  lr_start/100 after; momentum counter-cycled 0.95 -> 0.85 -> 0.95).
* ``one_cycle_fn`` / ``momentum_fn``: closed-form functions of the step
  counter, identical to indexing the tables with min(step, n_iter - 1). The
  train step writes ``lr_fn(step)`` into the optimizer's param groups.

The momentum channel is cosmetic under Adam (it is printed in the status
line only).
"""

from __future__ import annotations

import numpy as np


def _phases(lr_max, n_data_points, epochs, batch_size):
    pct_start, div_factor = 0.3, 15.0
    lr_start = lr_max / div_factor
    lr_end = lr_start / 1e2
    n_iter = n_data_points * epochs // batch_size
    a1 = int(n_iter * pct_start)
    a2 = n_iter - a1
    return lr_start, lr_end, n_iter, a1, a2


def one_cycle_lut(lr_max=1e-3, n_data_points=8000, epochs=200, batch_size=40):
    """Numpy tables (lrs, moms), exactly as the reference builds them."""
    lr_start, lr_end, _, a1, a2 = _phases(lr_max, n_data_points, epochs, batch_size)
    lrs_first = (lr_max - lr_start) * (1 - np.cos(np.linspace(0, np.pi, a1))) / 2 + lr_start
    lrs_second = (lr_max - lr_end) * (1 + np.cos(np.linspace(0, np.pi, a2))) / 2 + lr_end
    lrs = np.concatenate((lrs_first, lrs_second))

    mom_min, mom_max = 0.85, 0.95
    mom_avg, mom_amp = (mom_min + mom_max) / 2, (mom_max - mom_min) / 2
    mom_first = mom_avg + mom_amp * np.cos(np.linspace(0, np.pi, a1))
    mom_second = mom_avg - mom_amp * np.cos(np.linspace(0, np.pi, a2))
    moms = np.concatenate((mom_first, mom_second))
    return lrs, moms


def one_cycle_fn(lr_max=1e-3, n_data_points=8000, epochs=200, batch_size=40):
    """Closed-form fn(step) -> lr (a Python float)."""
    lr_start, lr_end, n_iter, a1, a2 = _phases(lr_max, n_data_points, epochs, batch_size)

    def lr_at(step) -> float:
        i = float(min(int(step), n_iter - 1))
        # linspace(0, pi, a): element k is pi*k/(a-1)
        if i < a1:
            return float((lr_max - lr_start) * (1 - np.cos(np.pi * i / max(a1 - 1, 1))) / 2
                         + lr_start)
        j = i - a1
        return float((lr_max - lr_end) * (1 + np.cos(np.pi * j / max(a2 - 1, 1))) / 2 + lr_end)

    return lr_at


def momentum_fn(n_data_points=8000, epochs=200, batch_size=40):
    """Closed-form momentum channel (for the status line)."""
    _, _, n_iter, a1, a2 = _phases(1.0, n_data_points, epochs, batch_size)
    mom_min, mom_max = 0.85, 0.95
    mom_avg, mom_amp = (mom_min + mom_max) / 2, (mom_max - mom_min) / 2

    def mom_at(step) -> float:
        i = float(min(int(step), n_iter - 1))
        if i < a1:
            return float(mom_avg + mom_amp * np.cos(np.pi * i / max(a1 - 1, 1)))
        j = i - a1
        return float(mom_avg - mom_amp * np.cos(np.pi * j / max(a2 - 1, 1)))

    return mom_at
