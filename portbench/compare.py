"""The numbers that decide ``correct``, each against its limit.

Training (the program's first three steps against the reference's):

* ``synth_gap``: the synthesized batch of the third step, input and target,
  the largest difference over the largest magnitude of the reference's.
* ``loss_gap``: the largest relative difference of a step's loss.
* ``grad_gap_median``: the first step's gradient as Adam was given it (the
  program's from its first moment after one step, m / (1 - beta1)): for
  each leaf the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf; the median of these
  gaps over the leaves. (The worst leaf is the analysis matrices' on some
  seeds, whose gradient runs through the phase of near-zero bins and swings
  from seed to seed.)
* ``update_gap``: the parameters' change over the three steps, the same
  gap, of the worst leaf.

Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both leaf numbers.

Serving (every sampled request's whole output against the reference's):

* ``out_gap``: the largest difference of a sample over the reference
  output's RMS, the worst request.
* ``out_rms_gap``: the RMS of the difference over the reference output's
  RMS, the worst request.
"""

from __future__ import annotations

import statistics

SKIP_BELOW = 1e-3


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> dict:
    """Each counted leaf's gap of norms: |prog - ref| over the larger of the
    reference's norm of the leaf and of the median leaf."""
    med_g = statistics.median(ref_grad.values())
    keep = [k for k in ref if ref_grad[k] >= SKIP_BELOW * med_g]
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keep}


def window_errors(y, ref, window: int):
    """Each whole window's RMS difference over the reference output's RMS
    (numpy float64; the last, partial window left out)."""
    import numpy as np

    d = (y.astype(np.float64) - ref) / float(np.sqrt(np.mean(ref * ref)))
    n = len(d) // window
    return np.sqrt(np.mean(d[: n * window].reshape(n, window) ** 2, axis=1))


def max_gap(prog, ref) -> float:
    """Largest |prog - ref| over the largest |ref| (tensors)."""
    return float((prog.double() - ref.double()).abs().max() / ref.double().abs().max())


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, every number present, and no failed request or step."""
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    ok = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                             for c in checks.values())
    return ok, checks
