"""The NVIDIA H100 SXM's data-sheet rates (at 700 W), which the timing
scripts (``cli/time_*.py``) and ``chip_smoke.py`` hold the kernels' times
against, and the SM clock the card reports.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate of their type.
"""

from __future__ import annotations

import subprocess

PEAK_F32_FLOPS = 67e12  # CUDA cores, float32
PEAK_SPLIT_TF32_FLOPS = 495e12 / 3  # tensor cores, dense TF32, three products per f32 product
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense bf16
PEAK_HBM_BYTES = 3.35e12  # HBM3
FMA_CYCLES = 4  # latency of one dependent float32 fma, mul or select on an SM


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time for flops at peak and
    nbytes at the HBM rate, and which of the two sets it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def sm_clock_mhz() -> float:
    """The SM clock of card 0 as nvidia-smi reads it now (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])
