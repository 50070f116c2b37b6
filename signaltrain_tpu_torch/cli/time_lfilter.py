"""Check and time kernel L, the IIR filter (lfilter), on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python -m signaltrain_tpu_torch.cli.time_lfilter

A quicker loop than chip_smoke.py while working on csrc/iir.cu (under a
minute). It builds the kernel, then for each case below runs it twice
(bit-equal), holds it bit for bit to its plain version, and prints its time
(CUDA events) and cycles a step at the SM clock it reads, beside its bound
(utils/card.py) and its chain floor, and the plain version's time. The
card's name and power limit head the output.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from ..dsp import iir
from ..ops import _cuda, cuda_kernels
from ..utils import card

CASES = ("comp", "lowpass", "row_30s")  # chip_smoke.py checks these
TOOL_CASES = CASES + ("gen_batch",)      # and this tool also gen_dataset's device batch


def inputs(case: str, dev: torch.device):
    """(b, a, x, zi) on dev for one of TOOL_CASES: the Compressor's dB
    envelope at the training batch (200, 8192), order 1 with its
    steady-state zi and per-row cutoffs over the knob range (attack/release
    1-40 ms); the LowPass at (200, 8192), order 3, rows at 10, 100 and 2000
    Hz and the rest over the knob range; the Compressor's envelope over one
    30 s row (its streamed target on a whole clip), and over gen_dataset's
    device batch of 64 files of 5 s (64, 221,184)."""
    rows, n = {"comp": (200, 8192), "lowpass": (200, 8192), "row_30s": (1, 1_323_000),
               "gen_batch": (64, 221_184)}[case]
    g = torch.Generator(device=dev).manual_seed(rows + n)
    sig = torch.randn(rows, n, generator=g, device=dev) * 0.3
    if case == "lowpass":
        cut = torch.empty(rows, device=dev).uniform_(10.0, 2000.0, generator=g)
        cut[:3] = torch.tensor([10.0, 100.0, 2000.0], device=dev)
        b, a = iir.butter_lowpass(3, cut / 22050.0)
        return b, a, sig, torch.zeros(rows, 3, device=dev)
    attackrel = torch.empty(rows, device=dev).uniform_(1e-3, 4e-2, generator=g)
    b, a = iir.butter_lowpass(1, 1.0 / (attackrel * 44100.0))
    db = 20.0 * torch.log10(sig.abs() + 1e-6)
    zi = (b[:, 1] - a[:, 1] * b[:, 0]) / (1.0 + a[:, 1])
    return b, a, db, (zi * db[:, 0])[:, None]


# the rows of adversarial_inputs, in order: (name, cutoff over Nyquist)
ADVERSARIAL = (("steady_state", 0.2), ("signed_zeros", 0.01), ("subnormal", 0.3),
               ("subnormal_decay", 0.05), ("pole_near_1", 10.0 / 22050.0), ("cutoff_high", 0.95),
               ("nyquist", 0.5), ("large", 0.002))


def adversarial_inputs(n: int, order: int, dev: torch.device, seed: int = 0):
    """(b, a, x, zi) on dev, one row of n samples for each entry of
    ADVERSARIAL, each with its own Butterworth low-pass of the given order:
    a constant input from its steady state (zi = lfilter_zi * x[0]); +-0.0
    with a few small samples; subnormal inputs; an impulse whose response
    decays through the subnormals; poles within 1.5e-3 of z = 1 (10 Hz);
    a cutoff at 0.95 of Nyquist; +-1 at Nyquist; dB-sized inputs. Made on the
    CPU from a seed, so that the CPU and the card see the same bits."""
    gen = torch.Generator().manual_seed(seed + order)
    rows = len(ADVERSARIAL)
    randn = torch.randn(rows, n, generator=gen)
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    t = torch.arange(n)
    special = {
        "steady_state": torch.full((n,), 2.0),
        "signed_zeros": torch.where(t % 5 == 2, randn[1] * 1e-3, sign * 0.0),
        "subnormal": randn[2] * 1e-39,
        "subnormal_decay": torch.where(t == 0, 1e-36, 0.0),
        "nyquist": torch.where(t % 2 == 0, 1.0, -1.0),
        "large": randn[7] * 30.0 - 60.0,
    }
    x = torch.stack([special.get(name, randn[i]) for i, (name, _) in enumerate(ADVERSARIAL)])
    b, a = iir.butter_lowpass(order, torch.tensor([w for _, w in ADVERSARIAL], dtype=torch.float32))
    zi = torch.zeros(rows, order)
    zi[0] = iir.lfilter_zi(b[0], a[0]) * x[0, 0]
    zi[4] = torch.randn(order, generator=gen)
    return tuple(v.float().contiguous().to(dev) for v in (b, a, x, zi))


def bound_ms(x: torch.Tensor, order: int) -> tuple[float, str]:
    """The least time for lfilter on x: each sample read and written once (8
    B), 4*order + 1 flops a sample, against the card's HBM rate and float32
    peak."""
    return card.bound_ms((4 * order + 1) * x.numel(), 8.0 * x.numel())


def chain_cycles(order: int) -> float:
    """Cycles a step of one row's dependent chain (the step of csrc/iir.cu),
    at card.FMA_CYCLES an operation: y -> a_o*y -> z_{o-1} -> ... -> z_0 -> y
    is 2*order + 1 operations over order steps (order 1: fma -> mul -> fma, 3
    a step; order 3: 7 over 3 steps); every other cycle takes 2 a step."""
    return card.FMA_CYCLES * max(2.0, (2 * order + 1) / order)


def chain_floor_ms(n: int, order: int, sm_mhz: float) -> float:
    """One row's N dependent steps of chain_cycles(order) at the SM clock."""
    return n * chain_cycles(order) / (sm_mhz * 1e3)


def check(case: str, dev: torch.device) -> dict:
    """Kernel L on one case: twice, bit-equal; bit-equal to its plain version.
    Raises on a disagreement. Returns the errors and the plain seconds."""
    b, a, x, zi = inputs(case, dev)
    return check_inputs(case, b, a, x, zi)


def check_inputs(case: str, b, a, x, zi) -> dict:
    """check() on given inputs."""
    y = iir.lfilter(b, a, x, zi)
    again = iir.lfilter(b, a, x, zi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = iir.lfilter_reference(b, a, x, zi)
    plain_s = time.perf_counter() - t0
    if not torch.equal(y, again):
        raise RuntimeError(f"kernel L ({case}): two runs on the same inputs are not bit-equal")
    err = (y - ref).abs()
    if not bool(torch.isfinite(y).all()) or not torch.equal(y.view(torch.int32),
                                                             ref.view(torch.int32)):
        raise RuntimeError(f"kernel L ({case}) is not bit-equal to its plain version: max error "
                           f"{float(err.max()):.3e}, {int((y != ref).sum())} elements differ")
    return {"max_abs_err": float(err.max()), "elements_differing": int((y != ref).sum()),
            "plain_s": plain_s, "shape": tuple(x.shape), "order": b.shape[-1] - 1}


def time_case(case: str, dev: torch.device, reps: int = 20) -> float:
    """Mean ms of kernel L on the case's inputs (CUDA events)."""
    b, a, x, zi = (t.contiguous() for t in inputs(case, dev))
    for _ in range(2):
        cuda_kernels.lfilter_rows(b, a, x, zi)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        cuda_kernels.lfilter_rows(b, a, x, zi)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("time_lfilter: needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _cuda.build(["iir"])
    for line in _cuda.build_report("iir"):
        print(f"  ptxas[iir]: {line}")
    for case in TOOL_CASES:
        r = check(case, dev)
        ms = time_case(case, dev, reps=5 if case in ("row_30s", "gen_batch") else 20)
        x = inputs(case, dev)[2]
        bound, by = bound_ms(x, r["order"])
        mhz = card.sm_clock_mhz()
        n = x.shape[1]
        floor = chain_floor_ms(n, r["order"], mhz)
        print(f"L {case} x {r['shape']} order {r['order']}: {ms:.4f} ms, "
              f"{ms * mhz * 1e3 / n:.2f} cycles a step at {mhz:.0f} MHz; bound {bound:.4f} ms by "
              f"{by}; chain floor {floor:.4f} ms ({chain_cycles(r['order']):.2f} cycles a step); "
              f"plain {r['plain_s'] * 1e3:.1f} ms; bit-equal to it")


if __name__ == "__main__":
    main()
