"""Check and time kernel C, the switched one-pole smoother, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python -m signaltrain_tpu_torch.cli.time_smoother            # chunks of 1024
    python -m signaltrain_tpu_torch.cli.time_smoother --chunks 512 1024 2048

A quicker loop than chip_smoke.py while working on csrc/smoother.cu (under a
minute). It builds the kernel, then for each long row below runs the chunked
schedule and the row schedule, requires them bit-equal and within 1e-6 of the
plain version, and prints their times (CUDA events), each row's warm-up W,
the steps its verification re-ran and the number of virtual rows, for every
chunk length asked for. Then it times the row schedule at the batch shapes
of calc_ct (645, 8192) and of training (200, 8192). The card's name and
power limit head the output.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time

import torch

from ..dsp import compressors, synths
from ..ops import _cuda, cuda_kernels as ck

CLIP_N = 1_323_000  # the 30 s serving clip at 44.1 kHz, smoothed as one row
KNOBS_WC = (-25.0, 4.0, 0.005, 0.02)  # the serving path's comp_4c knobs
CASES = ("serving_curve", "randn", "step_to_silence", "alpha_9999", "alphas_equal", "ragged",
         "at_warmup_cap", "three_rows")


def long_rows(case: str, dev: torch.device, n: int = CLIP_N):
    """(g, alpha_a, alpha_r) on dev for one of CASES: the serving path's gain
    curve (comp_4c on the seeded 30 s music-like clip at the demo knobs; n is
    not used), randn at alpha 0.99 / 0.95 (the timing input of earlier
    runs), a step to silence (-20 for 1,000 samples, then 0, alpha_r 0.9999:
    a guessed carry never meets the true decay), randn at alpha 0.9999, randn
    at alpha_a == alpha_r, a length that is no multiple of a chunk or a tile,
    a length equal to the warm-up cap of 65,536, and three rows of different
    alphas."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    full = lambda b, v: torch.full((b,), v, device=dev)
    randn = lambda b, length: torch.randn(b, length, generator=gen, device=dev)
    if case == "serving_curve":
        clip = torch.from_numpy(synths.music_like_clip(30.0, sr=44100, seed=0)).to(dev)
        g, aa, ar = compressors.gain_curve(clip, *KNOBS_WC, sr=44100)
        return g[None].contiguous(), aa.reshape(1), ar.reshape(1)
    if case == "randn":
        return randn(1, n), full(1, 0.99), full(1, 0.95)
    if case == "step_to_silence":
        g = torch.zeros(1, n, device=dev)
        g[:, :1000] = -20.0
        return g, full(1, 0.99), full(1, 0.9999)
    if case == "alpha_9999":
        return randn(1, n), full(1, 0.9999), full(1, 0.9999)
    if case == "alphas_equal":
        return randn(1, n) * 10.0, full(1, 0.99), full(1, 0.99)
    if case == "ragged":
        return randn(1, n // 1024 * 1024 + 137), full(1, 0.97), full(1, 0.9)
    if case == "at_warmup_cap":  # W = 65,536 = n: every chunk's warm-up reaches sample 0
        return randn(1, 65_536), full(1, 0.9999), full(1, 0.9)
    if case == "three_rows":
        return (randn(3, n), torch.tensor([0.99, 0.9, 0.999], device=dev),
                torch.tensor([0.95, 0.999, 0.9999], device=dev))
    raise ValueError(f"unknown case {case!r}")


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card (CUDA events), after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_row(case: str, g, aa, ar, chunks) -> dict:
    """Both schedules against each other and the plain version; their times
    and the chunked schedule's statistics, for each chunk length."""
    rows = ck.smoother_rows(g, aa, ar)
    t0 = time.perf_counter()
    plain = ck.switched_one_pole_reference(g, aa, ar)
    plain_s = time.perf_counter() - t0
    err = float((rows - plain).abs().max())
    if err > 1e-6:
        raise RuntimeError(f"{case}: the row schedule is {err:.3e} off the plain version")
    out = {"shape": tuple(g.shape), "plain_max_abs_err": err, "plain_s": plain_s,
           "rows_ms": cuda_ms(lambda: ck.smoother_rows(g, aa, ar))}
    for chunk in chunks:
        s, stats = ck.smoother_chunked(g, aa, ar, chunk)
        if not torch.equal(s, rows):
            bad = int((s != rows).nonzero()[0, 1])
            raise RuntimeError(f"{case}, chunk {chunk}: the chunked schedule differs from the row "
                               f"schedule first at sample {bad}")
        out[chunk] = {"ms": cuda_ms(lambda: ck.smoother_chunked(g, aa, ar, chunk)),
                      "warmup": stats[:, 0].tolist(), "rerun_steps": stats[:, 1].tolist(),
                      "virtual_rows": g.shape[0] * math.ceil(g.shape[1] / chunk)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunks", type=int, nargs="+", default=[ck.CHUNK],
                   help="chunk lengths to run the chunked schedule at (multiples of 256)")
    p.add_argument("--cases", nargs="+", default=list(CASES), choices=CASES)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_smoother: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _cuda.build(["smoother"])
    print(f"build {time.perf_counter() - t0:.1f} s; " + "; ".join(_cuda.build_report("smoother")))
    with torch.inference_mode():
        for case in args.cases:
            r = check_row(case, *long_rows(case, dev), args.chunks)
            line = (f"{case} {r['shape']}: rows {r['rows_ms']:.4f} ms, plain {r['plain_s']:.2f} s "
                    f"(max|d| {r['plain_max_abs_err']:.1e})")
            for chunk in args.chunks:
                c = r[chunk]
                line += (f"; chunk {chunk}: {c['ms']:.4f} ms ({r['rows_ms'] / c['ms']:.1f}x), "
                         f"W {c['warmup']}, re-run {c['rerun_steps']}, "
                         f"{c['virtual_rows']} virtual rows")
            print(line + "; bit-equal", flush=True)
        for b in (645, 200):
            g = torch.randn(b, 8192, device=dev)
            aa, ar = torch.full((b,), 0.99, device=dev), torch.full((b,), 0.95, device=dev)
            print(f"rows ({b}, 8192): "
                  f"{cuda_ms(lambda: ck.switched_one_pole_batched(g, aa, ar), reps=20):.4f} ms")
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
