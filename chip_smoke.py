#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); the kernels built from
     signaltrain_tpu_torch/csrc/*.cu, one nvcc per source, all at once;
  2. each of the five kernels held against its plain PyTorch version on the
     card, on seeded random inputs with the tolerance stated: A, B, C at the
     serving shapes and at the training shapes (flagship geometry, batch
     200), D and E at the training shapes. A and D are checked on three
     seeds, A's first check straight after the build. A: every magnitude, the
     phase in two classes by the bin's magnitude (atan2 turns an error e of
     the spectrum into e / mag), and at the training batch its magnitude
     error against a float64 spectrum beside the plain version's. D with
     unit-normal phase cotangents (dphs / |spec| is ill-conditioned on bins of
     near-zero magnitude, so the kernel is held against a float64 plain
     version, with the slack each element's conditioning gives it) and with
     well-conditioned ones (every element
     of dxp and dW against the plain version); B, D and E run twice on the
     same inputs and must be bit-equal; B and E are also held, as A is, to
     their largest error against a float64 plain version beside the plain f32
     version's (within twice it plus 1e-6 * max|result|); E's edge frames must
     be exact zeros. C's chunked schedule (a 30 s row) must be bit-equal to its
     row schedule on the serving path's gain curve, on randn and on a step to
     silence that never meets, and all within 1e-6 of the plain version;
  3. the serving path, with every kernel counter set to 0 just before it and
     read just after: demo/model_comp4c_demo.tar loaded onto the card, a
     seeded 30 s music-like clip through predict_long at the comp_4c knobs
     [-25, 4, 0.005, 0.02], and the comp_4c target by Compressor_4c.go_wc
     and calc_ct. A, B and C (go_wc's whole-clip row by its chunked schedule)
     must have launched and no plain version run;
     the prediction must be finite, of the expected length, correlate >= 0.98
     with the target (the floor of tests/test_shipped_model_quality.py) and
     agree with the plain CPU path on a short clip (atol 1e-3);
  4. the training path, counters set to 0 just before and read just after:
     train() on the card (comp_4c, float32, fused front-end, fresh seeded
     weights, batch 200, 3 epochs x 20 steps, lr_max 2e-4) in a temporary
     directory, then its checkpoint through load_model (strict) and
     predict_long on a 2 s clip. All five kernels must have launched and no
     plain version run; every loss finite; the mean validation MAE lower
     after the last epoch than after the first; the served output finite and
     of the expected length. One more step on the same batch through
     frontend="fused" (the kernels) and "gemm" (plain autograd), each against
     the gemm step in float64: the fused loss within twice the gemm step's
     relative error plus 1e-5, every fused gradient within twice the gemm
     step's error plus 1e-3 * max|g| of its leaf;
  5. timing with CUDA events: each kernel, its plain version and the
     PyTorch library calls nearest to it, beside the bound computed from this
     run's shapes (HBM 3.35 TB/s; for A, B, D and E, whose products run as
     three TF32 tensor-core products, a third of the 495 TFLOP/s dense TF32
     peak = 165 TFLOP/s of f32-accurate work, with the bound at the CUDA
     cores' f32 67 TFLOP/s beside it: the H100 SXM data-sheet rates at 700 W;
     for C the f32 67 TFLOP/s, and beside it the floor of its schedule's
     dependent chain: W + L steps chunked, a row's length by rows), with the
     TFLOP/s that A, B, D and E reach; C chunked on the serving gain curve, on
     randn and on the row that never meets (at most 1.2 x the row schedule),
     each beside the row schedule, with W, L, the virtual rows and the steps
     re-run; predict_long's
     audio-seconds per second; the
     train step with either front-end (host clock, least and most of two
     turns) and the data synthesis alone; one torch.profiler window over each
     for the card's busy time and the kernels launched.
The last two lines are the kernels JSON line and the result line.

Exits non-zero with no result when torch.cuda.is_available() is false, or
when it is not next to the signaltrain_tpu_torch package it drives.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CKPT = HERE / "demo" / "model_comp4c_demo.tar"
KNOBS_WC = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)
CLIP_SECONDS = 30.0
MIN_CORR = 0.98
PEAK_F32_FLOPS = 67e12  # H100 SXM, CUDA cores, float32
PEAK_SPLIT_TF32_FLOPS = 495e12 / 3  # tensor cores, dense TF32, three products per f32 product
CHAIN_CYCLES = 8  # kernel C: one fma and one select per step, each ~4 cycles, dependent
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TRAIN_BATCH = 200
TRAIN_EPOCHS, TRAIN_POINTS, TRAIN_LR = 3, 4000, 2e-4  # 3 epochs x 20 steps
SEEDS = (0, 1, 2)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() on the card over reps calls, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def disagreement(name: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """The failure message of a kernel check: where the worst error sits."""
    idx = np.unravel_index(int(torch.argmax((got - want).abs())), tuple(got.shape))
    return (f"kernel {name} disagrees with its plain version: worst at {tuple(map(int, idx))}, "
            f"kernel {got[idx].item()!r} plain {want[idx].item()!r}")


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() by the host clock, the card drained before
    and after: what a step costs with its host work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def grad_excess(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Largest error of a gradient, and 1e-3 * max|want|."""
    return float((got - want).abs().max()), 1e-3 * float(want.abs().max())


def elementwise_excess(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """Largest error, and its largest excess over tol + tol*|want|."""
    err = (got - want).abs()
    return float(err.max()), float((err - (tol + tol * want.abs())).max())


def card_busy(fn, reps: int) -> dict:
    """One torch.profiler window over reps calls of fn(): the card's busy
    milliseconds (all kernel and copy times summed) and the kernels launched,
    per call. Raises if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    on_card = torch.autograd.DeviceType.CUDA
    # an annotation (Optimizer.step#...) shows on both timelines; a kernel only on the card's
    host_names = {e.key for e in rows if e.device_type != on_card}
    kernels = [e for e in rows if e.device_type == on_card and e.key not in host_names]
    busy_us = sum(e.self_device_time_total for e in kernels)
    check(busy_us > 0, "torch.profiler reported no device time")
    return {"card_busy_ms": busy_us / 1e3 / reps,
            "kernels_launched": sum(e.count for e in kernels) / reps}


def phase_classes(phs: torch.Tensor, rphs: torch.Tensor, rmag: torch.Tensor) -> dict:
    """Kernel A's phase against the plain version's, in two classes. The
    phase atan2(im, re + 1e-7) turns an error e of the spectrum into e / mag,
    and any other order of adding the products moves the spectrum by ~5e-7.
    Bins whose plain magnitude is >= 1e-2 are held to the wrapped 2e-4 +
    2e-4*|phs| (a 1-ulp change of im at the branch cut moves atan2 by 2 pi);
    smaller ones to 2e-6 / mag, four times an f32 product's own largest error
    against a float64 one. Returns each class's count, worst difference and
    largest excess over its limit."""
    d = ((phs.double() - rphs.double() + np.pi).remainder(2 * np.pi) - np.pi).abs()
    big = rmag >= 1e-2
    limit = torch.where(big, 2e-4 + 2e-4 * rphs.double().abs(), 2e-6 / rmag.double())
    out = {}
    for name, sel in (("regular", big), ("small", ~big)):
        n_sel = int(sel.sum())
        out[name] = dict(bins=n_sel, worst=float(d[sel].max()) if n_sel else 0.0,
                         excess=float((d[sel] - limit[sel]).max()) if n_sel else -1.0)
    return out


def as_accurate(name: str, got: torch.Tensor, plain: torch.Tensor, exact: torch.Tensor,
                floor: float) -> tuple[float, float]:
    """Largest errors of a kernel's and of its plain version's result against
    a float64 one; raises unless the kernel's is within twice the plain
    version's plus floor. The statement 'as accurate as f32' for quantities
    too ill-conditioned to compare two f32 results with each other."""
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    check(err <= 2 * plain_err + floor,
          f"kernel {name}: error {err:.3e} against float64, the plain version's is {plain_err:.3e}")
    return err, plain_err


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the port on a CUDA card")
    if not (HERE / "signaltrain_tpu_torch" / "__init__.py").is_file() or not CKPT.is_file():
        fail(f"run from a checkout of the repository: {HERE} lacks the package or {CKPT.name}")
    sys.path.insert(0, str(HERE))

    from signaltrain_tpu_torch.cli import time_smoother
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects, synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, cuda_kernels
    from signaltrain_tpu_torch.training import train as train_mod
    from signaltrain_tpu_torch.utils.load_model import load_model

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card, model and clip, build (the build last, so that kernel
    # A's first check follows it directly)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    model, rv = load_model(str(CKPT), device=dev)
    spec = model.spec
    ft, hop, half = spec.ft_size, spec.hop_size, spec.ft_size // 2 + 1
    chunk, out_chunk = spec.in_chunk_size, spec.out_chunk_size
    sr = int(rv["sr"])
    clip = synths.music_like_clip(CLIP_SECONDS, sr=sr, seed=0)
    n_windows = pl._num_windows(len(clip), chunk, chunk - out_chunk)
    ct_batch = (len(clip) - out_chunk) // out_chunk + 1  # calc_ct's full-length windows
    lp = chunk + 2 * ft
    frames, out_frames = spec.time_frames, spec.output_time_frames
    out_len = spec.out_chunk_size
    with torch.no_grad():
        w_an = model.mpaec.dft_analysis.stacked_weights().contiguous()
        w_syn = model.mpaec.dft_synthesis.stacked_weights().contiguous()
    print(f"main path: {CLIP_SECONDS} s clip, {n_windows} windows of {chunk} -> {out_chunk}, "
          f"ft {ft} hop {hop} T {frames} OT {out_frames}")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built) or 'nothing (cached)'}"
          f" {json.dumps({k: round(v, 2) for k, v in built.items()})}")
    for name in _cuda.sources():
        for line in _cuda.build_report(name):
            print(f"  ptxas[{name}]: {line}")

    occupancy = _cuda.function("frontend", "st_analysis_blocks_per_sm", [])()
    print(f"blocks of the tensor-core product an SM holds at once: {occupancy}")

    # ---- 2. kernels against their plain versions, on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    with torch.inference_mode():
        mag_err = phs_err = small_phs_err = 0.0
        # the serving batch on three seeds, the first straight after the
        # build, the training batch in between (the timing takes the last xp)
        a_checks = [(seed, n_windows) for seed in SEEDS]
        a_checks.insert(1, (len(SEEDS), TRAIN_BATCH))
        for seed, nb in a_checks:
            sg = torch.Generator(device=dev).manual_seed(seed)
            xp = torch.nn.functional.pad(
                torch.randn(nb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
            mag, phs = cuda_frontend.fused_analysis(xp, w_an, ft, hop)
            rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop)
            torch.cuda.synchronize()
            check(mag.shape == (frames, nb, half), f"analysis shape {tuple(mag.shape)}")
            m_err = float((mag - rmag).abs().max())
            mag_excess = float(((mag - rmag).abs() - (2e-5 + 2e-5 * rmag.abs())).max())
            cls = phase_classes(phs, rphs, rmag)
            print(f"A fused_analysis xp {tuple(xp.shape)} seed {seed}: max|dmag| {m_err:.3e} "
                  f"(tolerance 2e-5+2e-5|mag|); wrapped phase: {cls['regular']['bins']} bins of "
                  f"magnitude >= 1e-2, worst {cls['regular']['worst']:.3e} (tolerance "
                  f"2e-4+2e-4|phs|); {cls['small']['bins']} smaller bins, worst "
                  f"{cls['small']['worst']:.3e} (tolerance 2e-6/mag)")
            check(mag_excess <= 0, disagreement(f"A (magnitude, seed {seed})", mag, rmag))
            for name, c in cls.items():
                check(c["excess"] <= 0, f"kernel A (phase, {name} bins, seed {seed}): worst "
                                        f"difference {c['worst']:.3e}, {c['excess']:.3e} over its limit")
            check(all(bool(torch.all(mag[e] == np.float32(1e-18))) and bool(torch.all(phs[e] == 0))
                      for e in (0, -1)), "kernel A: an edge frame is not exactly (1e-18, 0)")
            mag_err = max(mag_err, m_err)
            phs_err = max(phs_err, cls["regular"]["worst"])
            small_phs_err = max(small_phs_err, cls["small"]["worst"])
            if nb == TRAIN_BATCH:  # as accurate as f32: both against a float64 spectrum
                spec64 = (xp.unfold(1, ft, hop).transpose(0, 1).double() * 0.5) @ w_an.double()
                mag64 = torch.sqrt(spec64[..., :half] ** 2 + spec64[..., half:] ** 2)
                mag64 = mag64.clamp_min(1e-18)
                f64_err, f64_plain = as_accurate("A (magnitude)", mag, rmag, mag64, 1e-7)
                emu = cuda_frontend.split_tf32_matmul(
                    xp.unfold(1, ft, hop).transpose(0, 1).reshape(-1, ft) * 0.5, w_an)
                emu_err = float((cuda_frontend.mag_phs(emu[:, :half], emu[:, half:])[0]
                                 - mag64.reshape(-1, half)).abs().max())
                print(f"A against a float64 spectrum, xp {tuple(xp.shape)}: max magnitude error "
                      f"kernel {f64_err:.3e}, plain version {f64_plain:.3e}, split_tf32_matmul "
                      f"{emu_err:.3e}; limit 2 x plain + 1e-7; max|mag| {float(mag64.max()):.3f}")
                del spec64, mag64, emu
        results["fused_analysis"] = dict(
            max_abs_err=mag_err, max_phase_err=phs_err, max_small_bin_phase_err=small_phs_err,
            max_err_vs_float64=f64_err, plain_max_err_vs_float64=f64_plain,
            tolerance="mag 2e-5 + 2e-5*|mag|; wrapped phase 2e-4 + 2e-4*|phs| where mag >= 1e-2, "
                      "2e-6/mag below; magnitude error against float64 <= 2 x plain's + 1e-7")

        syn_err = syn_f64 = syn_f64_plain = 0.0
        for nb in (TRAIN_BATCH, n_windows):  # smag, sphs end as the serving ones, for the timing
            smag = torch.nn.functional.softplus(
                torch.randn(out_frames, nb, half, generator=gen, device=dev))
            sphs = torch.randn(out_frames, nb, half, generator=gen, device=dev) * 2.0
            wave = cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop)
            wave2 = cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop)
            rwave = cuda_frontend.fused_synthesis_reference(smag, sphs, w_syn, ft, hop)
            xwave = cuda_frontend.fused_synthesis_reference(smag.double(), sphs.double(),
                                                            w_syn.double(), ft, hop)
            torch.cuda.synchronize()
            check(wave.shape == (nb, out_len), f"synthesis shape {tuple(wave.shape)}")
            check(torch.equal(wave, wave2), "kernel B: two runs on the same inputs are not bit-equal")
            err, syn_excess = elementwise_excess(wave, rwave, 3e-4)
            f64, f64_plain = as_accurate("B", wave, rwave, xwave, 1e-6 * float(xwave.abs().max()))
            print(f"B fused_synthesis mag {tuple(smag.shape)}: max|dwave| {err:.3e}; "
                  f"tolerance 3e-4+3e-4|wave|; against float64: kernel {f64:.3e}, plain version "
                  f"{f64_plain:.3e} (limit 2 x plain + 1e-6 max|wave|, max|wave| "
                  f"{float(xwave.abs().max()):.3f}); two runs bit-equal")
            check(syn_excess <= 0, disagreement("B", wave, rwave))
            syn_err, syn_f64, syn_f64_plain = (max(syn_err, err), max(syn_f64, f64),
                                               max(syn_f64_plain, f64_plain))
            del xwave
        results["fused_synthesis"] = dict(
            max_abs_err=syn_err, max_err_vs_float64=syn_f64, plain_max_err_vs_float64=syn_f64_plain,
            tolerance="3e-4 + 3e-4*|wave|; error against float64 <= 2 x plain's + 1e-6*max|wave|; "
                      "two runs bit-equal")

        smooth_shapes = [(1, len(clip)), (1, chunk), (ct_batch, chunk), (TRAIN_BATCH, chunk)]
        smooth_err, plain_c_s = 0.0, 0.0
        for b, n in smooth_shapes:
            g = torch.randn(b, n, generator=gen, device=dev)
            aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            plain_c_s += time.perf_counter() - t_start
            err = float((s - rs).abs().max())
            smooth_err = max(smooth_err, err)
            print(f"C switched_one_pole g {(b, n)} ({'chunked' if cuda_kernels.uses_chunks(b, n) else 'row'}"
                  f" schedule): max|ds| {err:.3e}; tolerance 1e-6 (plain version "
                  f"{time.perf_counter() - t_start:.2f} s)")
            check(err <= 1e-6 and bool(torch.all(s[:, 0] == 0)), disagreement("C", s, rs))
        # the chunked schedule on whole-clip rows, bit-equal to the row schedule:
        # the serving path's own gain curve, randn, and a row that never meets
        plain_c_ms = None
        for case in ("serving_curve", "randn", "step_to_silence"):
            g, aa, ar = time_smoother.long_rows(case, dev)
            s, stats = cuda_kernels.smoother_chunked(g, aa, ar)
            rows = cuda_kernels.smoother_rows(g, aa, ar)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            t_plain = time.perf_counter() - t_start
            plain_c_s += t_plain
            if case == "serving_curve":
                plain_c_ms = t_plain * 1e3
            err = float((s - rs).abs().max())
            smooth_err = max(smooth_err, err)
            print(f"C chunked schedule, {case} g {tuple(g.shape)}: bit-equal to the row schedule "
                  f"{torch.equal(s, rows)}; max|ds| {err:.3e} against the plain version "
                  f"({t_plain:.2f} s); W {int(stats[0, 0])}, L {cuda_kernels.CHUNK}, "
                  f"{math.ceil(g.shape[1] / cuda_kernels.CHUNK)} virtual rows, "
                  f"{int(stats[0, 1])} steps re-run")
            check(torch.equal(s, rows), f"kernel C: the chunked schedule differs from the row "
                                        f"schedule on {case}")
            check(err <= 1e-6, disagreement(f"C (chunked, {case})", s, rs))
        print(f"C: the plain version took {plain_c_s:.2f} s in all")
        results["switched_one_pole"] = dict(
            max_abs_err=smooth_err, plain_s_all_checks=plain_c_s,
            tolerance="1e-6 against the plain version; the chunked schedule bit-equal to the row "
                      "schedule")

        # D and E at the training shapes; cotangents scaled by 64/ft so the
        # gradients stay O(1-10), as in the CPU tests against the JAX package
        tb, tlp = TRAIN_BATCH, chunk + 2 * ft
        d_dw_err = d_dx_err = d_reg_err = 0.0
        for seed in SEEDS:
            sg = torch.Generator(device=dev).manual_seed(100 + seed)
            txp = torch.nn.functional.pad(
                torch.randn(tb, chunk, generator=sg, device=dev) * 0.3, (ft, ft))
            tdmag = torch.randn(frames, tb, half, generator=sg, device=dev) * (64.0 / ft)
            tdphs = torch.randn(frames, tb, half, generator=sg, device=dev) * (64.0 / ft)
            dxp, dw = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop)
            dxp2, dw2 = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop)
            rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, tdphs, ft, hop)
            xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(
                txp.double(), w_an.double(), tdmag.double(), tdphs.double(), ft, hop)
            torch.cuda.synchronize()
            check(dxp.shape == (tb, tlp) and dw.shape == (ft, 2 * half), "D: shapes")
            check(torch.equal(dw, dw2) and torch.equal(dxp, dxp2),
                  "kernel D: two runs on the same inputs are not bit-equal")
            # With a unit-normal phase cotangent on every bin, dphs / |spec|
            # amplifies the ~5e-7 by which two f32 spectra differ: two f32
            # results cannot be compared element by element (the plain version
            # itself is off a float64 one by ~1e-2 in dx and ~1e-3 * max|dW| in
            # dW). So the kernel, and the plain version beside it, are held
            # against float64, every element to 5e-4 + 5e-4|g| plus the slack
            # its conditioning gives it. dx on the unpadded signal: the
            # padding's part carries the adjoint of the all-zero frames.
            sdxp, sdw = cuda_frontend.fused_analysis_bwd_conditioning(txp, w_an, tdmag, tdphs, ft, hop)
            sl = slice(ft, -ft)
            report = {}
            for who, gx, gw in (("kernel", dxp, dw), ("plain", rdxp, rdw)):
                ex = (gx[:, sl] - xdxp[:, sl]).abs()
                ew = (gw - xdw).abs()
                report[who] = (float(ex.max()), float(ew.max()),
                               float((ex / (5e-4 + 5e-4 * xdxp[:, sl].abs() + sdxp[:, sl])).max()),
                               float((ew / (5e-4 + 5e-4 * xdw.abs() + sdw)).max()))
            dx_err, dw_err, dx_share, dw_share = report["kernel"]
            print(f"D fused_analysis_bwd xp {tuple(txp.shape)} seed {seed}, against float64: max dx "
                  f"error {dx_err:.3e} (plain version {report['plain'][0]:.3e}), max dW error "
                  f"{dw_err:.3e} (plain version {report['plain'][1]:.3e}, max|dW| "
                  f"{float(xdw.abs().max()):.3e}); largest share of the tolerance 5e-4+5e-4|g|+slack "
                  f"used: dx {dx_share:.3f} (plain {report['plain'][2]:.3f}), dW {dw_share:.3f} (plain "
                  f"{report['plain'][3]:.3f}); median slack dx {float(sdxp[:, sl].median()):.2e}, dW "
                  f"{float(sdw.median()):.2e}; two runs bit-equal")
            check(dx_share <= 1, f"kernel D (dx, seed {seed}) is {dx_share:.2f} of its tolerance "
                                 f"off the float64 result")
            check(dw_share <= 1, f"kernel D (dW, seed {seed}) is {dw_share:.2f} of its tolerance "
                                 f"off the float64 result")
            del xdxp, xdw, sdxp, sdw
            d_dw_err, d_dx_err = max(d_dw_err, dw_err), max(d_dx_err, dx_err)
            # the same with the phase cotangent zeroed on the bins of small
            # magnitude (the all-padding frames among them): dphs / |spec| is
            # then well conditioned and every element of dxp and dW is held
            kmag = cuda_frontend.fused_analysis_reference(txp, w_an, ft, hop)[0]
            cphs = tdphs * (kmag >= 0.25 * kmag.median())
            dxp, dw = cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, cphs, ft, hop)
            rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, cphs, ft, hop)
            torch.cuda.synchronize()
            rx_err, rx_excess = elementwise_excess(dxp, rdxp, 5e-4)
            rw_err, rw_excess = elementwise_excess(dw, rdw, 5e-4)
            print(f"D well-conditioned, seed {seed}: max|d dxp| {rx_err:.3e} (median|dxp| "
                  f"{float(rdxp.abs().median()):.3e}), max|d dW| {rw_err:.3e} (median|dW| "
                  f"{float(rdw.abs().median()):.3e}, max {float(rdw.abs().max()):.3e}); "
                  f"tolerance 5e-4+5e-4|g| on every element")
            check(rx_excess <= 0, disagreement(f"D (dxp, well-conditioned, seed {seed})", dxp, rdxp))
            check(rw_excess <= 0, disagreement(f"D (dW, well-conditioned, seed {seed})", dw, rdw))
            d_reg_err = max(d_reg_err, rw_err, rx_err)
        results["fused_analysis_bwd"] = dict(
            max_abs_err=d_dw_err, max_dx_err=d_dx_err, max_regular_err=d_reg_err,
            tolerance="unit-normal phase cotangents, against float64: 5e-4 + 5e-4*|g| + the "
                      "element's conditioning slack, dx on the unpadded signal and dW; "
                      "well-conditioned ones, against the plain version: 5e-4 + 5e-4*|g| on every "
                      "element of dxp and dW; two runs bit-equal")

        tmag = torch.nn.functional.softplus(
            torch.randn(out_frames, tb, half, generator=gen, device=dev))
        tphs = torch.randn(out_frames, tb, half, generator=gen, device=dev) * 2.0
        tdout = torch.randn(tb, out_len, generator=gen, device=dev)
        e_got = cuda_frontend.fused_synthesis_bwd(tmag, tphs, w_syn, tdout, ft, hop)
        e_again = cuda_frontend.fused_synthesis_bwd(tmag, tphs, w_syn, tdout, ft, hop)
        e_want = cuda_frontend.fused_synthesis_bwd_reference(tmag, tphs, w_syn, tdout, ft, hop)
        e_exact = cuda_frontend.fused_synthesis_bwd_reference(
            tmag.double(), tphs.double(), w_syn.double(), tdout.double(), ft, hop)
        torch.cuda.synchronize()
        e_err = e_f64 = e_f64_plain = 0.0
        for name, g1, g2, r, x in zip(("dmag", "dphs", "dW"), e_got, e_again, e_want, e_exact):
            check(torch.equal(g1, g2), f"kernel E: two runs differ in {name}")
            err = float((g1 - r).abs().max())
            excess = float(((g1 - r).abs() - (5e-4 + 5e-4 * r.abs())).max())
            check(excess <= 0, disagreement(f"E ({name})", g1, r))
            f64, f64_plain = as_accurate(f"E ({name})", g1, r, x, 1e-6 * float(x.abs().max()))
            print(f"E {name}: max error {err:.3e}; against float64: kernel {f64:.3e}, plain "
                  f"version {f64_plain:.3e} (max|{name}| {float(x.abs().max()):.3e})")
            e_err, e_f64, e_f64_plain = max(e_err, err), max(e_f64, f64), max(e_f64_plain, f64_plain)
        del e_exact
        for g1 in e_got[:2]:  # frames wholly inside the trimmed margin
            check(bool(torch.all(g1[0] == 0)) and bool(torch.all(g1[-1] == 0)),
                  "kernel E: the first or last frame's gradient is not exactly 0")
        print(f"E fused_synthesis_bwd mag {tuple(tmag.shape)}: max error {e_err:.3e} "
              f"(tolerance 5e-4+5e-4|g|); two runs bit-equal; edge frames exactly 0")
        results["fused_synthesis_bwd"] = dict(
            max_abs_err=e_err, max_err_vs_float64=e_f64, plain_max_err_vs_float64=e_f64_plain,
            tolerance="5e-4 + 5e-4*|g| for dmag, dphs, dW; error against float64 <= 2 x plain's + "
                      "1e-6*max|g|; two runs bit-equal; edge frames exactly 0")
    torch.cuda.synchronize()

    # ---- 3. the serving path, counted
    kr = np.asarray(rv["knob_ranges"], np.float32)
    knobs_nn = (KNOBS_WC - kr[:, 0]) / (kr[:, 1] - kr[:, 0]) - 0.5
    _cuda.reset_counts()
    t_path = time.perf_counter()
    y_pred = pl.predict_long(clip, knobs_nn, model)
    effect = effects.make_effect("comp_4c", sr=sr, device=dev)
    y_st, _ = effect.go_wc(clip, KNOBS_WC)
    y_st = y_st.cpu().numpy()
    y_ct = pl.calc_ct(clip, effect, KNOBS_WC, out_chunk, chunk)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    counts = {name: (c.launches, c.plain_calls) for name, c in _cuda.COUNTERS.items()}
    print(f"serving path {t_path:.2f} s; launches / plain calls: {json.dumps(counts)}")
    for name in ("fused_analysis", "fused_synthesis", "switched_one_pole",
                 "switched_one_pole_chunked"):
        check(counts[name][0] > 0, f"serving path never launched kernel {name}")
    for name in results:
        check(counts[name][1] == 0, f"serving path ran the plain version of {name}")
        results[name]["launches_serving"] = counts[name][0]

    lookback = chunk - out_chunk
    check(y_pred.shape == (len(clip) - lookback,), f"prediction length {y_pred.shape}")
    check(bool(np.all(np.isfinite(y_pred))), "prediction is not finite")

    def corr(a, b):
        a, b = a - a.mean(), b - b.mean()
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))

    n = min(len(y_pred), len(y_st) - lookback)
    c_st = corr(y_pred[:n], y_st[lookback : lookback + n])
    c_ct = corr(y_pred[:n], y_ct[lookback : lookback + n])
    print(f"corr(prediction, streamed target) {c_st:.6f}; corr(prediction, chunked target) "
          f"{c_ct:.6f}; floor {MIN_CORR}")
    check(c_st >= MIN_CORR and c_ct >= MIN_CORR, "prediction does not follow the target")

    short = clip[: chunk + 20 * out_chunk + 77]
    cpu_model, _ = load_model(str(CKPT), device="cpu")
    y_cpu = pl.predict_long(short, knobs_nn, cpu_model)
    y_card = pl.predict_long(short, knobs_nn, model)
    d_cpu = float(np.abs(y_card - y_cpu).max())
    print(f"card vs plain CPU path on {len(short)} samples: max|dy| {d_cpu:.3e}; tolerance 1e-3")
    check(d_cpu <= 1e-3, "card and plain CPU path disagree")

    # ---- 4. the training path, counted
    cwd = os.getcwd()
    _cuda.reset_counts()
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            trained, hist = train_mod.train(
                effect, epochs=TRAIN_EPOCHS, n_data_points=TRAIN_POINTS, batch_size=TRAIN_BATCH,
                cp_every=TRAIN_EPOCHS, sr=sr, lr_max=TRAIN_LR, seed=218, device=dev)
            val_lines = [ln.split() for ln in open("val_err_mae.dat").read().strip().splitlines()]
            vl_lines = [ln.split() for ln in open("vl_avg_out.dat").read().strip().splitlines()]
            served, served_rv = load_model("modelcheckpoint.tar", device=dev)  # strict inside
        finally:
            os.chdir(cwd)
    short_clip = synths.music_like_clip(2.0, sr=sr, seed=1)
    y_served = pl.predict_long(short_clip, knobs_nn, served)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t_path
    counts = {name: (c.launches, c.plain_calls) for name, c in _cuda.COUNTERS.items()}
    print(f"\ntraining path {t_path:.2f} s; launches / plain calls: {json.dumps(counts)}")
    for name in results:
        check(counts[name][0] > 0, f"training path never launched kernel {name}")
        check(counts[name][1] == 0, f"training path ran the plain version of {name}")
        results[name]["launches_training"] = counts[name][0]
        results[name]["launches"] = counts[name][0] + results[name]["launches_serving"]
    steps = TRAIN_EPOCHS * (TRAIN_POINTS // TRAIN_BATCH)
    check(len(hist["train_loss"]) == steps and hist["step"] == steps, "train(): step count")
    check(bool(np.all(np.isfinite(hist["train_loss"]))), "train(): a training loss is not finite")
    check(len(val_lines) == TRAIN_EPOCHS and len(vl_lines) == TRAIN_EPOCHS, "train(): log lines")
    check(all(np.isfinite(float(v)) for ln in val_lines + vl_lines for v in ln),
          "train(): a logged validation figure is not finite")
    mean_maes = [float(ln[2]) for ln in val_lines]
    print(f"train(): loss first {hist['train_loss'][0]:.4e} last {hist['train_loss'][-1]:.4e}; "
          f"mean validation MAE by epoch {mean_maes}")
    check(mean_maes[-1] < mean_maes[0], f"validation MAE did not fall: {mean_maes}")
    check(served_rv["optax_step"] == steps, "checkpoint: optimizer step")
    check(all(torch.equal(a, b) for a, b in zip(served.state_dict().values(),
                                               trained.state_dict().values())),
          "checkpoint: the served weights are not the trained ones")
    check(y_served.shape == (len(short_clip) - lookback,) and bool(np.all(np.isfinite(y_served))),
          "predict_long on the trained checkpoint: wrong length or not finite")

    # one more step on the same batch: the kernels against plain autograd
    batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=True)
    data_gen = torch.Generator(device=dev)
    bx, by, bk = batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, 218, steps))
    gemm, _ = load_model(str(CKPT), device=dev)
    gemm.load_state_dict(served.state_dict())
    gemm.mpaec.frontend = "gemm"
    served.train(), gemm.train()
    _cuda.reset_counts()
    l_fused = train_mod.loss_and_grads(served, bx, by, bk)
    l_gemm = train_mod.loss_and_grads(gemm, bx, by, bk)
    torch.cuda.synchronize()
    check(all(_cuda.COUNTERS[c].launches == 1 for c in
              ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd")),
          "the fused step did not launch A, B, D and E once each")
    # The front-end's gradients carry the phase adjoint dphs / |spec|, which
    # amplifies the ~5e-7 by which the kernels' spectrum and cuBLAS's differ,
    # so the two f32 steps are each held against the same step in float64:
    # every gradient of the fused step within twice the gemm step's error plus
    # 1e-3 * max|g| of its leaf, no absolute floor.
    gemm64 = copy.deepcopy(gemm).double()
    l_exact = train_mod.loss_and_grads(gemm64, bx.double(), by.double(), bk.double())
    rel = abs(float(l_fused) - float(l_gemm)) / abs(float(l_gemm))
    rel64 = abs(float(l_fused) - float(l_exact)) / abs(float(l_exact))
    rel64_gemm = abs(float(l_gemm) - float(l_exact)) / abs(float(l_exact))
    worst, worst_gemm, worst_diff, g_max = 0.0, 0.0, 0.0, []
    for (pname, pf_), (_, pg), (_, px) in zip(served.named_parameters(), gemm.named_parameters(),
                                              gemm64.named_parameters()):
        scale = float(px.grad.abs().max())
        err = float((pf_.grad.double() - px.grad).abs().max())
        err_gemm = float((pg.grad.double() - px.grad).abs().max())
        check(scale > 0 and err <= 2 * err_gemm + 1e-3 * scale,
              f"fused gradient of {pname} is off the float64 one by {err:.3e}, the gemm step's by "
              f"{err_gemm:.3e} (max|g| {scale:.3e})")
        worst, worst_gemm = max(worst, err / scale), max(worst_gemm, err_gemm / scale)
        worst_diff = max(worst_diff, grad_excess(pf_.grad, pg.grad)[0] / scale)
        g_max.append(scale)
    print(f"fused vs gemm step on the card: loss {float(l_fused):.6e} / {float(l_gemm):.6e} "
          f"(rel {rel:.2e}; against float64: fused {rel64:.2e}, gemm {rel64_gemm:.2e}; limit 2 x "
          f"gemm's + 1e-5); worst gradient error "
          f"against float64 in units of the leaf's max|g|: fused {worst:.2e}, gemm {worst_gemm:.2e} "
          f"(limit 2 x gemm's + 1e-3); worst fused-gemm difference {worst_diff:.2e}; the leaves' "
          f"max|g| run {min(g_max):.2e} to {max(g_max):.2e}")
    # the loss takes the phase as an input of the autoencoder, so a bin at
    # atan2's branch cut moves it: each f32 loss is held against float64
    check(rel64 <= 2 * rel64_gemm + 1e-5, "the fused loss is off the float64 one")
    del gemm64

    # ---- 5. timing at the main paths' shapes
    with torch.inference_mode():
        results["fused_analysis"]["ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis(xp, w_an, ft, hop), reps=20)
        results["fused_analysis"]["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop), reps=10)
        w_conv = w_an.t().contiguous()[:, None, :]  # (2*half, 1, ft)
        results["fused_analysis"]["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(xp[:, None, :], w_conv, stride=hop), reps=10)
        a_flops = 2.0 * n_windows * frames * ft * 2 * half
        a_bytes = 4.0 * (n_windows * lp + ft * 2 * half + 2 * frames * n_windows * half)
        results["fused_analysis"].update(zip(("bound_ms", "bound_by"),
                                             bound(a_flops, a_bytes, PEAK_SPLIT_TF32_FLOPS)))
        results["fused_analysis"]["bound_ms_cuda_cores"] = bound(a_flops, a_bytes)[0]
        results["fused_analysis"]["tflops"] = a_flops / results["fused_analysis"]["ms"] / 1e9
        results["fused_analysis"]["shape"] = f"xp {tuple(xp.shape)}, w {tuple(w_an.shape)}"

        results["fused_synthesis"]["ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop), reps=20)
        results["fused_synthesis"]["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(smag, sphs, w_syn, ft, hop), reps=10)
        spec_bct = torch.cat([smag * torch.cos(sphs), smag * torch.sin(sphs)], -1).permute(1, 2, 0)
        spec_bct = spec_bct.contiguous()  # (B, 2*half, OT)
        w_tconv = w_syn[:, None, :].contiguous()  # (2*half, 1, ft)
        results["fused_synthesis"]["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(spec_bct, w_tconv, stride=hop), reps=10)
        la = (out_frames - 1) * hop + ft
        overlap = sum(max(0, min(t * hop + ft, la - ft) - max(t * hop, ft))
                      for t in range(out_frames))  # frame samples that reach the trimmed output
        r = results["fused_synthesis"]
        b_flops = 2.0 * n_windows * 2 * half * overlap
        b_bytes = 4.0 * (2 * out_frames * n_windows * half + 2 * half * ft + n_windows * out_len)
        r.update(zip(("bound_ms", "bound_by"), bound(b_flops, b_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(b_flops, b_bytes)[0]
        r["tflops"] = b_flops / r["ms"] / 1e9
        r["shape"] = f"mag {tuple(smag.shape)}, w {tuple(w_syn.shape)}"

        # C on the whole clip as one row, chunked: the serving path's gain
        # curve, the randn input of earlier runs, and the row that never meets,
        # each beside the row schedule; the statistics read after the timing
        r = results["switched_one_pole"]
        for case, key in (("serving_curve", ""), ("randn", "randn_"), ("step_to_silence", "worst_")):
            g, aa, ar = time_smoother.long_rows(case, dev)
            r[f"{key}ms"] = cuda_ms(lambda: cuda_kernels.smoother_chunked(g, aa, ar), reps=20)
            r[f"{key}rows_ms"] = cuda_ms(lambda: cuda_kernels.smoother_rows(g, aa, ar), reps=5,
                                         warmup=1)
            stats = cuda_kernels.smoother_chunked(g, aa, ar)[1].tolist()[0]
            r[f"{key}warmup"], r[f"{key}rerun_steps"] = stats
            print(f"C at g {tuple(g.shape)}, {case}: chunked {r[f'{key}ms']:.4f} ms, row schedule "
                  f"{r[f'{key}rows_ms']:.4f} ms; W {stats[0]}, L {cuda_kernels.CHUNK}, "
                  f"{math.ceil(g.shape[1] / cuda_kernels.CHUNK)} virtual rows, {stats[1]} steps re-run")
        check(r["worst_ms"] <= 1.2 * r["worst_rows_ms"],
              f"kernel C: the chunked schedule on a row that never meets takes {r['worst_ms']:.3f} ms, "
              f"over 1.2 x the row schedule's {r['worst_rows_ms']:.3f}")
        r["chunk"] = cuda_kernels.CHUNK
        r["virtual_rows"] = math.ceil(len(clip) / cuda_kernels.CHUNK)
        r["plain_ms"] = plain_c_ms
        r["library_ms"] = None
        r.update(zip(("bound_ms", "bound_by"), bound(4.0 * len(clip), 4.0 * (2 * len(clip) + 2))))
        # the chunked design's own floor: each virtual row's dependent chain of
        # W + L steps, at the SM clock the card reports while it is busy
        sm_mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
        r["sm_clock_mhz"] = sm_mhz
        r["chain_floor_ms"] = (r["warmup"] + r["chunk"]) * CHAIN_CYCLES / (sm_mhz * 1e3)
        r["shape"] = (f"g {(1, len(clip))} (go_wc on the whole clip, the serving gain curve; "
                      f"chunked schedule)")
        gb = torch.randn(ct_batch, chunk, generator=gen, device=dev)
        ab = torch.full((ct_batch,), 0.99, device=dev)
        rb = torch.full((ct_batch,), 0.95, device=dev)
        batch_ms = cuda_ms(lambda: cuda_kernels.switched_one_pole_batched(gb, ab, rb), reps=10)
        print(f"C at calc_ct's batch {tuple(gb.shape)}: {batch_ms:.4f} ms")

        def serve():
            pl.predict_long(clip, knobs_nn, model)

        serve_s = cuda_ms(serve, reps=3, warmup=1) / 1e3
        print(f"predict_long: {CLIP_SECONDS / serve_s:.1f} audio-seconds per second "
              f"({serve_s * 1e3:.1f} ms for the {CLIP_SECONDS} s clip, host-to-host)")

        # D and E at the training shapes (the inputs of their check)
        r = results["fused_analysis_bwd"]
        r["ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop), reps=10)
        r["ms_without_dxp"] = cuda_ms(  # what a train step launches: x needs no gradient
            lambda: cuda_frontend.fused_analysis_bwd(txp, w_an, tdmag, tdphs, ft, hop,
                                                     need_dxp=False), reps=10)
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_bwd_reference(txp, w_an, tdmag, tdphs, ft, hop),
            reps=5)
        x_in = (txp * 0.5)[:, None, :]
        dspec_bct = torch.randn(tb, 2 * half, frames, generator=gen, device=dev)
        r["library_ms"] = cuda_ms(  # the linear part only: dspec -> (dxp, dW) by cuDNN
            lambda: (torch.nn.grad.conv1d_input(x_in.shape, w_conv, dspec_bct, stride=hop),
                     torch.nn.grad.conv1d_weight(x_in, w_conv.shape, dspec_bct, stride=hop)),
            reps=5)
        d_flops = 3 * 2.0 * tb * frames * ft * 2 * half
        d_bytes = 4.0 * (2 * tb * tlp + 2 * ft * 2 * half + 2 * frames * tb * half)
        r.update(zip(("bound_ms", "bound_by"), bound(d_flops, d_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(d_flops, d_bytes)[0]
        r["tflops"] = d_flops / r["ms"] / 1e9
        r["tflops_without_dxp"] = d_flops * 2 / 3 / r["ms_without_dxp"] / 1e9
        r["shape"] = f"xp {tuple(txp.shape)}, w {tuple(w_an.shape)}, dmag/dphs {tuple(tdmag.shape)}"

        r = results["fused_synthesis_bwd"]
        r["ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_bwd(tmag, tphs, w_syn, tdout, ft, hop), reps=10)
        r["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_bwd_reference(tmag, tphs, w_syn, tdout, ft, hop),
            reps=5)
        dacc = torch.nn.functional.pad(tdout, (ft, ft))[:, None, :]
        spec_t = torch.randn(tb, 2 * half, out_frames, generator=gen, device=dev)
        r["library_ms"] = cuda_ms(  # the linear part only: dout -> (dspec, dW) by cuDNN
            lambda: (torch.nn.functional.conv1d(dacc, w_tconv, stride=hop),
                     torch.nn.grad.conv1d_weight(dacc, w_tconv.shape, spec_t, stride=hop)),
            reps=5)
        e_flops = 2 * 2.0 * tb * 2 * half * overlap  # the live frame samples only
        e_bytes = 4.0 * (4 * out_frames * tb * half + 2 * 2 * half * ft + tb * out_len)
        r.update(zip(("bound_ms", "bound_by"), bound(e_flops, e_bytes, PEAK_SPLIT_TF32_FLOPS)))
        r["bound_ms_cuda_cores"] = bound(e_flops, e_bytes)[0]
        r["tflops"] = e_flops / r["ms"] / 1e9
        r["shape"] = f"mag/phs {tuple(tmag.shape)}, w {tuple(w_syn.shape)}, dout {tuple(tdout.shape)}"

        # A, B, C once more at the training shapes
        r = results["fused_analysis"]
        r["train_ms"] = cuda_ms(lambda: cuda_frontend.fused_analysis(txp, w_an, ft, hop), reps=20)
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(txp, w_an, ft, hop), reps=10)
        txp_c = txp[:, None, :]
        r["train_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(txp_c, w_conv, stride=hop), reps=10)
        at_flops = 2.0 * tb * frames * ft * 2 * half
        at_bytes = 4.0 * (tb * tlp + ft * 2 * half + 2 * frames * tb * half)
        r["train_bound_ms"] = bound(at_flops, at_bytes, PEAK_SPLIT_TF32_FLOPS)[0]
        r["train_bound_ms_cuda_cores"] = bound(at_flops, at_bytes)[0]
        r["train_tflops"] = at_flops / r["train_ms"] / 1e9
        r["train_shape"] = f"xp {tuple(txp.shape)}"
        r = results["fused_synthesis"]
        r["train_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis(tmag, tphs, w_syn, ft, hop), reps=20)
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_synthesis_reference(tmag, tphs, w_syn, ft, hop), reps=10)
        tspec_bct = torch.cat([tmag * torch.cos(tphs), tmag * torch.sin(tphs)], -1)
        tspec_bct = tspec_bct.permute(1, 2, 0).contiguous()  # (B, 2*half, OT)
        r["train_library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv_transpose1d(tspec_bct, w_tconv, stride=hop), reps=10)
        bt_flops = 2.0 * tb * 2 * half * overlap
        bt_bytes = 4.0 * (2 * out_frames * tb * half + 2 * half * ft + tb * out_len)
        r["train_bound_ms"] = bound(bt_flops, bt_bytes, PEAK_SPLIT_TF32_FLOPS)[0]
        r["train_bound_ms_cuda_cores"] = bound(bt_flops, bt_bytes)[0]
        r["train_tflops"] = bt_flops / r["train_ms"] / 1e9
        r["train_shape"] = f"mag {tuple(tmag.shape)}"
        r = results["switched_one_pole"]
        gt = torch.randn(tb, chunk, generator=gen, device=dev)
        at, rt = torch.full((tb,), 0.99, device=dev), torch.full((tb,), 0.95, device=dev)
        r["train_ms"] = cuda_ms(lambda: cuda_kernels.switched_one_pole_batched(gt, at, rt), reps=10)
        r["train_plain_ms"] = cuda_ms(
            lambda: cuda_kernels.switched_one_pole_reference(gt, at, rt), reps=1, warmup=0)
        r["train_bound_ms"] = bound(4.0 * gt.numel(), 4.0 * (2 * gt.numel() + 2 * tb))[0]
        r["train_chain_floor_ms"] = chunk * CHAIN_CYCLES / (sm_mhz * 1e3)  # one thread a row
        r["train_shape"] = f"g {tuple(gt.shape)} (go_batch in data synthesis; row schedule)"
        r["ct_batch_ms"] = batch_ms
    torch.cuda.synchronize()

    # the train step (forward, loss, backward, clip, Adam) on one fixed batch,
    # the two front-ends in turns, and the data synthesis alone; host clock,
    # the card drained before and after
    training = {"batch": TRAIN_BATCH, "steps": steps, "train_path_s": t_path,
                "val_mae_mean": mean_maes, "loss_first": hist["train_loss"][0],
                "loss_last": hist["train_loss"][-1]}
    opts = {name: train_mod.make_optimizer(m, TRAIN_LR, TRAIN_POINTS, TRAIN_EPOCHS, TRAIN_BATCH)
            for name, m in (("fused", served), ("gemm", gemm))}
    step_ms = {"fused": [], "gemm": []}
    for name in ("fused", "gemm", "gemm", "fused"):
        m, (opt, lr_fn) = (served if name == "fused" else gemm), opts[name]
        step_ms[name].append(host_ms(
            lambda: train_mod.train_step_from_arrays(m, opt, lr_fn, 0, bx, by, bk), reps=20))
    for name, runs in step_ms.items():
        training[f"step_ms_{name}"] = sum(runs) / len(runs)
        training[f"step_ms_{name}_min_max"] = [min(runs), max(runs)]
        training[f"examples_per_s_{name}"] = TRAIN_BATCH / training[f"step_ms_{name}"] * 1e3
    with torch.no_grad():
        training["forward_ms_fused"] = host_ms(lambda: served(bx, bk), reps=20)
    training["forward_backward_ms_fused"] = host_ms(
        lambda: train_mod.loss_and_grads(served, bx, by, bk), reps=20)
    training["data_ms"] = host_ms(
        lambda: batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, 218, 0)), reps=20)
    opt, lr_fn = opts["fused"]
    training["loop_step_ms"] = host_ms(
        lambda: train_mod.train_step_from_arrays(
            served, opt, lr_fn, 0, *batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, 218, 1))),
        reps=20)
    training["loop_examples_per_s"] = TRAIN_BATCH / training["loop_step_ms"] * 1e3
    # the card's own share of each: host time that is not card time is launch work
    gopt, glr_fn = opts["gemm"]
    training["profile"] = {
        "data": card_busy(
            lambda: batch_fn(TRAIN_BATCH, synth_data.step_generator(data_gen, 218, 0)), reps=10),
        "step_fused": card_busy(
            lambda: train_mod.train_step_from_arrays(served, opt, lr_fn, 0, bx, by, bk), reps=10),
        "step_gemm": card_busy(
            lambda: train_mod.train_step_from_arrays(gemm, gopt, glr_fn, 0, bx, by, bk), reps=10),
    }
    print(f"train step at batch {TRAIN_BATCH}, host clock, mean [least, most] of two turns: fused "
          f"{training['step_ms_fused']:.3f} {training['step_ms_fused_min_max']} ms "
          f"({training['examples_per_s_fused']:.0f} examples/s), gemm {training['step_ms_gemm']:.3f} "
          f"{training['step_ms_gemm_min_max']} ms "
          f"({training['examples_per_s_gemm']:.0f} examples/s); fused forward "
          f"{training['forward_ms_fused']:.3f} ms, forward+backward "
          f"{training['forward_backward_ms_fused']:.3f} ms; data synthesis {training['data_ms']:.3f} ms; "
          f"data + step {training['loop_step_ms']:.3f} ms "
          f"({training['loop_examples_per_s']:.0f} examples/s) on {smi}")
    print(json.dumps({"training": training}))

    sources = {
        "fused_analysis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                           "signaltrain_tpu/ops/pallas_frontend.py:286"),
        "fused_synthesis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                            "signaltrain_tpu/ops/pallas_frontend.py:458"),
        "switched_one_pole": ("signaltrain_tpu_torch/csrc/smoother.cu",
                              "signaltrain_tpu/ops/pallas_kernels.py:174"),
        "fused_analysis_bwd": ("signaltrain_tpu_torch/csrc/frontend_bwd.cu",
                               "signaltrain_tpu/ops/pallas_frontend.py:326"),
        "fused_synthesis_bwd": ("signaltrain_tpu_torch/csrc/frontend_bwd.cu",
                                "signaltrain_tpu/ops/pallas_frontend.py:499"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{k: r[k] for k in (
                "launches_serving", "launches_training", "max_phase_err",
                "max_small_bin_phase_err", "max_err_vs_float64", "plain_max_err_vs_float64",
                "max_dx_err", "max_regular_err", "ms_without_dxp", "bound_ms_cuda_cores", "tflops",
                "tflops_without_dxp", "sm_clock_mhz", "chain_floor_ms", "rows_ms", "randn_ms",
                "randn_rows_ms", "worst_ms", "worst_rows_ms", "warmup", "rerun_steps",
                "randn_warmup", "randn_rerun_steps", "worst_warmup", "worst_rerun_steps", "chunk",
                "virtual_rows", "plain_s_all_checks", "ct_batch_ms", "train_ms",
                "train_plain_ms", "train_library_ms", "train_bound_ms", "train_chain_floor_ms",
                "train_bound_ms_cuda_cores", "train_tflops", "train_shape") if k in r},
        })
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        extra = ""
        if "tflops" in r:
            extra = (f"; {r['tflops']:.1f} TFLOP/s of f32-accurate work, bound at the CUDA cores' "
                     f"67 TFLOP/s {r['bound_ms_cuda_cores']:.4f} ms")
        if "chain_floor_ms" in r:
            extra = (f"; the chunked design's chain floor (W {r['warmup']} + L {r['chunk']}) x "
                     f"{CHAIN_CYCLES} cycles at {r['sm_clock_mhz']:.0f} MHz {r['chain_floor_ms']:.4f} "
                     f"ms; row schedule {r['rows_ms']:.4f} ms; randn input {r['randn_ms']:.4f} ms "
                     f"(row schedule {r['randn_rows_ms']:.4f}); never meeting {r['worst_ms']:.4f} "
                     f"ms (row schedule {r['worst_rows_ms']:.4f}); {r['rerun_steps']} steps re-run")
        print(f"{name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}{extra}) on {smi}")
        if "train_ms" in r:
            tlib = f"{r['train_library_ms']:.4f} ms" if "train_library_ms" in r else "n/a"
            ttf = f", {r['train_tflops']:.1f} TFLOP/s" if "train_tflops" in r else ""
            print(f"  at the training shape {r['train_shape']}: {r['train_ms']:.4f} ms (bound "
                  f"{r['train_bound_ms']:.4f} ms, plain {r['train_plain_ms']:.4f} ms, library "
                  f"{tlib}{ttf})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
