#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi); the kernels built from
     signaltrain_tpu_torch/csrc/*.cu, one nvcc per source, all at once;
  2. each kernel held against its plain PyTorch version on the card, at the
     shapes the main path gives it, on seeded random inputs (the conditions
     of the JAX package's own kernel tests), with the tolerance stated;
  3. the main path, with every kernel counter set to 0 just before it and
     read just after: demo/model_comp4c_demo.tar loaded onto the card, a
     seeded 30 s music-like clip through predict_long at the comp_4c knobs
     [-25, 4, 0.005, 0.02], and the comp_4c target by Compressor_4c.go_wc
     and calc_ct. Every kernel must have launched and no plain version run;
     the prediction must be finite, of the expected length, correlate >= 0.98
     with the target (the floor of tests/test_shipped_model_quality.py) and
     agree with the plain CPU path on a short clip (atol 1e-3);
  4. timing with CUDA events: each kernel, its plain version and the one
     PyTorch library call nearest to it, beside the bound computed from this
     run's shapes (f32 CUDA-core peak 67 TFLOP/s, HBM 3.35 TB/s: the H100 SXM
     data-sheet rates at 700 W), and predict_long's audio-seconds per second.
The last two lines are the kernels JSON line and the result line.

Exits non-zero with no result when torch.cuda.is_available() is false, or
when it is not next to the signaltrain_tpu_torch package it drives.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def disagreement(name: str, got: torch.Tensor, want: torch.Tensor) -> str:
    """The failure message of a kernel check: where the worst error sits."""
    idx = np.unravel_index(int(torch.argmax((got - want).abs())), tuple(got.shape))
    return (f"kernel {name} disagrees with its plain version: worst at {tuple(map(int, idx))}, "
            f"kernel {got[idx].item()!r} plain {want[idx].item()!r}")


def wrapped_phase_excess(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    """Largest wrapped phase difference, and its excess over atol + rtol*|want|
    (a 1-ulp change of im at the branch cut moves atan2 by 2 pi)."""
    d = (got.double() - want.double() + np.pi).remainder(2 * np.pi) - np.pi
    excess = d.abs() - (atol + rtol * want.double().abs())
    return float(d.abs().max()), float(excess.max())


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script drives the port on a CUDA card")
    if not (HERE / "signaltrain_tpu_torch" / "__init__.py").is_file() or not CKPT.is_file():
        fail(f"run from a checkout of the repository: {HERE} lacks the package or {CKPT.name}")
    sys.path.insert(0, str(HERE))

    from signaltrain_tpu_torch.dsp import effects, synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, cuda_kernels
    from signaltrain_tpu_torch.utils.load_model import load_model

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built) or 'nothing (cached)'}"
          f" {json.dumps({k: round(v, 2) for k, v in built.items()})}")
    for name in _cuda.sources():
        for line in _cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

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

    # ---- 2. kernels against their plain versions, on the card
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    with torch.inference_mode():
        xp = torch.nn.functional.pad(
            torch.randn(n_windows, chunk, generator=gen, device=dev) * 0.3, (ft, ft))
        mag, phs = cuda_frontend.fused_analysis(xp, w_an, ft, hop)
        rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop)
        torch.cuda.synchronize()
        check(mag.shape == (frames, n_windows, half), f"analysis shape {tuple(mag.shape)}")
        mag_err = float((mag - rmag).abs().max())
        mag_excess = float(((mag - rmag).abs() - (2e-5 + 2e-5 * rmag.abs())).max())
        phs_err, phs_excess = wrapped_phase_excess(phs, rphs, 2e-4, 2e-4)
        print(f"A fused_analysis xp {tuple(xp.shape)}: max|dmag| {mag_err:.3e} "
              f"max|dphs| (wrapped) {phs_err:.3e}; tolerance mag 2e-5+2e-5|mag|, phase 2e-4+2e-4|phs|")
        check(mag_excess <= 0, disagreement("A (magnitude)", mag, rmag))
        check(phs_excess <= 0, disagreement("A (phase)", phs, rphs))
        check(bool(torch.all(mag[0] == np.float32(1e-18))) and bool(torch.all(phs[0] == 0)),
              "kernel A: an edge frame is not exactly (1e-18, 0)")
        results["fused_analysis"] = dict(max_abs_err=mag_err, max_phase_err=phs_err,
                                         tolerance="mag 2e-5 + 2e-5*|mag|; wrapped phase 2e-4 + 2e-4*|phs|")

        smag = torch.nn.functional.softplus(
            torch.randn(out_frames, n_windows, half, generator=gen, device=dev))
        sphs = torch.randn(out_frames, n_windows, half, generator=gen, device=dev) * 2.0
        wave = cuda_frontend.fused_synthesis(smag, sphs, w_syn, ft, hop)
        rwave = cuda_frontend.fused_synthesis_reference(smag, sphs, w_syn, ft, hop)
        torch.cuda.synchronize()
        check(wave.shape == (n_windows, out_len), f"synthesis shape {tuple(wave.shape)}")
        syn_err = float((wave - rwave).abs().max())
        syn_excess = float(((wave - rwave).abs() - (3e-4 + 3e-4 * rwave.abs())).max())
        print(f"B fused_synthesis mag {tuple(smag.shape)}: max|dwave| {syn_err:.3e}; "
              f"tolerance 3e-4+3e-4|wave|")
        check(syn_excess <= 0, disagreement("B", wave, rwave))
        results["fused_synthesis"] = dict(max_abs_err=syn_err, tolerance="3e-4 + 3e-4*|wave|")

        smooth_shapes = [(1, len(clip)), (1, chunk), (ct_batch, chunk)]
        smooth_err, plain_c_ms = 0.0, None
        for b, n in smooth_shapes:
            g = torch.randn(b, n, generator=gen, device=dev)
            aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=gen)
            s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            rs = cuda_kernels.switched_one_pole_reference(g, aa, ar)
            ev1.record()
            ev1.synchronize()
            if (b, n) == smooth_shapes[0]:
                plain_c_ms = ev0.elapsed_time(ev1)
            err = float((s - rs).abs().max())
            smooth_err = max(smooth_err, err)
            print(f"C switched_one_pole g {(b, n)}: max|ds| {err:.3e}; tolerance 1e-6 "
                  f"(plain version {time.perf_counter() - t_start:.1f} s)")
            check(err <= 1e-6 and bool(torch.all(s[:, 0] == 0)), disagreement("C", s, rs))
        results["switched_one_pole"] = dict(max_abs_err=smooth_err, tolerance="1e-6")
    torch.cuda.synchronize()

    # ---- 3. the main path, counted
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
    print(f"main path {t_path:.2f} s; launches / plain calls: {json.dumps(counts)}")
    for name in ("fused_analysis", "fused_synthesis", "switched_one_pole"):
        check(counts[name][0] > 0, f"main path never launched kernel {name}")
        check(counts[name][1] == 0, f"main path ran the plain version of {name}")
        results[name]["launches"] = counts[name][0]

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

    # ---- 4. timing at the main path's shapes
    with torch.inference_mode():
        results["fused_analysis"]["ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis(xp, w_an, ft, hop), reps=20)
        results["fused_analysis"]["plain_ms"] = cuda_ms(
            lambda: cuda_frontend.fused_analysis_reference(xp, w_an, ft, hop), reps=10)
        w_conv = w_an.t().contiguous()[:, None, :]  # (2*half, 1, ft)
        results["fused_analysis"]["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.conv1d(xp[:, None, :], w_conv, stride=hop), reps=10)
        results["fused_analysis"].update(zip(("bound_ms", "bound_by"), bound(
            2.0 * n_windows * frames * ft * 2 * half,
            4.0 * (n_windows * lp + ft * 2 * half + 2 * frames * n_windows * half))))
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
        results["fused_synthesis"].update(zip(("bound_ms", "bound_by"), bound(
            2.0 * n_windows * 2 * half * overlap,
            4.0 * (2 * out_frames * n_windows * half + 2 * half * ft + n_windows * out_len))))
        results["fused_synthesis"]["shape"] = f"mag {tuple(smag.shape)}, w {tuple(w_syn.shape)}"

        g = torch.randn(1, len(clip), generator=gen, device=dev)
        aa = torch.full((1,), 0.99, device=dev)
        ar = torch.full((1,), 0.95, device=dev)
        results["switched_one_pole"]["ms"] = cuda_ms(
            lambda: cuda_kernels.switched_one_pole_batched(g, aa, ar), reps=5, warmup=1)
        results["switched_one_pole"]["plain_ms"] = plain_c_ms
        results["switched_one_pole"]["library_ms"] = None
        results["switched_one_pole"].update(zip(("bound_ms", "bound_by"), bound(
            4.0 * g.numel(), 4.0 * (2 * g.numel() + 2))))
        results["switched_one_pole"]["shape"] = f"g {tuple(g.shape)} (go_wc on the whole clip)"
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
    torch.cuda.synchronize()

    sources = {
        "fused_analysis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                           "signaltrain_tpu/ops/pallas_frontend.py:286"),
        "fused_synthesis": ("signaltrain_tpu_torch/csrc/frontend.cu",
                            "signaltrain_tpu/ops/pallas_frontend.py:458"),
        "switched_one_pole": ("signaltrain_tpu_torch/csrc/smoother.cu",
                              "signaltrain_tpu/ops/pallas_kernels.py:174"),
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
            **({"max_phase_err": r["max_phase_err"]} if "max_phase_err" in r else {}),
        })
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}) on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
