"""Time the front-end kernels A, B, D and E of the PyTorch port on one NVIDIA
GPU, and measure their accuracy against float64.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python -m signaltrain_tpu_torch.cli.time_frontend          # A D B E
    python -m signaltrain_tpu_torch.cli.time_frontend B E      # only these

A quicker loop than chip_smoke.py while working on csrc/tc_product.cuh: it
builds the kernels, then prints, at the flagship geometry (ft 1024, hop 384,
chunk 8192, OT 9):
  * A (batches 200 and 643): kernel and plain version by CUDA events, TFLOP/s
    of f32-accurate work; the largest magnitude error of the kernel, of the
    plain version and of split_tf32_matmul against a float64 spectrum;
  * D (batches 200 and 643): with and without dxp, TFLOP/s, the device time of
    every kernel it launches (torch.profiler), and the largest error of dx
    (unpadded signal) and dW against a float64 plain version;
  * B (batches 200 and 643) and E (batch 200, the training shape): kernel and
    plain version, TFLOP/s over the frame samples that reach the trimmed
    output, the device time of every kernel they launch, and the largest
    error of kernel and plain version against a float64 plain version.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from ..ops import _cuda, cuda_frontend as cf, frontend

FT, HOP, CHUNK = 1024, 384, 8192
HALF = FT // 2 + 1


def ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_rows(fn, reps=5):
    """The device time of every kernel fn() launches, by name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            print(f"    {e.self_device_time_total / e.count / 1e3:.4f} ms x{e.count // reps}"
                  f"  {e.key[:110]}")


def synthesis(dev, which):
    """B and E: times, TFLOP/s, per-kernel rows, errors against float64."""
    ot = 9
    with torch.no_grad():
        w = frontend.Synthesis(FT, HOP, device=dev).stacked_weights().contiguous()
    la = (ot - 1) * HOP + FT
    live = sum(max(0, min(t * HOP + FT, la - FT) - max(t * HOP, FT)) for t in range(ot))
    for batch in (200, 643) if "B" in which else (200,):
        g = torch.Generator(device=dev).manual_seed(batch + 1)
        mag = torch.nn.functional.softplus(torch.randn(ot, batch, HALF, generator=g, device=dev))
        phs = torch.randn(ot, batch, HALF, generator=g, device=dev) * 2.0
        dout = torch.randn(batch, (ot - 1) * HOP - FT, generator=g, device=dev)
        flops = 2.0 * batch * 2 * HALF * live
        with torch.inference_mode():
            if "B" in which:
                t_b = ms(lambda: cf.fused_synthesis(mag, phs, w, FT, HOP))
                t_plain = ms(lambda: cf.fused_synthesis_reference(mag, phs, w, FT, HOP), reps=5)
                print(f"batch {batch}: B {t_b:.4f} ms ({flops / t_b / 1e9:.1f} TFLOP/s), plain "
                      f"{t_plain:.4f} ms")
                kernel_rows(lambda: cf.fused_synthesis(mag, phs, w, FT, HOP))
                x = cf.fused_synthesis_reference(mag.double(), phs.double(), w.double(), FT, HOP)
                print(f"    B against float64: kernel "
                      f"{float((cf.fused_synthesis(mag, phs, w, FT, HOP) - x).abs().max()):.3e}, "
                      f"plain {float((cf.fused_synthesis_reference(mag, phs, w, FT, HOP) - x).abs().max()):.3e}"
                      f" (max|wave| {float(x.abs().max()):.3f})")
            if "E" in which and batch == 200:
                t_e = ms(lambda: cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP))
                t_plain = ms(lambda: cf.fused_synthesis_bwd_reference(mag, phs, w, dout, FT, HOP),
                             reps=5)
                print(f"batch {batch}: E {t_e:.4f} ms ({2 * flops / t_e / 1e9:.1f} TFLOP/s), "
                      f"plain {t_plain:.4f} ms")
                kernel_rows(lambda: cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP))
                got = cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP)
                plain = cf.fused_synthesis_bwd_reference(mag, phs, w, dout, FT, HOP)
                exact = cf.fused_synthesis_bwd_reference(mag.double(), phs.double(), w.double(),
                                                         dout.double(), FT, HOP)
                print("    E against float64: " + "; ".join(
                    f"{name} kernel {float((k - x).abs().max()):.3e} plain "
                    f"{float((p - x).abs().max()):.3e} (max {float(x.abs().max()):.3e})"
                    for name, k, p, x in zip(("dmag", "dphs", "dW"), got, plain, exact)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernels", nargs="*", default=["A", "D", "B", "E"],
                        choices=["A", "B", "D", "E"], help="which kernels to time")
    which = set(parser.parse_args().kernels)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    _cuda.build()
    for name in ("frontend", "frontend_bwd"):
        for line in _cuda.build_report(name):
            print(f"  ptxas[{name}]: {line}")
    occ = _cuda.function("frontend", "st_analysis_blocks_per_sm", [])
    print(f"blocks of kernel A's product an SM holds at once: {occ()}")
    if which & {"B", "E"}:
        synthesis(dev, which)
    if not which & {"A", "D"}:
        return
    with torch.no_grad():
        w = frontend.Analysis(FT, HOP, device=dev).stacked_weights().contiguous()
    for batch in (200, 643):
        g = torch.Generator(device=dev).manual_seed(batch)
        xp = torch.nn.functional.pad(torch.randn(batch, CHUNK, generator=g, device=dev) * 0.3,
                                     (FT, FT))
        frames = (xp.shape[1] - FT) // HOP + 1
        dmag = torch.randn(frames, batch, HALF, generator=g, device=dev) * (64.0 / FT)
        dphs = torch.randn(frames, batch, HALF, generator=g, device=dev) * (64.0 / FT)
        flops = 2.0 * batch * frames * FT * 2 * HALF
        with torch.inference_mode():
            t_a = ms(lambda: cf.fused_analysis(xp, w, FT, HOP))
            t_plain = ms(lambda: cf.fused_analysis_reference(xp, w, FT, HOP), reps=5)
            t_d = ms(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP))
            t_dw = ms(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, need_dxp=False))
            print(f"batch {batch}: A {t_a:.4f} ms ({flops / t_a / 1e9:.1f} TFLOP/s), plain "
                  f"{t_plain:.4f} ms; D {t_d:.4f} ms ({3 * flops / t_d / 1e9:.1f} TFLOP/s), "
                  f"without dxp {t_dw:.4f} ms ({2 * flops / t_dw / 1e9:.1f} TFLOP/s)")
            if "D" in which:
                kernel_rows(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP))

            mag = cf.fused_analysis(xp, w, FT, HOP)[0]
            rmag = cf.fused_analysis_reference(xp, w, FT, HOP)[0]
            fr = xp.unfold(1, FT, HOP).transpose(0, 1) * 0.5
            spec64 = fr.double() @ w.double()
            mag64 = torch.sqrt(spec64[..., :HALF] ** 2 + spec64[..., HALF:] ** 2).clamp_min(1e-18)
            emu = cf.split_tf32_matmul(fr.reshape(-1, FT), w).reshape(spec64.shape)
            emag = cf.mag_phs(emu[..., :HALF], emu[..., HALF:])[0]
            print(f"    max magnitude error against float64: kernel "
                  f"{float((mag - mag64).abs().max()):.3e}, plain "
                  f"{float((rmag - mag64).abs().max()):.3e}, split_tf32_matmul "
                  f"{float((emag - mag64).abs().max()):.3e}; max |mag| {float(mag64.max()):.2f}")
            dxp, dw = cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP)
            rdxp, rdw = cf.fused_analysis_bwd_reference(xp, w, dmag, dphs, FT, HOP)
            xdxp, xdw = cf.fused_analysis_bwd_reference(xp.double(), w.double(), dmag.double(),
                                                        dphs.double(), FT, HOP)
            sl = slice(FT, -FT)
            print(f"    D, unit-normal cotangents, against float64: dx kernel "
                  f"{float((dxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} plain "
                  f"{float((rdxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} (max|dx| "
                  f"{float(xdxp[:, sl].abs().max()):.3e}); dW kernel "
                  f"{float((dw - xdw).abs().max()):.3e} plain {float((rdw - xdw).abs().max()):.3e} "
                  f"(max|dW| {float(xdw.abs().max()):.3e})")


if __name__ == "__main__":
    main()
