"""Time kernels A and D of the PyTorch port on one NVIDIA GPU, and measure
their accuracy against float64.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python -m signaltrain_tpu_torch.cli.time_frontend

A quicker loop than chip_smoke.py while working on csrc/tc_product.cuh: it
builds the kernels, then prints, at the flagship geometry (ft 1024, hop 384,
chunk 8192) and batches 200 and 643:
  * kernel A, its plain version and D (with and without dxp) by CUDA events,
    with the achieved TFLOP/s of f32-accurate work;
  * the device time of every kernel D launches, by name (torch.profiler);
  * the largest magnitude error of kernel A, of its plain version and of
    split_tf32_matmul against a float64 spectrum, and the largest error of
    D's dx (unpadded signal) and dW against a float64 plain version.
"""

from __future__ import annotations

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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    _cuda.build()
    for name in ("frontend", "frontend_bwd"):
        for line in _cuda.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    occ = _cuda.function("frontend", "st_analysis_blocks_per_sm", [])
    print(f"blocks of kernel A's product an SM holds at once: {occ()}")
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
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.self_device_time_total > 0:
                    print(f"    {e.self_device_time_total / e.count / 1e3:.4f} ms x{e.count // 5}"
                          f"  {e.key[:110]}")

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
