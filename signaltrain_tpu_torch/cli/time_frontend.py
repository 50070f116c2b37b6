"""Time the front-end kernels A, B, D and E of the PyTorch port on one NVIDIA
GPU, and measure their accuracy against float64.

Run from the root of a checkout on a machine with a CUDA card and nvcc:

    python -m signaltrain_tpu_torch.cli.time_frontend          # A D B E
    python -m signaltrain_tpu_torch.cli.time_frontend B E      # only these
    python -m signaltrain_tpu_torch.cli.time_frontend --dtype bfloat16   # the bf16 modes

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
Beside each kernel it times the cuBLAS products that the gemm front-end
(``ops/frontend.py``: ``gemm``, ``Bf16Gemm``) runs for the same linear part
at the same shapes and dtype (``cublas_*`` below): A's framed signal times
the stacked (ft, 2 * half) matrix, B's frame product before its overlap-add,
D's and E's two backward products. They compute the linear part only (no
magnitude and phase, no trigonometry, overlap-add or trim), so they say how
fast the library does the products a kernel fuses, not the kernel's whole
function.
``--dtype bfloat16`` times the kernels' bf16 modes instead; "float64" is then
the float64 plain version of the same bf16-rounded computation, and TFLOP/s
count the bf16 products. It then also takes D's error under unit-normal
cotangents apart on the bins of least magnitude (``near_zero_bins``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from ..ops import _cuda, cuda_frontend as cf, framing, frontend

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


def cublas_analysis(xp: torch.Tensor, w: torch.Tensor, ft: int, hop: int, dtype):
    """A's linear part as the gemm front-end runs it: the frames of the
    padded signal (a view) times the stacked (ft, 2 * half) matrix, through
    ``frontend.gemm`` (bf16: ``Bf16Gemm``, its operands rounded). A callable."""
    frames = xp.unfold(1, ft, hop)
    return lambda: frontend.gemm(frames, w, dtype)


def synthesis_spectrum(mag: torch.Tensor, phs: torch.Tensor) -> torch.Tensor:
    """Frame-major (OT, B, half) magnitude and phase -> the batch-major (B,
    OT, 2 * half) [re | im] that the gemm synthesis multiplies."""
    return torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], -1).transpose(0, 1).contiguous()


def cublas_synthesis(spec: torch.Tensor, w: torch.Tensor, dtype):
    """B's linear part as the gemm front-end runs it: the frame product
    (B, OT, 2 * half) x (2 * half, ft) before its overlap-add. A callable."""
    return lambda: frontend.gemm(spec, w, dtype)


def cublas_backward(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, dtype):
    """The two products of ``frontend.gemm``'s backward for a (M, K) @ b (K,
    N) under the cotangent g (M, N): g b^T and a^T g, in float32 as autograd
    takes them, in bf16 as ``Bf16Gemm.backward`` does (the residuals already
    bf16, the cotangent rounded, float32 results). D's are the frames, the
    analysis matrix and dspec; E's the spectrum, the synthesis matrix and the
    frames of the padded dout. A callable."""
    if dtype == torch.bfloat16:
        ac, bc = a.to(torch.bfloat16), b.to(torch.bfloat16)

        def run():
            gc = g.to(torch.bfloat16)
            return frontend._mm(gc, bc.t()), frontend._mm(ac.t(), gc)

        return run
    return lambda: (g @ b.t(), a.t() @ g)


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


def synthesis(dev, which, dt):
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
                t_b = ms(lambda: cf.fused_synthesis(mag, phs, w, FT, HOP, dt))
                t_plain = ms(lambda: cf.fused_synthesis_reference(mag, phs, w, FT, HOP, dt), reps=5)
                t_lib = ms(cublas_synthesis(synthesis_spectrum(mag, phs), w, dt))
                print(f"batch {batch}: B {t_b:.4f} ms ({flops / t_b / 1e9:.1f} TFLOP/s), plain "
                      f"{t_plain:.4f} ms, cuBLAS frame product {t_lib:.4f} ms")
                kernel_rows(lambda: cf.fused_synthesis(mag, phs, w, FT, HOP, dt))
                x = cf.fused_synthesis_reference(mag.double(), phs.double(), w.double(), FT, HOP, dt)
                print(f"    B against float64: kernel "
                      f"{float((cf.fused_synthesis(mag, phs, w, FT, HOP, dt) - x).abs().max()):.3e}, "
                      f"plain {float((cf.fused_synthesis_reference(mag, phs, w, FT, HOP, dt) - x).abs().max()):.3e}"
                      f" (max|wave| {float(x.abs().max()):.3f})")
            if "E" in which and batch == 200:
                t_e = ms(lambda: cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP, compute_dtype=dt))
                t_plain = ms(lambda: cf.fused_synthesis_bwd_reference(mag, phs, w, dout, FT, HOP, dt),
                             reps=5)
                spec = synthesis_spectrum(mag, phs).reshape(-1, 2 * HALF)
                dframes = torch.nn.functional.pad(dout, (FT, FT)).unfold(1, FT, HOP)
                t_lib = ms(cublas_backward(spec, w, dframes.reshape(-1, FT), dt))
                print(f"batch {batch}: E {t_e:.4f} ms ({2 * flops / t_e / 1e9:.1f} TFLOP/s), "
                      f"plain {t_plain:.4f} ms, cuBLAS backward products {t_lib:.4f} ms")
                kernel_rows(lambda: cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP, compute_dtype=dt))
                got = cf.fused_synthesis_bwd(mag, phs, w, dout, FT, HOP, compute_dtype=dt)
                plain = cf.fused_synthesis_bwd_reference(mag, phs, w, dout, FT, HOP, dt)
                exact = cf.fused_synthesis_bwd_reference(mag.double(), phs.double(), w.double(),
                                                         dout.double(), FT, HOP, dt)
                print("    E against float64: " + "; ".join(
                    f"{name} kernel {float((k - x).abs().max()):.3e} plain "
                    f"{float((p - x).abs().max()):.3e} (max {float(x.abs().max()):.3e})"
                    for name, k, p, x in zip(("dmag", "dphs", "dW"), got, plain, exact)))


def near_zero_bins(xp, w, dmag, dphs, errors, n=32):
    """D's bf16 mode under unit-normal cotangents, against float64, on the n
    bins of least nonzero magnitude, where dspec ~ dphs / |spec|^2 turns the
    float32 error of the recomputed spectrum into a large relative error.
    Prints, for the kernel and for the plain version: each one's dspec on
    those bins (read back exactly by running it with the cotangent of that
    bin alone: dW's column is then frame * dspec, a product of two bf16
    values, exact in float32) in bf16 ulps from the float64 version's; the
    part of the dx and dW errors those bins make (their dspec offsets pushed
    through the float64 products); what is left of the error without them;
    and the errors again with the cotangents of those bins set to 0.
    ``errors``: the full run's (dx kernel, dx plain, dW kernel, dW plain)
    differences from float64 (dx on the unpadded signal)."""
    bf = torch.bfloat16
    half = HALF
    frames = cf.round_operand(framing.frame_signal(xp.double(), FT, HOP, pad=0) * 0.5, bf)
    frames = frames.transpose(0, 1)  # (T, B, ft)
    w64 = cf.round_operand(w.double(), bf)
    spec = frames @ w64
    r = torch.sqrt(spec[..., :half] ** 2 + spec[..., half:] ** 2)
    r = torch.where(r > 0, r, torch.full_like(r, float("inf")))  # all-padding frames are exact
    idx = torch.topk(r.flatten(), n, largest=False).indices
    bins = [tuple(int(v) for v in torch.unravel_index(i, r.shape)) for i in idx]
    dx_k, dx_p, dw_k, dw_p = errors
    sl = slice(FT, -FT)
    impls = {"kernel": lambda *a: cf.fused_analysis_bwd(*a, FT, HOP, compute_dtype=bf)[1],
             "plain": lambda *a: cf.fused_analysis_bwd_reference(*a, FT, HOP, bf)[1],
             "float64": lambda *a: cf.fused_analysis_bwd_reference(
                 *(t.double() for t in a), FT, HOP, bf)[1]}
    dspec = {name: [] for name in impls}
    for t, b, j in bins:
        one_m, one_p = torch.zeros_like(dmag), torch.zeros_like(dphs)
        one_m[t, b, j], one_p[t, b, j] = dmag[t, b, j], dphs[t, b, j]
        k = int(frames[t, b].abs().argmax())
        for name, fn in impls.items():
            col = fn(xp, w, one_m, one_p)[k]
            dspec[name].append(torch.stack([col[j], col[half + j]]).double() / frames[t, b, k])
    x = torch.stack(dspec["float64"])
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)
    print(f"    D's {n} bins of least magnitude ({float(r.flatten()[idx[0]]):.2e} to "
          f"{float(r.flatten()[idx[-1]]):.2e}; max|dspec| {float(x.abs().max()):.3e}):")
    for name, (e_dx, e_dw) in (("kernel", (dx_k, dw_k)), ("plain", (dx_p, dw_p))):
        off = torch.stack(dspec[name]) - x
        pred_dx = torch.zeros(xp.shape, dtype=torch.float64, device=xp.device)
        pred_dw = torch.zeros(FT, 2 * half, dtype=torch.float64, device=xp.device)
        for (t, b, j), (d_re, d_im) in zip(bins, off):
            pred_dx[b, t * HOP: t * HOP + FT] += 0.5 * (d_re * w64[:, j] + d_im * w64[:, half + j])
            pred_dw[:, j] += frames[t, b] * d_re
            pred_dw[:, half + j] += frames[t, b] * d_im
        ulps = (off / ulp).abs().amax(1)
        print(f"      {name}: dspec off float64's on {int((ulps > 0).sum())} of them, by up to "
              f"{float(ulps.max()):.1f} bf16 ulps (median {float(ulps.median()):.1f}); "
              f"the part they make of the error: dx {float(pred_dx[:, sl].abs().max()):.3e} of "
              f"{float(e_dx.abs().max()):.3e} (left without it "
              f"{float((e_dx - pred_dx[:, sl]).abs().max()):.3e}), dW "
              f"{float(pred_dw.abs().max()):.3e} of {float(e_dw.abs().max()):.3e} (left "
              f"{float((e_dw - pred_dw).abs().max()):.3e})")
    zm, zp = dmag.clone(), dphs.clone()
    for t, b, j in bins:
        zm[t, b, j] = zp[t, b, j] = 0
    got = cf.fused_analysis_bwd(xp, w, zm, zp, FT, HOP, compute_dtype=bf)
    plain = cf.fused_analysis_bwd_reference(xp, w, zm, zp, FT, HOP, bf)
    exact = cf.fused_analysis_bwd_reference(xp.double(), w.double(), zm.double(), zp.double(),
                                            FT, HOP, bf)
    print(f"      with their cotangents 0: dx kernel "
          f"{float((got[0][:, sl] - exact[0][:, sl]).abs().max()):.3e} plain "
          f"{float((plain[0][:, sl] - exact[0][:, sl]).abs().max()):.3e}; dW kernel "
          f"{float((got[1] - exact[1]).abs().max()):.3e} plain "
          f"{float((plain[1] - exact[1]).abs().max()):.3e}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernels", nargs="*", choices=["A", "B", "D", "E"],
                        help="which kernels to time (default: all four)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="the kernels' compute dtype")
    args = parser.parse_args()
    which, dt = set(args.kernels or "ADBE"), getattr(torch, args.dtype)
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
    occ = _cuda.function("frontend", "st_analysis_blocks_per_sm", [ctypes.c_int])
    print(f"compute dtype {args.dtype}; blocks of kernel A's product an SM holds at once: "
          f"{occ(int(dt == torch.bfloat16))}")
    if which & {"B", "E"}:
        synthesis(dev, which, dt)
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
            t_a = ms(lambda: cf.fused_analysis(xp, w, FT, HOP, dt))
            t_plain = ms(lambda: cf.fused_analysis_reference(xp, w, FT, HOP, dt), reps=5)
            t_d = ms(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, compute_dtype=dt))
            t_dw = ms(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, need_dxp=False,
                                                    compute_dtype=dt))
            t_lib_a = ms(cublas_analysis(xp, w, FT, HOP, dt))
            dspec = torch.randn(batch * frames, 2 * HALF, generator=g, device=dev)
            t_lib_d = ms(cublas_backward(xp.unfold(1, FT, HOP).reshape(-1, FT), w, dspec, dt))
            print(f"batch {batch}: A {t_a:.4f} ms ({flops / t_a / 1e9:.1f} TFLOP/s), plain "
                  f"{t_plain:.4f} ms, cuBLAS product {t_lib_a:.4f} ms; D {t_d:.4f} ms "
                  f"({3 * flops / t_d / 1e9:.1f} TFLOP/s), without dxp {t_dw:.4f} ms "
                  f"({2 * flops / t_dw / 1e9:.1f} TFLOP/s), cuBLAS backward products "
                  f"{t_lib_d:.4f} ms")
            if "D" in which:
                kernel_rows(lambda: cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP,
                                                          compute_dtype=dt))

            mag = cf.fused_analysis(xp, w, FT, HOP, dt)[0]
            rmag = cf.fused_analysis_reference(xp, w, FT, HOP, dt)[0]
            mag64 = cf.fused_analysis_reference(xp.double(), w.double(), FT, HOP, dt)[0]
            line = (f"    max magnitude error against float64: kernel "
                    f"{float((mag - mag64).abs().max()):.3e}, plain "
                    f"{float((rmag - mag64).abs().max()):.3e}")
            if dt == torch.float32:
                fr = xp.unfold(1, FT, HOP).transpose(0, 1) * 0.5
                emu = cf.split_tf32_matmul(fr.reshape(-1, FT), w).reshape(*fr.shape[:2], -1)
                emag = cf.mag_phs(emu[..., :HALF], emu[..., HALF:])[0]
                line += f", split_tf32_matmul {float((emag - mag64).abs().max()):.3e}"
            print(f"{line}; max |mag| {float(mag64.max()):.2f}")
            dxp, dw = cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, compute_dtype=dt)
            rdxp, rdw = cf.fused_analysis_bwd_reference(xp, w, dmag, dphs, FT, HOP, dt)
            xdxp, xdw = cf.fused_analysis_bwd_reference(xp.double(), w.double(), dmag.double(),
                                                        dphs.double(), FT, HOP, dt)
            sl = slice(FT, -FT)
            if dt == torch.bfloat16:
                near_zero_bins(xp, w, dmag, dphs, (
                    dxp[:, sl].double() - xdxp[:, sl], rdxp[:, sl].double() - xdxp[:, sl],
                    dw.double() - xdw, rdw.double() - xdw))
            print(f"    D, unit-normal cotangents, against float64: dx kernel "
                  f"{float((dxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} plain "
                  f"{float((rdxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} (max|dx| "
                  f"{float(xdxp[:, sl].abs().max()):.3e}); dW kernel "
                  f"{float((dw - xdw).abs().max()):.3e} plain {float((rdw - xdw).abs().max()):.3e} "
                  f"(max|dW| {float(xdw.abs().max()):.3e})")


if __name__ == "__main__":
    main()
