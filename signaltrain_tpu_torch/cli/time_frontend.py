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
count the bf16 products. It then also splits D's error under unit-normal
cotangents on each schedule by product (``d_error_split``) and reads how far
the spectrum D forms again lies from float64 (``spectrum_error``).

In either dtype it first splits A and B (batches 200 and 643), D (with and
without dxp) and E (batch 200) by pass on each schedule, the wgmma one of
``csrc/wgmma_product.cuh`` and the mma.sync one of ``csrc/tc_product.cuh``
(``schedule_splits`` with ``pass_split``): the median and spread over
``SPLIT_REPS`` calls of every kernel
the call launches (pack, pad or halve, the spectrum rows, each product, the
adjoint pass, the slice sums, the overlap-add), their sum (the card's time a
call), the call's own time by CUDA events (which also holds the host's launch
work whenever the card waits for it), and the call replayed from a CUDA graph
(the card's time with no host work in between, as training runs it); then
beside each call the cuBLAS products of the same linear part:

    python -m signaltrain_tpu_torch.cli.time_frontend A B --dtype bfloat16
    python -m signaltrain_tpu_torch.cli.time_frontend A D --split-only

The script imports the package by its name, so that with another checkout's
root on PYTHONPATH, ``python signaltrain_tpu_torch/cli/time_frontend.py A D
--split-only --schedules mma`` splits that checkout's kernels the same way
(before and after a change: one process a tree, in turns).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch

from signaltrain_tpu_torch.ops import _cuda, cuda_frontend as cf, framing, frontend

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


def cublas_dw(a: torch.Tensor, g: torch.Tensor, dtype):
    """The dW product of ``cublas_backward`` alone (a^T g): what D without
    dxp computes of its linear part. A callable."""
    if dtype == torch.bfloat16:
        ac = a.to(torch.bfloat16)
        return lambda: frontend._mm(ac.t(), g.to(torch.bfloat16))
    return lambda: a.t() @ g


SPLIT_REPS = 20


def _median(v):
    v = sorted(v)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def pass_name(key: str) -> str:
    """A short name of a kernel from the profiler's demangled one."""
    name = re.sub(r"\(anonymous namespace\)::|void |tc::|wg::", "", key).split("(")[0]
    return re.sub(r"<__nv_bfloat16>|, \d+>", lambda m: ">" if m.group().startswith(",") else "",
                  name)


def graph_ms(fn, reps=SPLIT_REPS):
    """Milliseconds of one replay of fn() captured as a CUDA graph: the
    card's time a call with no host work between its kernels."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return ms(g.replay, reps)


def pass_split(fn, reps=SPLIT_REPS) -> dict:
    """fn() split by pass: each kernel it launches (in launch order) with the
    median, least and most of its device time over reps calls
    (torch.profiler), their sum, the call's own time by CUDA events (median,
    least, most of reps single calls) and one graph replay's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    calls = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        calls.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_card = torch.autograd.DeviceType.CUDA
    runs = {}  # kernel name -> its times, in the order the kernels first ran
    for e in prof.events():
        if e.device_type == on_card:
            runs.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    passes = [(pass_name(k), _median(v), min(v), max(v)) for k, v in runs.items()]
    return {"passes": passes, "device_ms": sum(p[1] for p in passes),
            "call_ms": (_median(calls), min(calls), max(calls)), "graph_ms": graph_ms(fn)}


def print_split(title: str, split: dict) -> None:
    c = split["call_ms"]
    print(f"  {title}: a call {c[0]:.4f} ms [{c[1]:.4f}, {c[2]:.4f}] (median [least, most] of "
          f"{SPLIT_REPS}); one graph replay {split['graph_ms']:.4f} ms; the card's kernels "
          f"{split['device_ms']:.4f} ms in {len(split['passes'])}:")
    for name, med, lo, hi in split["passes"]:
        print(f"    {med:.4f} ms [{lo:.4f}, {hi:.4f}]  {name[:100]}")


def split_inputs(dev, batch: int, ot: int = 9) -> dict:
    """Seeded inputs of A, B, D and E at the flagship geometry and ``batch``."""
    g = torch.Generator(device=dev).manual_seed(batch)
    xp = torch.nn.functional.pad(torch.randn(batch, CHUNK, generator=g, device=dev) * 0.3, (FT, FT))
    frames = (xp.shape[1] - FT) // HOP + 1
    return dict(
        xp=xp, dmag=torch.randn(frames, batch, HALF, generator=g, device=dev) * (64.0 / FT),
        dphs=torch.randn(frames, batch, HALF, generator=g, device=dev) * (64.0 / FT),
        mag=torch.nn.functional.softplus(torch.randn(ot, batch, HALF, generator=g, device=dev)),
        phs=torch.randn(ot, batch, HALF, generator=g, device=dev) * 2.0,
        dout=torch.randn(batch, (ot - 1) * HOP - FT, generator=g, device=dev))


def schedule_splits(dev, which, dt=torch.bfloat16, schedules=cf.SCHEDULES) -> None:
    """A and B at batches 200 and 643, D (with and without dxp) and E at
    batch 200, flagship geometry, in the compute dtype ``dt``, split by pass
    on each of ``schedules``, then each call's time beside the cuBLAS
    products of its linear part (``cublas_*``; D without dxp beside the dW
    product alone, ``cublas_dw``)."""
    with torch.no_grad():
        wa = frontend.Analysis(FT, HOP, device=dev).stacked_weights().contiguous()
        ws = frontend.Synthesis(FT, HOP, device=dev).stacked_weights().contiguous()
    both = tuple(schedules)
    calls = []  # (title, fn(schedule), its schedules, the cuBLAS products)
    for batch in (200, 643):
        x = split_inputs(dev, batch)
        if "A" in which:
            calls.append((f"A, batch {batch}", lambda s, x=x: cf.fused_analysis(
                x["xp"], wa, FT, HOP, dt, schedule=s), both,
                cublas_analysis(x["xp"], wa, FT, HOP, dt)))
        if "B" in which:
            calls.append((f"B, batch {batch}", lambda s, x=x: cf.fused_synthesis(
                x["mag"], x["phs"], ws, FT, HOP, dt, schedule=s), both,
                cublas_synthesis(synthesis_spectrum(x["mag"], x["phs"]), ws, dt)))
        if batch != 200:
            continue
        if "D" in which:
            frames = x["xp"].unfold(1, FT, HOP).reshape(-1, FT)
            g = torch.Generator(device=dev).manual_seed(batch + 2)
            dspec = torch.randn(frames.shape[0], 2 * HALF, generator=g, device=dev)
            calls.append(("D, batch 200", lambda s, x=x: cf.fused_analysis_bwd(
                x["xp"], wa, x["dmag"], x["dphs"], FT, HOP, compute_dtype=dt, schedule=s), both,
                cublas_backward(frames, wa, dspec, dt)))
            calls.append(("D without dxp, batch 200", lambda s, x=x: cf.fused_analysis_bwd(
                x["xp"], wa, x["dmag"], x["dphs"], FT, HOP, need_dxp=False, compute_dtype=dt,
                schedule=s), both, cublas_dw(frames, dspec, dt)))
        if "E" in which:
            spec = synthesis_spectrum(x["mag"], x["phs"]).reshape(-1, 2 * HALF)
            dframes = torch.nn.functional.pad(x["dout"], (FT, FT)).unfold(1, FT, HOP)
            calls.append(("E, batch 200", lambda s, x=x: cf.fused_synthesis_bwd(
                x["mag"], x["phs"], ws, x["dout"], FT, HOP, compute_dtype=dt, schedule=s),
                both, cublas_backward(spec, ws, dframes.reshape(-1, FT), dt)))
    print(f"{dt} kernels by pass, each schedule (ms):")
    with torch.inference_mode():
        for sched in schedules:
            for title, fn, scheds, _ in calls:
                if sched in scheds:
                    print_split(f"{title}, {sched}", pass_split(lambda: fn(sched)))
        for title, fn, scheds, lib in calls:
            print(f"  {title}: " + ", ".join(f"{s} a call {ms(lambda: fn(s)):.4f}" for s in scheds)
                  + f"; cuBLAS's products {ms(lib):.4f} ms")


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


def quantiles(v: torch.Tensor, qs=(0.5, 0.99, 0.9999)) -> dict:
    """The largest value, the root mean square and the quantiles ``qs`` of v."""
    v = v.flatten().sort().values
    out = {"max": float(v[-1]), "rms": float(v.double().square().mean().sqrt())}
    out.update({f"q{q:g}": float(v[int(q * (v.numel() - 1))]) for q in qs})
    return out


def spectrum_error(x: torch.Tensor, w: torch.Tensor, ft: int, hop: int, schedule: str) -> dict:
    """How far the f32 spectrum that bf16 D forms again lies from float64 on
    ``schedule``, over its components: read through kernel E's dspec product
    (the same product of csrc/wgmma_product.cuh or csrc/tc_product.cuh, on the
    same bf16 frames and weights, K = ft), which with mag 1 and phs 0 writes
    its f32 sums unchanged as (dmag, dphs). E's live frames of dout = x / 2
    are D's frames 1 .. T - 2 of the padded x, halved and rounded as D rounds
    them; w is D's (ft, 2 * half) matrix, whose transpose E takes. Returns
    ``quantiles`` of |kernel - float64| and max|spectrum| (``spec_max``)."""
    b, n = x.shape
    half = w.shape[1] // 2
    ot = (n + ft) // hop + 1
    if (ot - 1) * hop - ft != n:
        raise ValueError(f"a chunk of {n} is not a whole number of hops past ft")
    ones = torch.ones(ot, b, half, device=x.device)
    dout = x * 0.5
    re, im, _ = cf.fused_synthesis_bwd(ones, torch.zeros_like(ones), w.t().contiguous(), dout,
                                       ft, hop, need_dw=False, compute_dtype=torch.bfloat16,
                                       schedule=schedule)
    frames = cf.round_operand(framing.frame_signal(dout.double(), ft, hop, pad=ft),
                              torch.bfloat16)[:, 1:-1].transpose(0, 1)  # (ot - 2, b, ft)
    spec = frames @ cf.round_operand(w.double(), torch.bfloat16)
    err = torch.cat([(re[1:-1].double() - spec[..., :half]).flatten(),
                     (im[1:-1].double() - spec[..., half:]).flatten()]).abs()
    return {**quantiles(err), "spec_max": float(spec.abs().max())}


def d_error_split(xp, w, dmag, dphs):
    """bf16 D under unit-normal cotangents against float64 (the float64 plain
    version of the same bf16-rounded computation), on each schedule and for
    the plain version, split by product: each schedule's dspec is read back
    (``cf.analysis_bwd_dspec``) and its dW product held against the float64
    product of the frames and that dspec (the product's own error); that
    product's distance from float64's is what dspec's rounding flips make
    (with the count of dspec elements off float64's rounded dspec, and by how
    many bf16 ulps at most). Also the dx errors on the unpadded signal."""
    bf = torch.bfloat16
    sl = slice(FT, -FT)
    frames, _, x = cf.analysis_bwd_dspec_reference(xp.double(), w.double(), dmag.double(),
                                                   dphs.double(), FT, HOP, bf)
    fr = frames.reshape(-1, FT).t()
    exact = fr @ x.reshape(-1, 2 * HALF)
    xdxp = cf.fused_analysis_bwd_reference(xp.double(), w.double(), dmag.double(), dphs.double(),
                                           FT, HOP, bf)[0][:, sl]
    rdxp, rdw = cf.fused_analysis_bwd_reference(xp, w, dmag, dphs, FT, HOP, bf)
    print(f"    D, unit-normal cotangents, against float64 (max|dW| {float(exact.abs().max()):.3e},"
          f" max|dx| {float(xdxp.abs().max()):.3e}): plain dW "
          f"{float((rdw - exact).abs().max()):.3e} dx {float((rdxp[:, sl] - xdxp).abs().max()):.3e}")
    ulp = torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)
    for sched in cf.SCHEDULES:
        dw, dspec = cf.analysis_bwd_dspec(xp, w, dmag, dphs, FT, HOP, schedule=sched)
        dxp = cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, compute_dtype=bf,
                                    schedule=sched)[0]
        on_own = fr @ dspec.double().reshape(-1, 2 * HALF)
        off = (dspec.double() - x).abs() / ulp
        print(f"      {sched}: dW {float((dw - exact).abs().max()):.3e} = its product "
              f"{float((dw - on_own).abs().max()):.3e} (against float64 on its own dspec) and "
              f"dspec's flips {float((on_own - exact).abs().max()):.3e} ({int((off > 0).sum())} "
              f"of {off.numel()} elements off, by up to {float(off.max()):.1f} ulps); dx "
              f"{float((dxp[:, sl] - xdxp).abs().max()):.3e}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("kernels", nargs="*", choices=["A", "B", "D", "E"],
                        help="which kernels to time (default: all four)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                        help="the kernels' compute dtype")
    parser.add_argument("--schedules", nargs="+", default=list(cf.SCHEDULES),
                        choices=list(cf.SCHEDULES), help="the schedules the split by pass takes")
    parser.add_argument("--split-only", action="store_true",
                        help="only the split by pass and the cuBLAS products beside it")
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
    schedule_splits(dev, which, dt, args.schedules)
    if args.split_only:
        return
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
            if dt == torch.bfloat16:
                d_error_split(xp, w, dmag, dphs)
                for sched in cf.SCHEDULES:
                    x = xp[:, FT:-FT]
                    e = spectrum_error(x, w, FT, HOP, sched)
                    print(f"    the spectrum D forms again, {sched}, against float64 (through E): "
                          + ", ".join(f"{k} {v:.3e}" for k, v in e.items()))
                continue
            dxp, dw = cf.fused_analysis_bwd(xp, w, dmag, dphs, FT, HOP, compute_dtype=dt)
            rdxp, rdw = cf.fused_analysis_bwd_reference(xp, w, dmag, dphs, FT, HOP, dt)
            xdxp, xdw = cf.fused_analysis_bwd_reference(xp.double(), w.double(), dmag.double(),
                                                        dphs.double(), FT, HOP, dt)
            sl = slice(FT, -FT)
            print(f"    D, unit-normal cotangents, against float64: dx kernel "
                  f"{float((dxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} plain "
                  f"{float((rdxp[:, sl] - xdxp[:, sl]).abs().max()):.3e} (max|dx| "
                  f"{float(xdxp[:, sl].abs().max()):.3e}); dW kernel "
                  f"{float((dw - xdw).abs().max()):.3e} plain {float((rdw - xdw).abs().max()):.3e} "
                  f"(max|dW| {float(xdw.abs().max()):.3e})")


if __name__ == "__main__":
    main()
