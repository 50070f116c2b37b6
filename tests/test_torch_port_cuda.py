"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from signaltrain_tpu_torch/csrc at first use); without a card they
skip. Run them on a GPU machine without the JAX package's test setup:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances are those the port's CPU tests hold the plain versions to against
the JAX package: magnitude 2e-5, wrapped phase 2e-4 on the bins of magnitude
>= 1e-2 and 2e-6 / mag below (assert_analysis_close), synthesis 3e-4; the
smoother (kernel C, by rows and chunked) and kernel L are bit-equal to their
plain versions, which take the same fma steps; model
output 1e-3; gradients 5e-4 + 5e-4*|g| element by element, kernel D's with well-conditioned phase cotangents included; kernel
D's with unit-normal phase cotangents on every bin (heavy-tailed and
ill-conditioned: max|dW| is 50-24,000 against a median of 0.7-18) against a
float64 plain version with the slack that each element's conditioning gives
(assert_close_where_conditioned); the whole model's gradients (largest per leaf 1e-5 to
1e-1) within 1e-3 * max|g| of the leaf, no absolute floor.
"""

import contextlib
import math
import os

import numpy as np
import pytest
import torch

from signaltrain_tpu_torch.cli import time_smoother
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, cuda_kernels, frontend

from tests.torch_port_util import (BWD_GEOMS, analysis_bwd_inputs, assert_analysis_close,
                                   assert_close_where_conditioned, assert_dw_close,
                                   regular_phase_cotangent, synthesis_bwd_inputs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


GEOMS = [(64, 24, 512, 5), (1024, 384, 8192, 3), (100, 30, 700, 7), (1024, 384, 8192, 130)]


def _f32_counter(kernel, ft, hop, xp, schedule=None):
    """The launch counter of float32 kernel A or D on ``schedule`` (None: the
    rule's for this signal)."""
    sched = schedule or cuda_frontend.schedule_for(None, torch.float32, ft, hop, xp.shape[1],
                                                   kernel, cuda_frontend.aligned_16(xp))
    names = {("A", "wgmma"): "ANALYSIS", ("A", "mma"): "ANALYSIS_MMA",
             ("D", "wgmma"): "ANALYSIS_BWD", ("D", "mma"): "ANALYSIS_BWD_MMA"}
    return getattr(cuda_frontend, names[kernel, sched])
# kernels A and D copy 16 bytes at a time where hop, ft and the padded length
# are multiples of 4 floats ((1024, 384), (64, 24)) and 4 bytes elsewhere
# ((100, 30), (16, 5)); batches that are a multiple of no tile (200, 643, 1)
LOADER_GEOMS = [(1024, 384, 8192, 200), (1024, 384, 8192, 643), (1024, 384, 8192, 1),
                (100, 30, 700, 200), (16, 5, 203, 1), (16, 5, 203, 643)]


@pytest.mark.parametrize("ft,hop,chunk,b", GEOMS + LOADER_GEOMS)
def test_analysis_kernel_matches_plain(dev, ft, hop, chunk, b):
    g = torch.Generator(device=dev).manual_seed(ft + b)
    half = ft // 2 + 1
    an = frontend.Analysis(ft, hop, device=dev)
    with torch.no_grad():
        an.conv_analysis_real.weight.add_(torch.randn(ft, 1, ft, generator=g, device=dev) * 0.01)
        w = an.stacked_weights()
        xp = torch.nn.functional.pad(torch.randn(b, chunk, generator=g, device=dev) * 0.3, (ft, ft))
        count = _f32_counter("A", ft, hop, xp)
        before = count.launches
        mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop)
        assert count.launches == before + 1
        rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w, ft, hop)
    torch.cuda.synchronize()
    assert mag.shape == rmag.shape == ((chunk + ft) // hop + 1, b, half)
    assert_analysis_close(mag, phs, rmag, rphs)
    assert torch.all(mag[0] == np.float32(1e-18)) and torch.all(phs[0] == 0)
    assert cuda_frontend.copy_width(ft, hop, xp.shape[1], xp) == (4 if ft % 4 == hop % 4 == 0 else 1)


def test_analysis_kernel_is_as_accurate_as_f32(dev):
    """Against a float64 spectrum, the kernel's largest magnitude error is no
    more than twice the plain f32 version's plus 1e-7."""
    ft, hop, chunk, b = 1024, 384, 8192, 16
    g = torch.Generator(device=dev).manual_seed(7)
    half = ft // 2 + 1
    with torch.no_grad():
        w = frontend.Analysis(ft, hop, device=dev).stacked_weights()
        xp = torch.nn.functional.pad(torch.randn(b, chunk, generator=g, device=dev) * 0.3, (ft, ft))
        mag = cuda_frontend.fused_analysis(xp, w, ft, hop)[0]
        rmag = cuda_frontend.fused_analysis_reference(xp, w, ft, hop)[0]
        frames = xp.unfold(1, ft, hop).transpose(0, 1).double() * 0.5
        spec = frames @ w.double()
        exact = torch.sqrt(spec[..., :half] ** 2 + spec[..., half:] ** 2).clamp_min(1e-18)
    err, plain_err = float((mag - exact).abs().max()), float((rmag - exact).abs().max())
    assert err <= 2 * plain_err + 1e-7, (err, plain_err)


# ---- float32 A and D on both schedules: the split-TF32 products on wgmma
# (csrc/wgmma_product.cuh), which the rule picks where TMA can read the frames,
# and the mma.sync loop (csrc/tc_product.cuh), at the flagship geometry


def _flagship_analysis(dev, b, seed=7):
    ft, hop, chunk = 1024, 384, 8192
    g = torch.Generator(device=dev).manual_seed(seed + b)
    with torch.no_grad():
        w = frontend.Analysis(ft, hop, device=dev).stacked_weights()
        w = (w + torch.randn(w.shape, generator=g, device=dev) * 0.01).contiguous()
        xp = torch.nn.functional.pad(torch.randn(b, chunk, generator=g, device=dev) * 0.3, (ft, ft))
    return w, xp


@pytest.mark.parametrize("schedule", ["wgmma", "mma"])
@pytest.mark.parametrize("b", [200, 643])
def test_f32_analysis_schedules_hold_the_float64_rule(dev, b, schedule):
    """Float32 A on each schedule at the training and the serving batch:
    every magnitude and the phase in its two classes against the plain
    version (assert_analysis_close), the magnitude within twice the plain
    version's error against float64 plus 1e-7, the edge frames exactly 1e-18
    and 0, two runs bit-equal, the schedule's counter."""
    ft, hop = 1024, 384
    half = ft // 2 + 1
    w, xp = _flagship_analysis(dev, b)
    assert cuda_frontend.schedule_for(None, torch.float32, ft, hop, xp.shape[1], "A") == "wgmma"
    count = _f32_counter("A", ft, hop, xp, schedule)
    with torch.no_grad():
        before = count.launches
        mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop, schedule=schedule)
        again = cuda_frontend.fused_analysis(xp, w, ft, hop, schedule=schedule)
        assert count.launches == before + 2
        rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w, ft, hop)
        spec = (xp.unfold(1, ft, hop).transpose(0, 1).double() * 0.5) @ w.double()
        exact = torch.sqrt(spec[..., :half] ** 2 + spec[..., half:] ** 2).clamp_min(1e-18)
    torch.cuda.synchronize()
    assert torch.equal(mag, again[0]) and torch.equal(phs, again[1])
    assert_analysis_close(mag, phs, rmag, rphs)
    err, plain_err = float((mag - exact).abs().max()), float((rmag - exact).abs().max())
    assert err <= 2 * plain_err + 1e-7, (err, plain_err)
    for e in (0, -1):
        assert torch.all(mag[e] == np.float32(1e-18)) and torch.all(phs[e] == 0)


@pytest.mark.parametrize("schedule", ["wgmma", "mma"])
@pytest.mark.parametrize("need_dxp", [True, False])
@pytest.mark.parametrize("cot", ["full", "regular"])
def test_f32_analysis_bwd_schedules_hold_the_float64_rule(dev, cot, need_dxp, schedule):
    """Float32 D on each schedule at the training shape (flagship, batch 200),
    with and without dxp: with unit-normal phase cotangents every element of
    dx (the unpadded signal) and dW against float64 within 5e-4 + 5e-4|g| plus
    its conditioning slack (cuda_frontend.fused_analysis_bwd_conditioning's
    sigma); with well-conditioned ones every element within 5e-4 + 5e-4|g| of
    the plain version; two runs bit-equal, dW the same without dxp."""
    ft, hop, chunk, b = TRAIN_GEOM
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    inp = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(inp["x"], (ft, ft))
    w = cuda_frontend.stack_analysis_weights(inp["wr"], inp["wi"], half)
    args = (xp, w, inp["a"], inp["c"], ft, hop)
    assert cuda_frontend.schedule_for(None, torch.float32, ft, hop, xp.shape[1], "D") == "wgmma"
    count = _f32_counter("D", ft, hop, xp, schedule)
    before = count.launches
    dxp, dw = cuda_frontend.fused_analysis_bwd(*args, need_dxp=need_dxp, schedule=schedule)
    dxp2, dw2 = cuda_frontend.fused_analysis_bwd(*args, need_dxp=need_dxp, schedule=schedule)
    assert count.launches == before + 2
    torch.cuda.synchronize()
    assert (dxp is None) == (not need_dxp) and torch.equal(dw, dw2)
    assert dxp is None or torch.equal(dxp, dxp2)
    assert torch.equal(dw, cuda_frontend.fused_analysis_bwd(*args, need_dxp=not need_dxp,
                                                            schedule=schedule)[1])
    if cot == "regular":
        rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(*args)
        torch.testing.assert_close(dw, rdw, atol=5e-4, rtol=5e-4)
        if need_dxp:
            torch.testing.assert_close(dxp, rdxp, atol=5e-4, rtol=5e-4)
        return
    xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(*(a.double() for a in args[:4]), ft, hop)
    sdxp, sdw = cuda_frontend.fused_analysis_bwd_conditioning(*args)
    assert_close_where_conditioned(dw, xdw, sdw, name=f"{schedule} dW")
    if need_dxp:
        sl = slice(ft, -ft)
        assert_close_where_conditioned(dxp[:, sl], xdxp[:, sl], sdxp[:, sl], name=f"{schedule} dx")


def test_f32_wgmma_schedule_refuses_what_tma_cannot_read(dev):
    """The "ragged" geometry (hop 30: 120 bytes) and a signal 4 bytes off a
    16-byte boundary take the mma.sync schedule by the rule, in A and D
    alike; an explicit schedule="wgmma" on either raises."""
    ft, hop, chunk, b = 100, 30, 700, 7
    half = ft // 2 + 1
    inp = {k: torch.from_numpy(v).to(dev) for k, v in analysis_bwd_inputs(ft, hop, chunk, b).items()}
    xp = torch.nn.functional.pad(inp["x"], (ft, ft))
    w = cuda_frontend.stack_analysis_weights(inp["wr"], inp["wi"], half)
    fw, fxp = _flagship_analysis(dev, 5)
    off = torch.empty(fxp.numel() + 1, device=dev)[1:].view(fxp.shape).copy_(fxp)
    assert not cuda_frontend.aligned_16(off)
    for x, wt, g in ((xp, w, (ft, hop)), (off, fw, (1024, 384))):
        assert cuda_frontend.schedule_for(None, torch.float32, *g, x.shape[1], "A",
                                          cuda_frontend.aligned_16(x)) == "mma"
        _cuda.reset_counts()
        mag = cuda_frontend.fused_analysis(x, wt, *g)[0]
        assert cuda_frontend.ANALYSIS_MMA.launches == 1 and cuda_frontend.ANALYSIS.launches == 0
        t = mag.shape[0]
        cot = torch.ones(t, x.shape[0], wt.shape[1] // 2, device=dev)
        cuda_frontend.fused_analysis_bwd(x, wt, cot, cot, *g)
        assert cuda_frontend.ANALYSIS_BWD_MMA.launches == 1 and cuda_frontend.ANALYSIS_BWD.launches == 0
        with pytest.raises(ValueError, match="wgmma"):
            cuda_frontend.fused_analysis(x, wt, *g, schedule="wgmma")
        with pytest.raises(ValueError, match="wgmma"):
            cuda_frontend.fused_analysis_bwd(x, wt, cot, cot, *g, schedule="wgmma")
    torch.cuda.synchronize()
    # the misaligned copy gives the aligned signal's result (4-byte copies)
    torch.testing.assert_close(cuda_frontend.fused_analysis(off, fw, 1024, 384)[0],
                               cuda_frontend.fused_analysis(fxp, fw, 1024, 384, schedule="mma")[0],
                               atol=2e-5, rtol=2e-5)


# kernels B and E: a ragged last row tile (7 live frames x 100 windows = 700
# rows), a narrow last column tile (ft 600 / 602, ldc 604) and two K slices in
# each product (cuda_frontend.k_slices), with 16-byte copies (600, 200) and
# 4-byte ones (602, 201; E's padded dout rows of 2,210 floats)
SYN_GEOMS = [(600, 200, 0, 100), (602, 201, 0, 100)]


@pytest.mark.parametrize("ft,hop,chunk,b", GEOMS + SYN_GEOMS + [(1024, 384, 8192, 643)])
def test_synthesis_kernel_matches_plain(dev, ft, hop, chunk, b):
    g = torch.Generator(device=dev).manual_seed(ft + b + 1)
    half, ot = ft // 2 + 1, 9
    sy = frontend.Synthesis(ft, hop, device=dev)
    with torch.no_grad():
        w = sy.stacked_weights()
        mag = torch.nn.functional.softplus(torch.randn(ot, b, half, generator=g, device=dev))
        phs = torch.randn(ot, b, half, generator=g, device=dev) * 2.0
        before = cuda_frontend.SYNTHESIS.launches
        wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop)
        again = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop)
        assert cuda_frontend.SYNTHESIS.launches == before + 2
        ref = cuda_frontend.fused_synthesis_reference(mag, phs, w, ft, hop)
    torch.cuda.synchronize()
    assert wave.shape == ref.shape == (b, (ot - 1) * hop - ft)
    assert torch.equal(wave, again)  # K slices added in a fixed order: bit-equal
    torch.testing.assert_close(wave, ref, atol=3e-4, rtol=3e-4)


# batches on each side of the row scan's rows a block (cuda_kernels.rows_per_block on
# 132 SMs: 1 up to 132 rows, 2 up to 264, 4 up to 528, then 8), and lengths of one
# sample, a tile (256) and either side of it, a row that is no multiple of 4 floats
# (each tile copied 4 bytes at a time) and the training chunk
SCAN_SHAPES = [(1, 8), (3, 50), (1024, 40), (33, 2 * 512 + 137), (1, 20000), (9, 257), (5, 256),
               (2, 513), (17, 7), (1, 1), (7, 255), (8, 256), (9, 8192), (1, 8192), (7, 8192),
               (8, 8192), (133, 300), (265, 257), (529, 64), (200, 8192), (645, 8192)]


@pytest.mark.parametrize("b,n", SCAN_SHAPES)
def test_smoother_kernel_matches_plain(dev, b, n):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
    x = torch.randn(b, n, generator=g, device=dev)
    aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    before, chunked = cuda_kernels.SMOOTHER.launches, cuda_kernels.SMOOTHER_CHUNKED.launches
    s = cuda_kernels.switched_one_pole_batched(x, aa, ar)
    again = cuda_kernels.switched_one_pole_batched(x, aa, ar)
    assert cuda_kernels.SMOOTHER.launches == before + 2
    assert cuda_kernels.SMOOTHER_CHUNKED.launches == chunked  # the row schedule
    ref = cuda_kernels.switched_one_pole_reference(x, aa, ar)
    torch.cuda.synchronize()
    assert torch.all(s[:, 0] == 0)
    assert torch.equal(s, again)
    assert torch.equal(s, ref)


def _misaligned(t):
    """t's values in a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary: the row scan then copies 4 bytes at a time."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("n", [257, 8192, 70_000])
def test_smoother_kernel_adversarial_rows(dev, n):
    """time_smoother.adversarial_rows (ties, +-0.0, subnormals, alpha_a >
    alpha_r, equal alphas, alphas 0 and 0.9999, a step) bit-equal to the
    plain version, by rows from aligned and from misaligned memory, and
    chunked at 70,000 samples."""
    g, aa, ar = time_smoother.adversarial_rows(n, dev)
    b = g.shape[0]
    rows = cuda_kernels.smoother_rows(g, aa, ar)
    moved = cuda_kernels.smoother_rows(_misaligned(g), aa, ar)
    s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
    ref = cuda_kernels.switched_one_pole_reference(g, aa, ar)
    torch.cuda.synchronize()
    assert cuda_kernels.uses_chunks(b, n) == (n >= cuda_kernels.CHUNK_MIN_N)
    assert torch.equal(rows, ref) and torch.equal(moved, ref) and torch.equal(s, ref)
    assert torch.equal(rows.view(torch.int32), ref.view(torch.int32))  # signed zeros too


# the chunked schedule's rows (signaltrain_tpu_torch/cli/time_smoother.py), at lengths
# that chunk: the whole 30 s clip for the serving curve and randn, shorter for the others
SMOOTHER_ROW_LENGTHS = {"serving_curve": None, "randn": time_smoother.CLIP_N,
                        "step_to_silence": 300_000, "alpha_9999": 200_000,
                        "alphas_equal": 200_000, "ragged": 70_000, "at_warmup_cap": None,
                        "three_rows": 300_000}


@pytest.mark.parametrize("case", time_smoother.CASES)
def test_chunked_smoother_is_bit_equal_to_row_kernel(dev, case):
    n = SMOOTHER_ROW_LENGTHS[case]
    g, aa, ar = time_smoother.long_rows(case, dev, *([n] if n else []))
    b, n = g.shape
    assert cuda_kernels.uses_chunks(b, n)
    before, chunked = cuda_kernels.SMOOTHER.launches, cuda_kernels.SMOOTHER_CHUNKED.launches
    s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
    assert cuda_kernels.SMOOTHER.launches == before + 1
    assert cuda_kernels.SMOOTHER_CHUNKED.launches == chunked + 1
    again, stats = cuda_kernels.smoother_chunked(g, aa, ar)
    rows = cuda_kernels.smoother_rows(g, aa, ar)
    assert cuda_kernels.SMOOTHER_CHUNKED.launches == chunked + 2
    plain = cuda_kernels.switched_one_pole_reference(g, aa, ar)
    torch.cuda.synchronize()
    assert torch.equal(s, rows) and torch.equal(s, again)
    assert torch.equal(s, plain)
    w = 24.0 / (1.0 - torch.maximum(aa, ar))  # in float32, as the kernel computes it
    assert stats[:, 0].tolist() == [min(65536, -(-math.ceil(v) // 256) * 256) for v in w.tolist()]
    if case == "step_to_silence":  # W = 65,536: the walk re-ran all from the first guessed chunk
        assert int(stats[0, 1]) == n - (65536 + cuda_kernels.CHUNK)


@pytest.mark.parametrize("n,chunked", [(65_535, False), (65_536, True)])
def test_smoother_dispatch_threshold(dev, n, chunked):
    g = torch.randn(1, n, generator=torch.Generator(device=dev).manual_seed(n), device=dev)
    aa, ar = torch.full((1,), 0.99, device=dev), torch.full((1,), 0.95, device=dev)
    before = cuda_kernels.SMOOTHER_CHUNKED.launches
    s = cuda_kernels.switched_one_pole_batched(g, aa, ar)
    assert cuda_kernels.SMOOTHER_CHUNKED.launches == before + int(chunked)
    other = (cuda_kernels.smoother_rows(g, aa, ar) if chunked
             else cuda_kernels.smoother_chunked(g, aa, ar)[0])
    plain = cuda_kernels.switched_one_pole_reference(g, aa, ar)
    torch.cuda.synchronize()
    assert torch.equal(s, other)
    assert torch.equal(s, plain)


def test_wrappers_check_their_inputs(dev):
    x = torch.zeros(2, 64 * 3, device=dev)
    w = torch.zeros(64, 66, device=dev)
    with pytest.raises(TypeError):
        cuda_frontend.fused_analysis(x.double(), w, 64, 24)
    with pytest.raises(ValueError):
        cuda_frontend.fused_analysis(x, torch.zeros(66, 64, device=dev).t(), 64, 24)
    with pytest.raises(ValueError):
        cuda_kernels.switched_one_pole_batched(torch.zeros(2, 8, device=dev),
                                               torch.zeros(3, device=dev),
                                               torch.zeros(3, device=dev))
    with pytest.raises(ValueError):
        cuda_frontend.fused_analysis_bwd(x, w, torch.zeros(6, 2, 33, device=dev).transpose(0, 1),
                                         torch.zeros(6, 2, 33, device=dev), 64, 24)


TRAIN_GEOM = (1024, 384, 8192, 200)  # the training shapes: flagship, batch 200


@pytest.mark.parametrize("cot", ["full", "regular"])
@pytest.mark.parametrize("ft,hop,chunk,b", BWD_GEOMS + [TRAIN_GEOM] + LOADER_GEOMS[1:])
def test_analysis_bwd_kernel_matches_plain(dev, ft, hop, chunk, b, cot):
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    inp = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(inp["x"], (ft, ft))
    w = cuda_frontend.stack_analysis_weights(inp["wr"], inp["wi"], half)
    count = _f32_counter("D", ft, hop, xp)
    before = count.launches
    dxp, dw = cuda_frontend.fused_analysis_bwd(xp, w, inp["a"], inp["c"], ft, hop)
    dxp2, dw2 = cuda_frontend.fused_analysis_bwd(xp, w, inp["a"], inp["c"], ft, hop)
    assert count.launches == before + 2
    rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(xp, w, inp["a"], inp["c"], ft, hop)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(dxp, dxp2)  # no atomics: bit-equal
    if cot == "regular":  # every element of both, dxp on the padding included
        torch.testing.assert_close(dxp, rdxp, atol=5e-4, rtol=5e-4)
        torch.testing.assert_close(dw, rdw, atol=5e-4, rtol=5e-4)
    else:
        # ill-conditioned: against float64, with the slack its conditioning
        # gives each element; the plain f32 version is held to the same. dx on
        # the unpadded signal: the padding's part of dxp carries the
        # near-singular phase adjoint of the all-zero frames
        xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(
            xp.double(), w.double(), inp["a"].double(), inp["c"].double(), ft, hop)
        sdxp, sdw = cuda_frontend.fused_analysis_bwd_conditioning(xp, w, inp["a"], inp["c"], ft, hop)
        sl = slice(ft, -ft)
        for name, gx, gw in (("kernel", dxp, dw), ("plain", rdxp, rdw)):
            assert_close_where_conditioned(gx[:, sl], xdxp[:, sl], sdxp[:, sl], name=f"{name} dx")
            assert_close_where_conditioned(gw, xdw, sdw, name=f"{name} dW")
    only_dw = cuda_frontend.fused_analysis_bwd(xp, w, inp["a"], inp["c"], ft, hop, need_dxp=False)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


@pytest.mark.parametrize("ft,hop,chunk,b", BWD_GEOMS + [TRAIN_GEOM] + SYN_GEOMS)
def test_synthesis_bwd_kernel_matches_plain(dev, ft, hop, chunk, b):
    inp = {k: torch.from_numpy(v).to(dev) for k, v in synthesis_bwd_inputs(ft, hop, b).items()}
    half = ft // 2 + 1
    w = cuda_frontend.stack_synthesis_weights(
        *frontend.fold_synthesis_weights(inp["wr"], inp["wi"], half))
    args = (inp["mag"], inp["phs"], w, inp["a"], ft, hop)
    got = cuda_frontend.fused_synthesis_bwd(*args)
    again = cuda_frontend.fused_synthesis_bwd(*args)
    want = cuda_frontend.fused_synthesis_bwd_reference(*args)
    torch.cuda.synchronize()
    for g, g2, r in zip(got, again, want):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g, r, atol=5e-4, rtol=5e-4)
    for g in got[:2]:  # frames wholly inside the trimmed margin
        assert torch.all(g[0] == 0) and torch.all(g[-1] == 0)
    only = cuda_frontend.fused_synthesis_bwd(*args, need_dw=False)
    assert only[2] is None and torch.equal(only[0], got[0]) and torch.equal(only[1], got[1])


def test_functions_backward_through_the_kernels(dev):
    """autograd through fused_analysis / fused_synthesis on the card runs D
    and E, takes strided cotangents, and skips dxp when x needs no gradient."""
    ft, hop, chunk, b = BWD_GEOMS[0]
    half = ft // 2 + 1
    ia = {k: torch.from_numpy(v).to(dev) for k, v in analysis_bwd_inputs(ft, hop, chunk, b).items()}
    xp = torch.nn.functional.pad(ia["x"], (ft, ft))
    wr = ia["wr"].clone().requires_grad_()
    wi = ia["wi"].clone().requires_grad_()
    _cuda.reset_counts()
    mag, phs = cuda_frontend.fused_analysis(
        xp, cuda_frontend.stack_analysis_weights(wr, wi, half), ft, hop)
    # an expanded cotangent for mag, a strided one for phs
    loss = mag.sum() + (phs.transpose(0, 1) * ia["c"].transpose(0, 1)).sum()
    loss.backward()
    assert cuda_frontend.ANALYSIS_BWD.launches == 1 and cuda_frontend.ANALYSIS_BWD.plain_calls == 0
    _, rdw = cuda_frontend.fused_analysis_bwd_reference(
        xp, cuda_frontend.stack_analysis_weights(wr, wi, half).detach(),
        torch.ones_like(mag), ia["c"], ft, hop)
    assert_dw_close(wr.grad[:half].t().cpu(), rdw[:, :half].cpu())
    assert_dw_close(wi.grad[:half].t().cpu(), rdw[:, half:].cpu())
    assert torch.all(wr.grad[half:] == 0) and torch.all(wi.grad[half:] == 0)


def test_train_step_fused_matches_gemm_on_card(dev):
    """One train step's loss and gradients through the kernels (fused) and
    through plain autograd (gemm), flagship geometry, batch 8."""
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.training import train as train_mod

    spec = compute_spec()
    fused = STModel(spec, frontend="fused", device=dev, generator=torch.Generator().manual_seed(1))
    gemm = STModel(spec, frontend="gemm", device=dev, generator=torch.Generator().manual_seed(1))
    gemm.load_state_dict(fused.state_dict())
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, spec.in_chunk_size, generator=g, device=dev) * 0.3
    y = torch.randn(8, spec.out_chunk_size, generator=g, device=dev) * 0.3
    knobs = torch.rand(8, 4, generator=g, device=dev) - 0.5
    _cuda.reset_counts()
    lf = train_mod.loss_and_grads(fused, x, y, knobs)
    lg = train_mod.loss_and_grads(gemm, x, y, knobs)
    for c in ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd"):
        assert _cuda.COUNTERS[c].launches == 1 and _cuda.COUNTERS[c].plain_calls == 0, c
    torch.testing.assert_close(lf, lg, rtol=1e-5, atol=0)
    for (name, pf_), (_, pg) in zip(fused.named_parameters(), gemm.named_parameters()):
        assert_dw_close(pf_.grad.cpu(), pg.grad.cpu(), name)


def test_model_fused_matches_gemm_on_card(dev):
    from signaltrain_tpu_torch.utils.load_model import load_model

    model, _ = load_model(os.path.join(REPO, "demo", "model_comp4c_demo.tar"), device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(4, model.spec.in_chunk_size, generator=g, device=dev) * 0.4
    knobs = torch.rand(4, 4, generator=g, device=dev) - 0.5
    _cuda.reset_counts()
    with torch.inference_mode():
        yf, magf, mhf = model(x, knobs)
        model.mpaec.frontend = "gemm"
        yg, magg, mhg = model(x, knobs)
    assert cuda_frontend.ANALYSIS.launches == 1 and cuda_frontend.SYNTHESIS.launches == 1
    assert cuda_frontend.ANALYSIS.plain_calls == 0 and cuda_frontend.SYNTHESIS.plain_calls == 0
    torch.testing.assert_close(yf, yg, atol=1e-3, rtol=0)
    torch.testing.assert_close(magf.transpose(0, 1), magg, atol=3e-4, rtol=0)
    assert float((mhf.transpose(0, 1) - mhg).abs().mean()) <= 1e-3


def test_predict_long_card_matches_cpu(dev):
    from signaltrain_tpu_torch.dsp import effects, synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.utils.load_model import load_model

    path = os.path.join(REPO, "demo", "model_comp4c_demo.tar")
    card, _ = load_model(path, device=dev)
    cpu, _ = load_model(path, device="cpu")
    clip = synths.music_like_clip(1.0, seed=2)
    knobs = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    np.testing.assert_allclose(pl.predict_long(clip, knobs, card),
                               pl.predict_long(clip, knobs, cpu), atol=1e-3)
    kw = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)
    ct_card = pl.calc_ct(clip, effects.Compressor_4c(device=dev), kw, 2048, 8192)
    ct_cpu = pl.calc_ct(clip, effects.Compressor_4c(device="cpu"), kw, 2048, 8192)
    np.testing.assert_allclose(ct_card, ct_cpu, atol=1e-5)


def _demo_on_card(dev):
    from signaltrain_tpu_torch.utils.load_model import load_model

    model, _ = load_model(os.path.join(REPO, "demo", "model_comp4c_demo.tar"), device=dev)
    return model


@pytest.mark.parametrize("out_dtype", [None, "int16"])
def test_predict_long_pinned_pull_is_bit_equal_to_a_plain_copy(dev, monkeypatch, out_dtype):
    """The numpy result, pulled super-batch by super-batch into pinned
    memory on the copy stream, equals the device result copied plainly; 62
    windows of the demo model in super-batches of 16 (the last short)."""
    from signaltrain_tpu_torch.dsp import synths
    from signaltrain_tpu_torch.inference import predict_long as pl

    model = _demo_on_card(dev)
    monkeypatch.setattr(pl, "SUPER_BATCH", 16)
    clip = synths.music_like_clip(3.0, seed=4)
    knobs = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    assert pl._num_windows(len(clip), 8192, 6144) == 62
    got = pl.predict_long(clip, knobs, model, out_dtype=out_dtype)
    want = pl.predict_long(clip, knobs, model, out_dtype=out_dtype, return_device=True)
    assert isinstance(got, np.ndarray) and got.dtype == (np.float32 if out_dtype is None
                                                         else np.int16)
    assert np.array_equal(got, want.cpu().numpy())
    assert torch.from_numpy(got).is_pinned()


def test_predict_long_pinned_blocks_are_reused_and_never_shared(dev):
    """A request after the last result of its size was dropped pins nothing
    new (``pinned_allocs`` 0); a result the caller holds is not overwritten by
    the next request of its size."""
    import gc

    from signaltrain_tpu_torch.dsp import synths
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.utils import profiling

    model = _demo_on_card(dev)
    clips = [synths.music_like_clip(2.0, seed=s) for s in (6, 7, 8)]
    knobs = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    profiling.take()
    with profiling.recording(True):
        y = pl.predict_long(clips[0], knobs, model)
        del y
        gc.collect()
        held = pl.predict_long(clips[1], knobs, model)
        kept = held.copy()
        nxt = pl.predict_long(clips[2], knobs, model)
    records, _ = profiling.take()
    counts = [r.counts for r in records if r.name == "predict_long"]
    assert len(counts) == 3 and all("pinned_allocs" in c for c in counts)
    assert counts[1]["pinned_allocs"] == 0
    assert np.array_equal(held, kept) and not np.array_equal(nxt, held)
    assert held.ctypes.data != nxt.ctypes.data


# ---- the bfloat16 modes of A, B, D and E (compute_dtype=torch.bfloat16): each
# against its plain bf16 version, which rounds the same operands and multiplies
# in float32, so the two differ by the order of float32 sums only and the f32
# tolerances hold for A, B and E. D rounds a result (dspec) before its
# products, so its gradients are held against the float64 plain version of the
# same bf16-rounded computation: the kernel's error within twice the plain f32
# version's plus 1e-3 * max|g|, E's beside its element-by-element check.
BF16 = torch.bfloat16
BF16_GEOMS = BWD_GEOMS + [TRAIN_GEOM]


def _f64_rule_ratio(got, plain, exact, floor=1e-3, slack=None):
    """The error of ``got`` against float64 over the limit: twice the plain
    version's error plus floor * max|exact|. ``slack``: a per-element
    allowance taken off each element's error first (bf16 D: the moves of a
    flip of dspec's rounding, cuda_frontend.fused_analysis_bwd_flip_slack)."""
    diff = (got.double() - exact).abs()
    err = float((diff if slack is None else diff - slack).max())
    plain_err = float((plain.double() - exact).abs().max())
    return err / (2 * plain_err + floor * float(exact.abs().max()))


def _f64_rule(name, got, plain, exact, floor=1e-3, slack=None):
    ratio = _f64_rule_ratio(got, plain, exact, floor, slack)
    assert ratio <= 1, (name, ratio)


def _bf16_bwd_cases(geoms, extra=()):
    """(geometry..., schedule) for each bf16 backward case: both schedules
    where the rule allows wgmma (cuda_frontend.uses_wgmma), mma elsewhere."""
    cases = []
    for g in geoms:
        ft, hop, chunk = g[:3]
        wgmma = cuda_frontend.uses_wgmma(ft, hop, chunk + 2 * ft) and cuda_frontend.uses_wgmma(
            ft, hop, (9 - 1) * hop + ft)
        cases += [(*g, sched) for sched in (("wgmma", "mma") if wgmma else ("mma",))]
    return cases + list(extra)


def _fwd_cases(geoms, kernel):
    """(geometry..., schedule) for each bf16 forward case: both schedules
    where the rule allows wgmma (A: cuda_frontend.uses_wgmma; B: every
    geometry), mma elsewhere."""
    cases = []
    for g in geoms:
        ft, hop, chunk = g[:3]
        lp = chunk + 2 * ft if kernel == "A" else None
        wgmma = cuda_frontend.schedule_for(None, BF16, ft, hop, lp) == "wgmma"
        cases += [(*g, sched) for sched in (("wgmma", "mma") if wgmma else ("mma",))]
    return cases


def _fwd_counter(kernel, schedule):
    """The launch counter of bf16 kernel A or B on a schedule."""
    names = {("A", "wgmma"): "ANALYSIS_BF16", ("A", "mma"): "ANALYSIS_BF16_MMA",
             ("B", "wgmma"): "SYNTHESIS_BF16", ("B", "mma"): "SYNTHESIS_BF16_MMA"}
    return getattr(cuda_frontend, names[kernel, schedule])


def _bwd_counter(kernel, schedule):
    """The launch counter of bf16 kernel D or E on a schedule."""
    names = {("D", "wgmma"): "ANALYSIS_BWD_BF16", ("D", "mma"): "ANALYSIS_BWD_BF16_MMA",
             ("E", "wgmma"): "SYNTHESIS_BWD_BF16", ("E", "mma"): "SYNTHESIS_BWD_BF16_MMA"}
    return getattr(cuda_frontend, names[kernel, schedule])


def _rounding_shows(name, f32_result, plain_bf16, tol, factor):
    """The control of an element-by-element bf16 check: the float32 kernel
    is more than ``factor`` times over tol + tol*|plain| somewhere, so a mode
    that did not round fails it."""
    ratio = float(((f32_result - plain_bf16).abs() / (tol + tol * plain_bf16.abs())).max())
    assert ratio > factor, (name, ratio)


@pytest.mark.parametrize("ft,hop,chunk,b,schedule",
                         _fwd_cases(BF16_GEOMS + [(1024, 384, 8192, 643)], "A"))
def test_bf16_analysis_kernel_matches_plain(dev, ft, hop, chunk, b, schedule):
    g = torch.Generator(device=dev).manual_seed(ft + b)
    half = ft // 2 + 1
    count = _fwd_counter("A", schedule)
    with torch.no_grad():
        w = frontend.Analysis(ft, hop, device=dev).stacked_weights()
        w = w + torch.randn(w.shape, generator=g, device=dev) * 0.01
        xp = torch.nn.functional.pad(torch.randn(b, chunk, generator=g, device=dev) * 0.3, (ft, ft))
        before, f32_before = count.launches, cuda_frontend.ANALYSIS.launches
        mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop, BF16, schedule=schedule)
        assert count.launches == before + 1
        assert cuda_frontend.ANALYSIS.launches == f32_before
        rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w, ft, hop, BF16)
        fmag = cuda_frontend.fused_analysis(xp, w, ft, hop)[0]
    torch.cuda.synchronize()
    assert mag.shape == rmag.shape == ((chunk + ft) // hop + 1, b, half)
    assert_analysis_close(mag, phs, rmag, rphs)
    # frame 0, and the last where it lies wholly past the signal (not at the
    # "ragged" geometry), cover only padding: exact zeros in any order of sums
    edges = (0, -1) if (mag.shape[0] - 1) * hop >= ft + chunk else (0,)
    for e in edges:
        assert torch.all(mag[e] == np.float32(1e-18)) and torch.all(phs[e] == 0)
    # the rounding happened: the f32 kernel is far further off than the tolerance
    assert float((fmag - rmag).abs().max()) > 20 * float((mag - rmag).abs().max())
    wide = 8 if ft % 8 == hop % 8 == 0 else 1
    assert cuda_frontend.copy_width(ft, hop, xp.shape[1], xp, dtype=BF16) == wide


@pytest.mark.parametrize("ft,hop,chunk,b,schedule",
                         _fwd_cases(BF16_GEOMS + SYN_GEOMS + [(1024, 384, 8192, 643)], "B"))
def test_bf16_synthesis_kernel_matches_plain(dev, ft, hop, chunk, b, schedule):
    g = torch.Generator(device=dev).manual_seed(ft + b + 1)
    half, ot = ft // 2 + 1, 9
    count = _fwd_counter("B", schedule)
    with torch.no_grad():
        w = frontend.Synthesis(ft, hop, device=dev).stacked_weights()
        mag = torch.nn.functional.softplus(torch.randn(ot, b, half, generator=g, device=dev))
        phs = torch.randn(ot, b, half, generator=g, device=dev) * 2.0
        before = count.launches
        wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop, BF16, schedule=schedule)
        again = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop, BF16, schedule=schedule)
        assert count.launches == before + 2
        ref = cuda_frontend.fused_synthesis_reference(mag, phs, w, ft, hop, BF16)
        f32_wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop)
    torch.cuda.synchronize()
    assert wave.shape == ref.shape == (b, (ot - 1) * hop - ft)
    assert torch.equal(wave, again)
    torch.testing.assert_close(wave, ref, atol=3e-4, rtol=3e-4)
    _rounding_shows("B", f32_wave, ref, 3e-4, 5)  # 15-36x on an H100


def _bf16_analysis_bwd_case(dev, ft, hop, chunk, b, cot):
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    inp = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(inp["x"], (ft, ft))
    w = cuda_frontend.stack_analysis_weights(inp["wr"], inp["wi"], half)
    return xp, w, inp["a"], inp["c"]


@pytest.mark.parametrize("ft,hop,chunk,b,cot,schedule",
                         [(*g[:4], cot, g[4]) for g in _bf16_bwd_cases(BF16_GEOMS)
                          for cot in ("full", "regular")]
                         + [(1024, 384, 8192, 643, cot, sched) for cot in ("full", "regular")
                            for sched in ("wgmma", "mma")])
def test_bf16_analysis_bwd_kernel_matches_plain(dev, ft, hop, chunk, b, cot, schedule):
    xp, w, dmag, dphs = _bf16_analysis_bwd_case(dev, ft, hop, chunk, b, cot)
    args = (xp, w, dmag, dphs, ft, hop)
    count = _bwd_counter("D", schedule)
    before = count.launches
    dxp, dw = cuda_frontend.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=schedule)
    dxp2, dw2 = cuda_frontend.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=schedule)
    assert count.launches == before + 2
    rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(*args, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(dxp, dxp2)
    # against float64 in both cases: dspec is rounded to bf16 before both
    # products, and a float32-level difference in it (another order of sums
    # in the spectrum) moves a rounding by one bf16 ulp, 2^-8 relative; on an
    # H100 at batch 200 that moved 0.4% of the elements of dW by up to 0.016
    # even with the well-conditioned cotangent. Each element's error is taken
    # less the slack such a flip gives it (fused_analysis_bwd_flip_slack)
    # before the rule. dx on the unpadded signal under the full cotangent
    # (the padding's part carries the all-zero frames' adjoint)
    xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(
        xp.double(), w.double(), dmag.double(), dphs.double(), ft, hop, BF16)
    sdxp, sdw = cuda_frontend.fused_analysis_bwd_flip_slack(*args)
    sl = slice(None) if cot == "regular" else slice(ft, -ft)
    _f64_rule("dx", dxp[:, sl], rdxp[:, sl], xdxp[:, sl], slack=sdxp[:, sl])
    _f64_rule("dW", dw, rdw, xdw, slack=sdw)
    # the control: the float32 kernel lands over the same limits (5.5-9.5x
    # on an H100 without the slack)
    fdxp, fdw = cuda_frontend.fused_analysis_bwd(*args)
    gap = max(_f64_rule_ratio(fdxp[:, sl], rdxp[:, sl], xdxp[:, sl], slack=sdxp[:, sl]),
              _f64_rule_ratio(fdw, rdw, xdw, slack=sdw))
    assert gap > 2, gap
    only_dw = cuda_frontend.fused_analysis_bwd(*args, need_dxp=False, compute_dtype=BF16,
                                               schedule=schedule)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)
    only_dx = cuda_frontend.fused_analysis_bwd(*args, need_dw=False, compute_dtype=BF16,
                                               schedule=schedule)
    assert only_dx[1] is None and torch.equal(only_dx[0], dxp)


def _bf16_synthesis_bwd_case(dev, ft, hop, b):
    inp = {k: torch.from_numpy(v).to(dev) for k, v in synthesis_bwd_inputs(ft, hop, b).items()}
    half = ft // 2 + 1
    w = cuda_frontend.stack_synthesis_weights(
        *frontend.fold_synthesis_weights(inp["wr"], inp["wi"], half))
    return inp["mag"], inp["phs"], w, inp["a"]


@pytest.mark.parametrize("ft,hop,chunk,b,schedule", _bf16_bwd_cases(BF16_GEOMS + SYN_GEOMS))
def test_bf16_synthesis_bwd_kernel_matches_plain(dev, ft, hop, chunk, b, schedule):
    args = (*_bf16_synthesis_bwd_case(dev, ft, hop, b), ft, hop)
    count = _bwd_counter("E", schedule)
    before = count.launches
    got = cuda_frontend.fused_synthesis_bwd(*args, compute_dtype=BF16, schedule=schedule)
    again = cuda_frontend.fused_synthesis_bwd(*args, compute_dtype=BF16, schedule=schedule)
    assert count.launches == before + 2
    want = cuda_frontend.fused_synthesis_bwd_reference(*args, compute_dtype=BF16)
    torch.cuda.synchronize()
    exact = cuda_frontend.fused_synthesis_bwd_reference(
        *(a.double() for a in args[:4]), ft, hop, BF16)
    f32_got = cuda_frontend.fused_synthesis_bwd(*args)
    for g, g2, r, x, f, name in zip(got, again, want, exact, f32_got, ("dmag", "dphs", "dW")):
        assert torch.equal(g, g2)
        torch.testing.assert_close(g, r, atol=5e-4, rtol=5e-4)
        _f64_rule(name, g, r, x)
        _rounding_shows("E " + name, f, r, 5e-4, 4)  # 11-375x on an H100
    for g in got[:2]:
        assert torch.all(g[0] == 0) and torch.all(g[-1] == 0)
    only = cuda_frontend.fused_synthesis_bwd(*args, need_dw=False, compute_dtype=BF16,
                                             schedule=schedule)
    assert only[2] is None and torch.equal(only[0], got[0]) and torch.equal(only[1], got[1])


WGMMA_GEOMS = [BWD_GEOMS[0], TRAIN_GEOM]  # "small" and the flagship at the training batch


@pytest.mark.parametrize("ft,hop,chunk,b", WGMMA_GEOMS)
def test_bf16_wgmma_schedule_agrees_with_mma(dev, ft, hop, chunk, b):
    """The wgmma schedule of bf16 D and E against the mma.sync one on the
    same inputs: E element by element (5e-4 + 5e-4|g|); D, whose own bf16
    rounding of dspec may land one ulp apart, by the float64 rule with the
    mma schedule in the place of the plain version (and the flip slack);
    the default picks wgmma at these shapes."""
    xp, w, dmag, dphs = _bf16_analysis_bwd_case(dev, ft, hop, chunk, b, "full")
    args = (xp, w, dmag, dphs, ft, hop)
    before = _bwd_counter("D", "wgmma").launches, _bwd_counter("D", "mma").launches
    got = cuda_frontend.fused_analysis_bwd(*args, compute_dtype=BF16)
    assert (_bwd_counter("D", "wgmma").launches, _bwd_counter("D", "mma").launches) == (
        before[0] + 1, before[1])
    mma = cuda_frontend.fused_analysis_bwd(*args, compute_dtype=BF16, schedule="mma")
    exact = cuda_frontend.fused_analysis_bwd_reference(
        *(a.double() for a in args[:4]), ft, hop, BF16)
    slack = cuda_frontend.fused_analysis_bwd_flip_slack(*args)
    sls = ((slice(None), slice(ft, -ft)), (slice(None), slice(None)))  # dx unpadded, dW
    for g, m, x, s, sl in zip(got, mma, exact, slack, sls):
        _f64_rule("D wgmma against mma", g[sl], m[sl], x[sl], slack=s[sl])
    sargs = (*_bf16_synthesis_bwd_case(dev, ft, hop, b), ft, hop)
    before = _bwd_counter("E", "wgmma").launches, _bwd_counter("E", "mma").launches
    got = cuda_frontend.fused_synthesis_bwd(*sargs, compute_dtype=BF16)
    assert (_bwd_counter("E", "wgmma").launches, _bwd_counter("E", "mma").launches) == (
        before[0] + 1, before[1])
    mma = cuda_frontend.fused_synthesis_bwd(*sargs, compute_dtype=BF16, schedule="mma")
    for g, m in zip(got, mma):
        torch.testing.assert_close(g, m, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("ft,hop,chunk,b", WGMMA_GEOMS + [(1024, 384, 8192, 643)])
def test_bf16_forward_wgmma_schedule_agrees_with_mma(dev, ft, hop, chunk, b):
    """The wgmma schedule of bf16 A and B against the mma.sync one on the
    same inputs (the orders of their f32 sums differ): A by the plain
    version's tolerances (assert_analysis_close), B 3e-4 + 3e-4|wave|; the
    default picks wgmma at these shapes."""
    g = torch.Generator(device=dev).manual_seed(ft + b + 2)
    half = ft // 2 + 1
    with torch.no_grad():
        w = frontend.Analysis(ft, hop, device=dev).stacked_weights()
        xp = torch.nn.functional.pad(torch.randn(b, chunk, generator=g, device=dev) * 0.3, (ft, ft))
        before = _fwd_counter("A", "wgmma").launches, _fwd_counter("A", "mma").launches
        got = cuda_frontend.fused_analysis(xp, w, ft, hop, BF16)
        assert (_fwd_counter("A", "wgmma").launches, _fwd_counter("A", "mma").launches) == (
            before[0] + 1, before[1])
        mma = cuda_frontend.fused_analysis(xp, w, ft, hop, BF16, schedule="mma")
        torch.cuda.synchronize()
        assert_analysis_close(*got, *mma)
        ws = frontend.Synthesis(ft, hop, device=dev).stacked_weights()
        mag = torch.nn.functional.softplus(torch.randn(9, b, half, generator=g, device=dev))
        phs = torch.randn(9, b, half, generator=g, device=dev) * 2.0
        before = _fwd_counter("B", "wgmma").launches, _fwd_counter("B", "mma").launches
        wave = cuda_frontend.fused_synthesis(mag, phs, ws, ft, hop, BF16)
        assert (_fwd_counter("B", "wgmma").launches, _fwd_counter("B", "mma").launches) == (
            before[0] + 1, before[1])
        wave_mma = cuda_frontend.fused_synthesis(mag, phs, ws, ft, hop, BF16, schedule="mma")
    torch.cuda.synchronize()
    torch.testing.assert_close(wave, wave_mma, atol=3e-4, rtol=3e-4)


def test_bf16_wgmma_schedule_refuses_what_tma_cannot_read(dev):
    """hop 30 (60 bytes of bf16) cannot be a TMA stride: the rule picks mma,
    and asking for wgmma raises instead of running the other schedule."""
    ft, hop, chunk, b = BWD_GEOMS[1]
    xp, w, dmag, dphs = _bf16_analysis_bwd_case(dev, ft, hop, chunk, b, "full")
    with pytest.raises(ValueError):
        cuda_frontend.fused_analysis_bwd(xp, w, dmag, dphs, ft, hop, compute_dtype=BF16,
                                         schedule="wgmma")
    with pytest.raises(ValueError):
        cuda_frontend.fused_analysis_bwd(xp, w, dmag, dphs, ft, hop, schedule="wgmma")  # f32
    before = _bwd_counter("D", "mma").launches
    cuda_frontend.fused_analysis_bwd(xp, w, dmag, dphs, ft, hop, compute_dtype=BF16)
    assert _bwd_counter("D", "mma").launches == before + 1
    sargs = (*_bf16_synthesis_bwd_case(dev, ft, hop, b), ft, hop)
    with pytest.raises(ValueError):
        cuda_frontend.fused_synthesis_bwd(*sargs, compute_dtype=BF16, schedule="wgmma")
    with pytest.raises(ValueError):  # A reads frames through TMA as D does
        cuda_frontend.fused_analysis(xp, w, ft, hop, BF16, schedule="wgmma")
    before = _fwd_counter("A", "mma").launches
    cuda_frontend.fused_analysis(xp, w, ft, hop, BF16)
    assert _fwd_counter("A", "mma").launches == before + 1


# ---- float32 B and E on both schedules: the split-TF32 products on wgmma
# (csrc/wgmma_product.cuh; the rule's pick for B at every shape, for E where
# TMA can read the frames of its padded dout) and the mma.sync loop


def _f32_syn_counter(kernel, schedule):
    """The launch counter of float32 kernel B or E on a schedule."""
    names = {("B", "wgmma"): "SYNTHESIS", ("B", "mma"): "SYNTHESIS_MMA",
             ("E", "wgmma"): "SYNTHESIS_BWD", ("E", "mma"): "SYNTHESIS_BWD_MMA"}
    return getattr(cuda_frontend, names[kernel, schedule])


# "small", and the flagship at the training and the serving batch
F32_SYN_GEOMS = [(64, 24, 5), (1024, 384, 200), (1024, 384, 643)]


@pytest.mark.parametrize("schedule", ["wgmma", "mma"])
@pytest.mark.parametrize("ft,hop,b", F32_SYN_GEOMS)
def test_f32_synthesis_schedules_hold_the_float64_rule(dev, ft, hop, b, schedule):
    """Float32 B on each schedule: the wave within 3e-4 + 3e-4|wave| of the
    plain version and within twice the plain version's error against float64
    plus 1e-6 * max|wave|, two runs bit-equal, the schedule's counter."""
    g = torch.Generator(device=dev).manual_seed(ft + b + 3)
    half, ot = ft // 2 + 1, 9
    assert cuda_frontend.schedule_for(None, torch.float32, ft, hop, None, "B") == "wgmma"
    count = _f32_syn_counter("B", schedule)
    with torch.no_grad():
        w = frontend.Synthesis(ft, hop, device=dev).stacked_weights()
        w = (w + torch.randn(w.shape, generator=g, device=dev) * 0.01).contiguous()
        mag = torch.nn.functional.softplus(torch.randn(ot, b, half, generator=g, device=dev))
        phs = torch.randn(ot, b, half, generator=g, device=dev) * 2.0
        before = count.launches
        wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop, schedule=schedule)
        again = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop, schedule=schedule)
        assert count.launches == before + 2
        ref = cuda_frontend.fused_synthesis_reference(mag, phs, w, ft, hop)
        exact = cuda_frontend.fused_synthesis_reference(mag.double(), phs.double(), w.double(),
                                                        ft, hop)
    torch.cuda.synchronize()
    assert wave.shape == ref.shape == (b, (ot - 1) * hop - ft)
    assert torch.equal(wave, again)
    torch.testing.assert_close(wave, ref, atol=3e-4, rtol=3e-4)
    _f64_rule(f"B {schedule}", wave, ref, exact, floor=1e-6)


@pytest.mark.parametrize("schedule", ["wgmma", "mma"])
@pytest.mark.parametrize("ft,hop,b", F32_SYN_GEOMS[:2])
def test_f32_synthesis_bwd_schedules_hold_the_float64_rule(dev, ft, hop, b, schedule):
    """Float32 E on each schedule: dmag, dphs and dW within 5e-4 + 5e-4|g|
    of the plain version and within twice its error against float64 plus
    1e-6 * max|g|, two runs bit-equal, the edge frames exactly 0, dmag and
    dphs the same without dW, the schedule's counter."""
    args = (*_bf16_synthesis_bwd_case(dev, ft, hop, b), ft, hop)
    out_len = args[3].shape[1]
    assert cuda_frontend.schedule_for(None, torch.float32, ft, hop, out_len + 2 * ft,
                                      "E") == "wgmma"
    count = _f32_syn_counter("E", schedule)
    before = count.launches
    got = cuda_frontend.fused_synthesis_bwd(*args, schedule=schedule)
    again = cuda_frontend.fused_synthesis_bwd(*args, schedule=schedule)
    assert count.launches == before + 2
    want = cuda_frontend.fused_synthesis_bwd_reference(*args)
    exact = cuda_frontend.fused_synthesis_bwd_reference(*(a.double() for a in args[:4]), ft, hop)
    torch.cuda.synchronize()
    for g, g2, r, x, name in zip(got, again, want, exact, ("dmag", "dphs", "dW")):
        assert torch.equal(g, g2), name
        torch.testing.assert_close(g, r, atol=5e-4, rtol=5e-4)
        _f64_rule(f"E {schedule} {name}", g, r, x, floor=1e-6)
    for g in got[:2]:  # frames wholly inside the trimmed margin
        assert torch.all(g[0] == 0) and torch.all(g[-1] == 0)
    only = cuda_frontend.fused_synthesis_bwd(*args, need_dw=False, schedule=schedule)
    assert only[2] is None and torch.equal(only[0], got[0]) and torch.equal(only[1], got[1])


def test_f32_synthesis_bwd_wgmma_refuses_what_tma_cannot_read(dev):
    """At the "ragged" geometry (hop 30: 120 bytes) float32 E takes the
    mma.sync schedule by the rule and a forced wgmma raises; B takes wgmma
    there as at every geometry."""
    ft, hop, chunk, b = BWD_GEOMS[1]
    args = (*_bf16_synthesis_bwd_case(dev, ft, hop, b), ft, hop)
    _cuda.reset_counts()
    got = cuda_frontend.fused_synthesis_bwd(*args)
    assert cuda_frontend.SYNTHESIS_BWD_MMA.launches == 1
    assert cuda_frontend.SYNTHESIS_BWD.launches == 0
    with pytest.raises(ValueError, match="wgmma"):
        cuda_frontend.fused_synthesis_bwd(*args, schedule="wgmma")
    want = cuda_frontend.fused_synthesis_bwd_reference(*args)
    wave = cuda_frontend.fused_synthesis(*args[:3], ft, hop)
    assert cuda_frontend.SYNTHESIS.launches == 1 and cuda_frontend.SYNTHESIS_MMA.launches == 0
    ref = cuda_frontend.fused_synthesis_reference(*args[:3], ft, hop)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(wave, ref, atol=3e-4, rtol=3e-4)


class _Bf16GemmFloat64(torch.autograd.Function):
    """The bf16 gemm policy (operands and cotangent rounded to bf16) with
    every product summed in float64: the float64 reference step's front-end."""

    @staticmethod
    def forward(ctx, a, b):
        ac, bc = a.to(BF16).double(), b.to(BF16).double()
        ctx.save_for_backward(ac, bc)
        return ac @ bc

    @staticmethod
    def backward(ctx, g):
        ac, bc = ctx.saved_tensors
        gc = g.to(BF16).double()
        return gc @ bc.t(), ac.reshape(-1, ac.shape[-1]).t() @ gc.reshape(-1, gc.shape[-1])


def test_bf16_train_step_through_the_kernels(dev, monkeypatch):
    """One bf16 train step's loss and gradients through the kernels (fused)
    and through the bf16 gemm policy, each against the same step with float64
    parameters (the same bf16 autoencoders, the front-end's bf16 operands
    summed in float64): the fused error within twice the gemm step's plus
    2e-6 (loss, relative) and 2e-2 * max|g| of each leaf. Those floors sit
    between the fused step's readings and a control's, the bf16 model on the
    float32 kernels, which must fail both; flagship geometry, batch 8."""
    import copy

    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.training import train as train_mod

    spec = compute_spec()
    fused = STModel(spec, frontend="fused", device=dev, generator=torch.Generator().manual_seed(1),
                    compute_dtype=BF16)
    gemm = STModel(spec, frontend="gemm", device=dev, generator=torch.Generator().manual_seed(1),
                   compute_dtype=BF16)
    gemm.load_state_dict(fused.state_dict())
    control = copy.deepcopy(fused)
    control.mpaec.dft_analysis.compute_dtype = control.mpaec.dft_synthesis.compute_dtype = torch.float32
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, spec.in_chunk_size, generator=g, device=dev) * 0.3
    y = torch.randn(8, spec.out_chunk_size, generator=g, device=dev) * 0.3
    knobs = torch.rand(8, 4, generator=g, device=dev) - 0.5
    _cuda.reset_counts()
    lf = train_mod.loss_and_grads(fused, x, y, knobs)
    for c in ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd"):
        assert _cuda.COUNTERS["bf16_" + c].launches == 1, c
        assert _cuda.COUNTERS["bf16_" + c].plain_calls == 0 and _cuda.COUNTERS[c].launches == 0, c
    exact = copy.deepcopy(gemm).double()
    with monkeypatch.context() as m:
        m.setattr(frontend, "Bf16Gemm", _Bf16GemmFloat64)
        lx = train_mod.loss_and_grads(exact, x.double(), y.double(), knobs.double())
    rel = lambda l: abs(float(l) - float(lx)) / abs(float(lx))
    grads = lambda model: [p.grad.double() for p in model.parameters()]
    gf = grads(fused)
    lg = train_mod.loss_and_grads(gemm, x, y, knobs)
    gg = grads(gemm)
    lc = train_mod.loss_and_grads(control, x, y, knobs)
    gc = grads(control)
    loss_limit = 2 * rel(lg) + 2e-6
    over, over_control = [], []
    for f, gm, c, px in zip(gf, gg, gc, exact.parameters()):
        limit = 2 * float((gm - px.grad).abs().max()) + 2e-2 * float(px.grad.abs().max())
        over.append(float((f - px.grad).abs().max()) / limit)
        over_control.append(float((c - px.grad).abs().max()) / limit)
    print(f"bf16 step, batch 8, against float64: loss fused {rel(lf):.2e} gemm {rel(lg):.2e} "
          f"control {rel(lc):.2e}; gradients over their limits: fused {max(over):.2f}x, control "
          f"{max(over_control):.2f}x")
    assert rel(lf) <= loss_limit and max(over) <= 1, (rel(lf), rel(lg), over)
    assert rel(lc) > 2 * loss_limit and max(over_control) > 2, (rel(lc), over_control)


def test_bf16_wrappers_refuse_other_dtypes(dev):
    x = torch.zeros(2, 64 * 3, device=dev)
    w = torch.zeros(64, 66, device=dev)
    with pytest.raises(TypeError):
        cuda_frontend.fused_analysis(x, w, 64, 24, torch.float16)
    with pytest.raises(TypeError):  # the kernels' inputs are float32 in both modes
        cuda_frontend.fused_analysis(x.bfloat16(), w, 64, 24, BF16)


# ---- the training loop's CUDA graphs (training/graphs.py)

GRAPH_BATCH = 8  # flagship geometry, a small batch


def _graph_setup(dev, frontend, compute_dtype, n_models=2, seed=1, effect_name="comp_4c"):
    """Models with the same seeded weights, each with its capturable Adam, and
    the effect's batch functions at the flagship geometry."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.training import train as train_mod

    effect = effects.make_effect(effect_name, device=dev)
    spec = compute_spec(num_knobs=effect.num_knobs)
    models = [STModel(spec, frontend=frontend, device=dev, compute_dtype=compute_dtype,
                      generator=torch.Generator().manual_seed(seed)).train()
              for _ in range(n_models)]
    opts = [train_mod.make_optimizer(m, 2e-4, 4000, 3, 200) for m in models]
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    val_batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size,
                                                  spec.out_chunk_size, augment=False)
    return models, opts, batch_fn, val_batch_fn


@pytest.mark.parametrize("frontend", ["fused", "gemm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_graph_is_bit_equal_to_eager_steps(dev, frontend, dtype):
    """20 steps of the train graph (its warm-up, then 19 replays) against 20
    eager steps of the same capturable Adam from the same weights and seeds:
    every loss and every parameter bit-equal, the batches of steps 0, 1 and
    19 equal to batch_fn run eagerly on step_generator, and the launch
    counters counting each replay's kernels."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (gm, em), ((gopt, lr_fn), (eopt, _)), batch_fn, _ = _graph_setup(
        dev, frontend, getattr(torch, dtype))
    assert isinstance(gopt.param_groups[0]["lr"], torch.Tensor) and gopt.defaults["capturable"]
    seed = 218
    graph = graphs.TrainGraph(gm, gopt, lr_fn, batch_fn, GRAPH_BATCH,
                              torch.Generator(device=dev), seed, capacity=10)
    eg = torch.Generator(device=dev)
    _cuda.reset_counts()
    got = []
    for step in range(20):
        got.append(graph(step, 1))
        if step in (0, 1, 19):
            want = batch_fn(GRAPH_BATCH, synth_data.step_generator(eg, seed, step))
            for a, b in zip(graph.batch, want):
                assert torch.equal(a, b), step
    got = torch.cat(got)
    counts = dict(graph.graph.counts)
    launched = _cuda.launch_counts()
    want = train_mod.eager_steps(em, eopt, lr_fn, batch_fn, GRAPH_BATCH, eg, seed, 0, 20)
    assert torch.equal(got, want), (got, want)
    for (name, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), name
    assert graph.graph.replays == 19 and counts.get("switched_one_pole") == 1
    names = ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd")
    prefix = "bf16_" if dtype == "bfloat16" else ""
    for name in names:
        n = counts.get(prefix + name, 0)
        assert n == (1 if frontend == "fused" else 0), (name, counts)
        assert launched.get(prefix + name, 0) == 20 * n  # the warm-up step and 19 replays
    for name in names[2:]:  # bf16 D and E at the flagship take the wgmma schedule
        assert counts.get(f"bf16_{name}_mma", 0) == 0 and launched.get(f"bf16_{name}_mma", 0) == 0
    assert launched["switched_one_pole"] == 20 + 3  # and the three eager batches above


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_microbatched_train_graph_is_bit_equal_to_eager_steps(dev, dtype):
    """ST_TPU_MICROBATCH's slices inside the one captured step: 10 steps of
    the train graph at micro=4 (four slices of 2 rows) against 10 eager
    steps at micro=4, every loss and parameter bit-equal; the front-end
    kernels launch four times a replay, C once (the whole batch's data)."""
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (gm, em), ((gopt, lr_fn), (eopt, _)), batch_fn, _ = _graph_setup(
        dev, "fused", getattr(torch, dtype))
    graph = graphs.TrainGraph(gm, gopt, lr_fn, batch_fn, GRAPH_BATCH,
                              torch.Generator(device=dev), 218, capacity=10, micro=4)
    got = graph(0, 1)
    got = torch.cat([got, graph(1, 9)])
    want = train_mod.eager_steps(em, eopt, lr_fn, batch_fn, GRAPH_BATCH,
                                 torch.Generator(device=dev), 218, 0, 10, micro=4)
    assert torch.equal(got, want), (got, want)
    for (name, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), name
    prefix = "bf16_" if dtype == "bfloat16" else ""
    assert graph.graph.counts.get("switched_one_pole") == 1
    for name in ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd"):
        assert graph.graph.counts.get(prefix + name) == 4, (name, graph.graph.counts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_graph_equals_eager_validation(dev, dtype):
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (m,), _, _, val_batch_fn = _graph_setup(dev, "fused", getattr(torch, dtype), n_models=1)
    m.eval()
    g = torch.Generator(device=dev)
    evals = graphs.EvalGraph(m, val_batch_fn, GRAPH_BATCH, g, 5)
    for _ in range(2):  # the warm-up and 4 replays, then a pass of replays alone
        losses, maes, last = evals()
        want_l, want_m, want_last = train_mod.eager_validation(m, val_batch_fn, GRAPH_BATCH, g, 5)
        assert torch.equal(losses, want_l) and torch.equal(maes, want_m)
        assert all(torch.equal(a, b) for a, b in zip(last, want_last))
    assert evals.graph.replays == 9


def test_resume_under_graphs_from_a_step_10_checkpoint(dev, tmp_path):
    """A run checkpointed at step 10 and resumed in a new model, optimizer
    and graph reaches the weights of the uninterrupted run at step 20."""
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import STModel
    from signaltrain_tpu_torch.training import checkpoint, graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (full, first), ((fopt, lr_fn), (opt1, _)), batch_fn, _ = _graph_setup(dev, "fused", BF16)

    def graph(m, opt):
        return graphs.TrainGraph(m, opt, lr_fn, batch_fn, GRAPH_BATCH,
                                 torch.Generator(device=dev), 218, capacity=10)

    run = graph(full, fopt)
    want = torch.cat([run(0, 10), run(10, 10)])
    losses1 = graph(first, opt1)(0, 10)
    path = str(tmp_path / "step10.tar")
    checkpoint.save_checkpoint(path, first.spec, effects.Compressor_4c(device=dev), 0,
                               checkpoint.training_tensors(first, opt1), step=10)
    state_dict, rv = checkpoint.load_checkpoint(path)
    resumed = STModel(first.spec, frontend="fused", device=dev, compute_dtype=BF16)
    resumed.load_state_dict(state_dict, strict=True)
    resumed.train()
    opt2, _ = train_mod.make_optimizer(resumed, 2e-4, 4000, 3, 200)
    checkpoint.restore_optimizer(resumed, opt2, rv["optax_state"], int(rv["optax_step"]))
    assert all(st["step"].device == dev for st in opt2.state.values())
    losses2 = graph(resumed, opt2)(10, 10)
    assert torch.equal(torch.cat([losses1, losses2]), want)
    for (name, p), q in zip(full.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), name


def test_capturable_adam_stays_within_the_optax_tolerance_of_plain_adam(dev):
    """Capturable Adam takes its bias corrections on the card in float32;
    plain Adam in double. Over 5 steps of the same gradients under the 1cycle
    schedule they stay within test_adam_matches_optax_under_one_cycle's rtol
    1e-5 / atol 1e-8."""
    from signaltrain_tpu_torch.training import train as train_mod

    (cap, plain), ((copt, lr_fn), _), _, _ = _graph_setup(dev, "fused", torch.float32)
    popt = torch.optim.Adam(plain.parameters(), lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8)
    g = torch.Generator(device=dev).manual_seed(3)
    for step in range(5):
        for p, q in zip(cap.parameters(), plain.parameters()):
            p.grad = torch.randn(p.shape, generator=g, device=dev)
            q.grad = p.grad.clone()
        train_mod.set_lr(copt, lr_fn(step))
        train_mod.set_lr(popt, lr_fn(step))
        copt.step()
        popt.step()
    for (name, p), q in zip(cap.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-8, msg=name)


def test_compressor_copies_nothing_and_matches_its_earlier_expressions_on_card(dev):
    """The step's compressor fills its knobs in on the card: under a stream
    capture it must not copy from the host, and it equals the expressions it
    replaced (torch.as_tensor knobs, ln 9 from torch.log on the card)."""
    from signaltrain_tpu_torch.dsp import compressors

    assert compressors.LN9 == torch.log(torch.tensor(9.0, device=dev)).item()
    x = torch.randn(4, 700, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    k = [-17.3, 3.1, 0.0071, 0.023]
    ln9 = torch.log(torch.tensor(9.0, dtype=torch.float32, device=dev))
    per = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in k]
    alpha_a = torch.exp(-ln9 / (44100.0 * per[2]))
    alpha_r = torch.exp(-ln9 / (44100.0 * per[3]))
    gc, aa, ar = compressors.gain_curve(x, *k)
    assert torch.equal(aa, alpha_a) and torch.equal(ar, alpha_r)
    y = compressors.compressor_4controls(x, *k)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = compressors.compressor_4controls(x, *k)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg, y)


# ---- kernel L (csrc/iir.cu) and the synthesized effects on the card. L takes
# the same fma steps as its plain version, which forms each in a Python float
# (float64) and rounds it once: bit-equal

@pytest.mark.parametrize("case", ["comp", "lowpass", "row_30s"])
def test_lfilter_kernel_matches_plain(dev, case):
    """chip_smoke.py's checks of L (cli/time_lfilter.py: the Compressor's
    envelope at (200, 8192), the LowPass at (200, 8192) with cutoffs down to
    10 Hz, a 30 s row)."""
    from signaltrain_tpu_torch.cli import time_lfilter
    from signaltrain_tpu_torch.dsp import iir

    b, a, x, zi = time_lfilter.inputs(case, dev)
    before, plain = iir.LFILTER.launches, iir.LFILTER.plain_calls
    y = iir.lfilter(b, a, x, zi)
    again = cuda_kernels.lfilter_rows(b.contiguous(), a.contiguous(), x, zi.contiguous())
    assert iir.LFILTER.launches == before + 2 and iir.LFILTER.plain_calls == plain
    ref = iir.lfilter_reference(b, a, x, zi)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert bool(torch.isfinite(y).all())
    assert torch.equal(y, ref)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("b,n", [(1, 1), (7, 255), (8, 256), (9, 257), (133, 300), (265, 8192),
                                 (529, 64), (200, 8192), (3, 2 * 512 + 137)])
def test_lfilter_kernel_shapes(dev, order, b, n):
    """Kernel L at batches on each side of the rows a block and lengths on
    each side of a tile, one not a multiple of 4 floats; per-row cutoffs and
    initial states; bit-equal to the plain version and from run to run."""
    from signaltrain_tpu_torch.dsp import iir

    g = torch.Generator(device=dev).manual_seed(order * 7 + b * 1000 + n)
    wn = torch.empty(b, device=dev).uniform_(1e-3, 0.5, generator=g)
    bb, aa = iir.butter_lowpass(order, wn)
    x = torch.randn(b, n, generator=g, device=dev)
    zi = torch.randn(b, order, generator=g, device=dev)
    y = cuda_kernels.lfilter_rows(bb, aa, x, zi)
    again = cuda_kernels.lfilter_rows(bb, aa, x, zi)
    ref = iir.lfilter_reference(bb, aa, x, zi)
    torch.cuda.synchronize()
    assert torch.equal(y, again) and torch.equal(y, ref)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("n", [257, 8192])
def test_lfilter_kernel_adversarial_rows(dev, order, n):
    """time_lfilter.adversarial_inputs (a steady state, +-0.0, subnormals, a
    response decaying through the subnormals, poles near z = 1, a cutoff near
    Nyquist, +-1 at Nyquist, dB-sized inputs) bit-equal to the plain
    version, from aligned and from misaligned memory."""
    from signaltrain_tpu_torch.cli import time_lfilter
    from signaltrain_tpu_torch.dsp import iir

    b, a, x, zi = time_lfilter.adversarial_inputs(n, order, dev)
    y = cuda_kernels.lfilter_rows(b, a, x, zi)
    moved = cuda_kernels.lfilter_rows(b, a, _misaligned(x), zi)
    ref = iir.lfilter_reference(b, a, x, zi)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(moved.view(torch.int32), ref.view(torch.int32))


def test_lfilter_wrapper_checks_its_inputs(dev):
    from signaltrain_tpu_torch.dsp import iir

    x = torch.zeros(2, 64, device=dev)
    for order in (2, 4, 5):  # kernel L is built for orders 1 and 3
        bo, ao = iir.butter_lowpass(order, torch.full((2,), 0.1, device=dev))
        with pytest.raises(ValueError):
            iir.lfilter(bo, ao, x)
    b, a = iir.butter_lowpass(1, torch.full((2,), 0.1, device=dev))
    with pytest.raises(ValueError):
        cuda_kernels.lfilter_rows(b, a, x.cpu(), torch.zeros(2, 1))
    with pytest.raises(ValueError):
        cuda_kernels.lfilter_rows(b, a, x, torch.zeros(3, 1, device=dev))


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)


@pytest.mark.parametrize("name", ["comp", "comp_4c", "comp_4c_large", "comp_large", "comp_t",
                                  "comp_one", "echo", "pitch", "denoise", "decomp_4c",
                                  "timealign", "lowpass"])
def test_effect_on_card_matches_cpu(dev, name):
    """Each effect's go_batch on the card against the CPU plain path at the
    flagship chunk, per-row knobs, with its EFFECT_TOL; Denoise and TimeAlign
    on the same draws (made on the CPU) through their deterministic parts.
    On the card L and C launch, and no plain version runs."""
    from signaltrain_tpu_torch.dsp import effects, iir, synths

    from tests.torch_port_util import assert_effect_close

    rng = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy((rng.normal(size=(6, 8192)) * 0.3).astype(np.float32))
    card_fx, cpu_fx = effects.make_effect(name, device=dev), effects.make_effect(name, device="cpu")
    knobs = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(6, card_fx.num_knobs)).astype(np.float32))
    knobs[0], knobs[1] = -0.5, 0.5
    _cuda.reset_counts()
    if name == "denoise":
        u = torch.rand(x.shape, generator=torch.Generator().manual_seed(0))
        got = effects.denoise_pair(x.to(dev), card_fx.knobs_wc(knobs.to(dev))[:, 0], u.to(dev))
        want = effects.denoise_pair(x, cpu_fx.knobs_wc(knobs)[:, 0], u)
    elif name == "timealign":
        g = torch.Generator().manual_seed(0)
        tt = torch.arange(8192, dtype=torch.float32) / 44100.0
        ins = (synths.choose_from(g, effects.TIMEALIGN_CHOOSERS, 6),
               {c: synths.draw_branch(c, g, 6, 8192) for c in effects.TIMEALIGN_CHOOSERS},
               synths._sign(g, 6), synths._u(g, 6, 8192), cpu_fx.knobs_wc(knobs)[:, 0],
               synths._u(g, 6))
        want = effects.timealign_pair(tt, *ins)
        got = effects.timealign_pair(tt.to(dev), *(_to(v, dev) for v in ins))
    else:
        got = card_fx.go_batch(x.to(dev), knobs.to(dev))
        want = cpu_fx.go_batch(x, knobs)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}
    if name in ("comp", "lowpass"):
        assert iir.LFILTER.launches == 1 and iir.LFILTER.plain_calls == 1, counts
    if "comp" in name:
        assert cuda_kernels.SMOOTHER.launches == (0 if name == "comp" else 1), counts
    for g_card, w_cpu in zip(got, want):
        assert g_card.device.type == "cuda" and bool(torch.isfinite(g_card).all())
        assert_effect_close(name, g_card, w_cpu)


@pytest.mark.parametrize("name", ["denoise", "timealign"])
def test_train_graph_of_a_random_effect_is_bit_equal_to_eager_steps(dev, name):
    """An effect that draws inside the step (Denoise's noise, TimeAlign's
    chooser, shift and re-synthesis) under the train graph: 6 steps (the
    warm-up, then 5 replays) against 6 eager steps, losses, weights and the
    batches of steps 0 and 5 bit-equal."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (gm, em), ((gopt, lr_fn), (eopt, _)), batch_fn, _ = _graph_setup(
        dev, "fused", torch.bfloat16, effect_name=name)
    graph = graphs.TrainGraph(gm, gopt, lr_fn, batch_fn, GRAPH_BATCH,
                              torch.Generator(device=dev), 218, capacity=6)
    eg = torch.Generator(device=dev)
    got = []
    for step in range(6):
        got.append(graph(step, 1))
        if step in (0, 5):
            want = batch_fn(GRAPH_BATCH, synth_data.step_generator(eg, 218, step))
            for a, b in zip(graph.batch, want):
                assert torch.equal(a, b), step
    want = train_mod.eager_steps(em, eopt, lr_fn, batch_fn, GRAPH_BATCH, eg, 218, 0, 6)
    assert torch.equal(torch.cat(got), want)
    for (pname, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), pname
    assert graph.graph.replays == 5


# ---- file datasets (data/file_data.py, cli/gen_dataset.py) on the card

def _file_dataset(root, pcm16=False, n_files=4, length=12000, seed=0):
    """A small file dataset written with the port's audio_io: Train/ (and
    Val/) pairs of ``length`` samples, comp_4c knobs in the target names."""
    from signaltrain_tpu_torch.data import audio_io

    rng = np.random.default_rng(seed)
    knobs = ["__-10.5__3.25__0.005__0.02", "__-20.0__2.0__0.01__0.03"]
    for sub in ("Train", "Val"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n_files):
            x = (0.4 * rng.standard_normal(length)).astype(np.float32).clip(-1, 1)
            y = np.tanh(2.0 * x).astype(np.float32)
            if pcm16:
                x, y = audio_io.to_pcm16(x), audio_io.to_pcm16(y)
            audio_io.write_audio_file(os.path.join(root, sub, f"input_{i}_.wav"), x)
            audio_io.write_audio_file(
                os.path.join(root, sub, f"target_{i}_Compressor_4c{knobs[i % 2]}.wav"), y)
    return str(root)


@pytest.mark.parametrize("tier", ["f32", "int16", "f32_chunk"])
def test_file_batch_graph_is_bit_equal_to_eager_steps(dev, tmp_path, tier):
    """The file batch function captured in a TrainGraph (tiers f32 and int16,
    and f32 under -t chunk, kernel C inside the step): 6 steps (the warm-up,
    then 5 replays) against 6 eager steps, losses, weights and the batches of
    steps 0 and 5 bit-equal; on 16-bit files the int16 tier's batches equal
    the f32 tier's."""
    from signaltrain_tpu_torch.data import file_data, synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    path = os.path.join(_file_dataset(tmp_path, pcm16=tier == "int16"), "Train")
    (gm, em), ((gopt, lr_fn), (eopt, _)), _, _ = _graph_setup(dev, "fused", BF16)
    effect = effects.Compressor_4c(device=dev)
    ds = file_data.FileDataset(path, effect, 8192, 2048, rerun=tier == "f32_chunk")
    if tier == "int16":
        ds32 = ds
        ds = file_data.FileDataset(path, effect, 8192, 2048,
                                   device_resident_limit_bytes=2 * 4 * 12000 * 4 - 1)
        assert ds.device_resident_int16 and ds.x.dtype == torch.int16
        g1, g2 = torch.Generator(device=dev), torch.Generator(device=dev)
        for step in (0, 1, 19):
            for a, b in zip(ds.batch_fn(GRAPH_BATCH, synth_data.step_generator(g1, 218, step)),
                            ds32.batch_fn(GRAPH_BATCH, synth_data.step_generator(g2, 218, step))):
                assert torch.equal(a, b), step
    graph = graphs.TrainGraph(gm, gopt, lr_fn, ds.batch_fn, GRAPH_BATCH,
                              torch.Generator(device=dev), 218, capacity=6)
    eg = torch.Generator(device=dev)
    _cuda.reset_counts()
    got = []
    for step in range(6):
        got.append(graph(step, 1))
        if step in (0, 5):
            want = ds.batch_fn(GRAPH_BATCH, synth_data.step_generator(eg, 218, step))
            for a, b in zip(graph.batch, want):
                assert torch.equal(a, b), step
    assert (graph.graph.counts.get("switched_one_pole", 0) == 1) == (tier == "f32_chunk")
    want = train_mod.eager_steps(em, eopt, lr_fn, ds.batch_fn, GRAPH_BATCH, eg, 218, 0, 6)
    assert torch.equal(torch.cat(got), want)
    for (pname, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), pname
    assert graph.graph.replays == 5


def test_arrays_graphs_on_prefetched_batches_equal_eager(dev, tmp_path):
    """The host tier: ArraysTrainGraph fed by the prefetcher (pinned ring,
    asynchronous copies) against host_steps on a second prefetcher of the
    same rng, 8 steps (more than the ring's slots), losses and weights
    bit-equal; ArraysEvalGraph against host_validation on the same batches."""
    from signaltrain_tpu_torch.data import file_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    path = _file_dataset(tmp_path)
    (gm, em), ((gopt, lr_fn), (eopt, _)), _, _ = _graph_setup(dev, "fused", BF16)
    ds = file_data.FileDataset(path + "/Train", effects.Compressor_4c(device=dev), 8192, 2048,
                               device_resident_limit_bytes=1)
    assert not ds.device_resident
    shapes = [(GRAPH_BATCH, 8192), (GRAPH_BATCH, 2048), (GRAPH_BATCH, 4)]
    pg = ds.prefetch_batches(GRAPH_BATCH, np.random.default_rng(3))
    pe = ds.prefetch_batches(GRAPH_BATCH, np.random.default_rng(3))
    try:
        graph = graphs.ArraysTrainGraph(gm, gopt, lr_fn, pg.next, shapes, capacity=4)
        got = torch.cat([graph(0, 4), graph(4, 4)])
        want = train_mod.host_steps(em, eopt, lr_fn, pe.next, 0, 8)
    finally:
        pg.close()
        pe.close()
    assert torch.equal(got, want) and graph.graph.replays == 7
    for (pname, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), pname
    gm.eval()
    batches = [ds.host_batch(GRAPH_BATCH, np.random.default_rng(7)) for _ in range(3)]
    evals = graphs.ArraysEvalGraph(gm, shapes, 3)
    for _ in range(2):
        losses, maes, last = evals(iter(batches))
        want_l, want_m, want_last = train_mod.host_validation(gm, batches)
        assert torch.equal(losses, want_l) and torch.equal(maes, want_m)
        assert all(torch.equal(a, b) for a, b in zip(last, want_last))


@pytest.mark.parametrize("effect_name", ["comp_4c", "comp"])
def test_gen_dataset_on_card_matches_cpu(dev, tmp_path, monkeypatch, effect_name):
    """gen_dataset --device cuda against --device cpu on a tiny set: the same
    names and .ini; each target the CPU effect (the plain versions) on the
    card's own input within its EFFECT_TOL; kernel C (comp_4c) or L (comp)
    launched on whole files and no plain version run."""
    from signaltrain_tpu_torch.cli import gen_dataset
    from signaltrain_tpu_torch.data import audio_io, file_data
    from signaltrain_tpu_torch.dsp import effects
    from tests.torch_port_util import assert_effect_close

    monkeypatch.chdir(tmp_path)
    args = ["--dur", "0.5", "-n", "10", "-e", effect_name, "--device-batch", "4"]
    _cuda.reset_counts()
    stats = gen_dataset.main(["card"] + args)
    counts = {k: (c.launches, c.plain_calls) for k, c in _cuda.COUNTERS.items()}
    gen_dataset.main(["cpu"] + args + ["--device", "cpu"])
    kernel = "switched_one_pole" if effect_name == "comp_4c" else "lfilter"
    assert counts[kernel][0] == 3 and all(p == 0 for _, p in counts.values()), counts
    assert stats["card_ms_per_batch"] > 0 and len(stats["card_ms_batches"]) == 3
    for sub in ("Train", "Val"):
        assert sorted(os.listdir(f"card/{sub}")) == sorted(os.listdir(f"cpu/{sub}"))
    assert open("card/effect_info.ini").read() == open("cpu/effect_info.ini").read()
    cpu_fx = effects.make_effect(effect_name, device="cpu")
    for f in [f for f in os.listdir("card/Train") if f.startswith("target_")]:
        x, _ = audio_io.read_audio_file(f"card/Train/input_{f.split('_')[1]}_.wav")
        y, _ = audio_io.read_audio_file(f"card/Train/{f}")
        want, _ = cpu_fx.go_wc(x, file_data.parse_knob_string(f))
        assert_effect_close(effect_name, y, want)


# ---- train()'s surface on the card: the fetches one block and one epoch
# behind, the background writer's snapshots, dropout under a graph, lfilter
# over leading axes

@pytest.mark.parametrize("status_every", [2, 3])  # n_inner 4 and 1
def test_train_with_late_fetches_equals_synchronous_fetches(dev, tmp_path, monkeypatch,
                                                            status_every):
    """train() under graphs (losses read one block late, validation one epoch
    late, checkpoints and plots on the writer) against the same graphs read
    synchronously after every block: every loss, log line and weight
    bit-equal."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    monkeypatch.chdir(tmp_path)
    seed, steps, epochs = 6, 4, 3
    kw = dict(n_data_points=steps * GRAPH_BATCH, batch_size=GRAPH_BATCH, lr_max=1e-3, seed=seed,
              device=dev)
    effect = effects.Compressor_4c(device=dev)
    model, hist = train_mod.train(effect, epochs=epochs, cp_every=1, plot_every=2,
                                  status_every=status_every, **kw)
    n_inner = train_mod.pick_n_inner(steps, status_every)
    ref = st_model(device=dev, generator=torch.Generator().manual_seed(seed),
                   compute_dtype=BF16).train()
    opt, lr_fn = train_mod.make_optimizer(ref, 1e-3, steps * GRAPH_BATCH, epochs, GRAPH_BATCH)
    spec = ref.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    val_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size,
                                            augment=False)
    g = torch.Generator(device=dev)
    run = graphs.TrainGraph(ref, opt, lr_fn, batch_fn, GRAPH_BATCH, g, seed, n_inner)
    evals = graphs.EvalGraph(ref, val_fn, GRAPH_BATCH, g, 1)
    losses, maes = [], []
    for epoch in range(epochs):
        for block in range(steps // n_inner):
            losses += run(epoch * steps + block * n_inner, n_inner).cpu().tolist()
        ref.eval()
        maes.append(float(evals()[1].cpu()[0]))
        ref.train()
    assert hist["train_loss"] == losses and hist["val_mae_mean"] == maes
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), ref.parameters()))
    lines = open("val_err_mae.dat").read().split("\n")
    assert [float(ln.split()[2]) for ln in lines if ln] == [float(f"{m:.3e}") for m in maes]
    assert os.path.isfile("val_data_0.png") and os.path.isfile("conv_synth_imag.png")


def test_snapshot_read_by_the_writer_after_a_replay_holds_the_old_values(dev):
    """The writer reads a snapshot of the weights and Adam's state after the
    graph has replayed three more steps over the live tensors: it gets the
    values of the moment the snapshot was taken."""
    import threading

    from signaltrain_tpu_torch.training import checkpoint, graphs
    from signaltrain_tpu_torch.utils import async_io

    (m,), ((opt, lr_fn),), batch_fn, _ = _graph_setup(dev, "fused", BF16, n_models=1)
    graph = graphs.TrainGraph(m, opt, lr_fn, batch_fn, GRAPH_BATCH, torch.Generator(device=dev),
                              218, capacity=1)
    for step in range(2):  # the warm-up and a replay
        graph(step, 1)
    live = checkpoint.training_tensors(m, opt)
    want = {k: {n: v.cpu() for n, v in d.items()} for k, d in live.items()}
    snap = async_io.snapshot(live)
    gate, got = threading.Event(), {}
    writer = async_io.AsyncWriter()
    writer.submit(gate.wait)
    writer.submit(lambda: got.update(snap.to_host()))
    for step in range(2, 5):  # in place over the live tensors
        graph(step, 1)
    gate.set()
    writer.close(timeout=60)
    for key, d in want.items():
        for name, v in d.items():
            assert torch.equal(got[key][name], v), (key, name)
    assert not torch.equal(live["exp_avg"]["mpaec.aenc.fnn_dec.bias"].cpu(),
                           want["exp_avg"]["mpaec.aenc.fnn_dec.bias"])


def test_dropout_under_a_train_graph_equals_eager(dev):
    """A step with dropout (rate 0.2, the step's generator) captured as a
    CUDA graph and replayed: every loss and weight bit-equal to the same
    steps dispatched op by op."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import graphs, loss as loss_mod
    from signaltrain_tpu_torch.training import train as train_mod

    effect = effects.Compressor_4c(device=dev)
    models = [st_model(device=dev, generator=torch.Generator().manual_seed(2), compute_dtype=BF16,
                       dropout_rate=0.2).train() for _ in range(2)]
    opts = [train_mod.make_optimizer(m, 1e-3, 4000, 3, GRAPH_BATCH) for m in models]
    spec = models[0].spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    scale = loss_mod.freq_scale(spec.ft_size // 2 + 1, str(dev))

    def stepper(m, opt, g, out):
        def body():
            x, y, knobs = batch_fn(GRAPH_BATCH, g)
            m.zero_grad(set_to_none=True)
            y_hat, _, mag_hat = m(x, knobs, deterministic=False, generator=g)
            loss = loss_mod.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale)
            loss.backward()
            train_mod.clip_frontend_grads(m)
            opt.step()
            graphs._append(out, loss.detach())
        return body

    losses = [torch.zeros(1, device=dev) for _ in range(2)]
    gens = [torch.Generator(device=dev) for _ in range(2)]
    graph = graphs._Graph(stepper(models[0], opts[0][0], gens[0], losses[0]), gens[0])
    eager = stepper(models[1], opts[1][0], gens[1], losses[1])
    got, want = [], []
    for step in range(6):
        for g, opt, lr_fn in ((gens[0], *opts[0]), (gens[1], *opts[1])):
            synth_data.step_generator(g, 218, step)
            train_mod.set_lr(opt, lr_fn(step))
        graph()
        eager()
        got.append(float(losses[0]))
        want.append(float(losses[1]))
    assert graph.replays == 5 and got == want
    for p, q in zip(*(m.parameters() for m in models)):
        assert torch.equal(p, q)


@pytest.mark.parametrize("order", [1, 3])
def test_lfilter_folds_leading_axes_on_card(dev, order):
    from signaltrain_tpu_torch.dsp import iir

    g = torch.Generator(device=dev).manual_seed(order)
    x = torch.randn(2, 3, 4096, generator=g, device=dev) * 4.0
    b, a = iir.butter_lowpass(order, torch.full((2, 3), 0.05, device=dev))
    zi = torch.randn(2, 3, order, generator=g, device=dev)
    before, plain = iir.LFILTER.launches, iir.LFILTER.plain_calls
    y = iir.lfilter(b, a, x, zi)
    assert iir.LFILTER.launches == before + 1 and iir.LFILTER.plain_calls == plain
    ref = iir.lfilter_reference(b, a, x, zi)
    assert y.shape == ref.shape == (2, 3, 4096)
    assert torch.equal(y, ref)
    with pytest.raises(ValueError, match="order 2"):  # kernel L is built for orders 1 and 3
        iir.lfilter(*iir.butter_lowpass(2, torch.full((2, 3), 0.05, device=dev)), x)


def test_split_front_end_graph_under_nccl_is_the_gemm_graph(dev):
    """chip_smoke.py 10a at the tiny geometry: in a world of one under NCCL,
    the front-end split over a model group of one (its collectives captured
    in the train graphs) takes every sum of the gemm front-end in its order,
    so 5 bf16 steps match the gemm graph without a mesh bit for bit."""
    from signaltrain_tpu_torch.parallel import launch
    from tests import torch_port_tp_ranks

    (res,) = launch.spawn(torch_port_tp_ranks.nccl_world_one, [str(dev)], "nccl", timeout_s=300)
    assert res["replays"] == 4
    assert res["losses_equal"] and all(res["state_equal"].values()), res


# ---- TCN-300-C (models/tcn.py) on the card: its train graph, its float32
# convolutions, its phase marks; and the spectral train graphs as they were

TCN_OUT = 4096  # TCN-300-C's widths, a short window: 17,428 input samples
TCN_TOL = 2e-5  # float32 convolutions' largest gap to float64, as a share of the largest value


def _tcn_setup(dev, n_models=2, out=TCN_OUT):
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.kinds import build_model
    from signaltrain_tpu_torch.models.tcn import TCNSpec
    from signaltrain_tpu_torch.training import train as train_mod

    effect = effects.make_effect("comp_4c", device=dev)
    spec = TCNSpec(out_chunk_size=out)
    models = [build_model("tcn", device=dev, tcn=spec,
                          generator=torch.Generator().manual_seed(3)).train()
              for _ in range(n_models)]
    opts = [train_mod.make_optimizer(m, 1e-3, 4000, 3, 200) for m in models]
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    return models, opts, batch_fn


def test_tcn_train_graph_is_bit_equal_to_eager_steps(dev):
    """8 steps of a TCN's train graph (the warm-up, then 7 replays) against 8
    eager steps from the same weights and seeds: every loss, parameter and
    BatchNorm running statistic bit-equal."""
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.training import train as train_mod

    (gm, em), ((gopt, lr_fn), (eopt, _)), batch_fn = _tcn_setup(dev)
    graph = graphs.TrainGraph(gm, gopt, lr_fn, batch_fn, 4, torch.Generator(device=dev), 218,
                              capacity=8)
    got = torch.cat([graph(0, 1), graph(1, 7)])
    want = train_mod.eager_steps(em, eopt, lr_fn, batch_fn, 4, torch.Generator(device=dev), 218,
                                 0, 8)
    assert graph.graph.replays == 7 and torch.equal(got, want), (got, want)
    for (name, a), b in zip(gm.state_dict().items(), em.state_dict().values()):
        assert torch.equal(a, b), name
    assert int(gm.blocks[3].film.bn.num_batches_tracked) == 8


def test_tcn_float32_convolutions_hold_to_float64_where_tf32_does_not(dev, monkeypatch):
    """The TCN's forward and its convolution weights' gradients, training
    mode, at TCN-300-C's widths (batch 2, 4096 outputs), against
    tests/tcn_reference.py in float64: within TCN_TOL of the largest value
    with the model's own float32 convolutions, and beyond it with cuDNN
    allowed TF32 (the model's scope taken away)."""
    from signaltrain_tpu_torch.models import tcn as tcn_mod
    from tests import tcn_reference

    (model,), _, batch_fn = _tcn_setup(dev, n_models=1)
    x, y, knobs = batch_fn(2, torch.Generator(device=dev).manual_seed(5))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    spec = dict(n_blocks=4, dilation_growth=10, causal=True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in state.items()
              if k.endswith("conv1.weight")}
    want, _ = tcn_reference.forward({**state, **leaves}, x, knobs, spec)
    want_g = torch.autograd.grad(tcn_reference.logcosh(want, y), list(leaves.values()))
    want = want.detach()

    def gaps():
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        with model.numerics():
            y_hat = model(x, knobs)[0]
            model.loss(y_hat, y).backward()
        params = dict(model.named_parameters())
        g = [float((params[k].grad.double() - w).abs().max() / w.abs().max())
             for k, w in zip(leaves, want_g)]
        return float((y_hat.detach().double() - want).abs().max() / want.abs().max()), max(g)

    f32 = gaps()
    monkeypatch.setattr(tcn_mod, "float32_convolutions", contextlib.nullcontext)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = gaps()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    print("tcn gaps to float64 (forward, conv weight gradients): f32", f32, "tf32", tf32)
    assert max(f32) <= TCN_TOL and max(tf32) > TCN_TOL, (f32, tf32)


def test_tcn_train_graph_marks_its_blocks_phases(dev):
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.utils import profiling

    (model,), ((opt, lr_fn),), batch_fn = _tcn_setup(dev, n_models=1)
    graphs.TrainGraph(model, opt, lr_fn, batch_fn, 4, torch.Generator(device=dev), 218,
                      capacity=1)(0, 1)
    phases = profiling.graph_phases("train")
    names = [name for name, _ in phases.marks]
    assert names == (["synthesis", "forward"] + ["tcn.conv", "tcn.norm"] * 4
                     + ["forward", "loss", "backward", "update"])
    at = [n for _, n in phases.marks] + [phases.total]
    assert all(a < b for a, b in zip(at, at[1:])), phases  # every phase holds device work


TRAIN_NODES = {"bfloat16": 924, "float32": 826}  # the benchmark's cells, batch 200


@pytest.mark.parametrize("dtype", sorted(TRAIN_NODES))
def test_the_spectral_train_graphs_keep_their_node_counts(dev, dtype):
    from signaltrain_tpu_torch.training import graphs
    from signaltrain_tpu_torch.utils import profiling

    (m,), ((opt, lr_fn),), batch_fn, _ = _graph_setup(dev, "fused", getattr(torch, dtype),
                                                      n_models=1)
    graphs.TrainGraph(m, opt, lr_fn, batch_fn, 200, torch.Generator(device=dev), 218,
                      capacity=1)(0, 1)
    phases = profiling.graph_phases("train")
    assert [name for name, _ in phases.marks] == ["synthesis", "forward", "loss", "backward",
                                                  "update"]
    assert phases.total == TRAIN_NODES[dtype], phases
