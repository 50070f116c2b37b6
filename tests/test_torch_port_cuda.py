"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from signaltrain_tpu_torch/csrc at first use); without a card they
skip. Run them on a GPU machine without the JAX package's test setup:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances are those the port's CPU tests hold the plain versions to against
the JAX package: magnitude 2e-5, wrapped phase 2e-4 on the bins of magnitude
>= 1e-2 and 2e-6 / mag below (assert_analysis_close), synthesis 3e-4,
smoother 1e-6 (its chunked schedule bit-equal to its row schedule), model
output 1e-3; gradients 5e-4 + 5e-4*|g| element by element, kernel D's with well-conditioned phase cotangents included; kernel
D's with unit-normal phase cotangents on every bin (heavy-tailed and
ill-conditioned: max|dW| is 50-24,000 against a median of 0.7-18) against a
float64 plain version with the slack that each element's conditioning gives
(assert_close_where_conditioned); the whole model's gradients (largest per leaf 1e-5 to
1e-1) within 1e-3 * max|g| of the leaf, no absolute floor.
"""

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
        before = cuda_frontend.ANALYSIS.launches
        mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop)
        assert cuda_frontend.ANALYSIS.launches == before + 1
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


@pytest.mark.parametrize("b,n", [(1, 8), (3, 50), (1024, 40), (33, 2 * 512 + 137), (1, 20000),
                                 (9, 257), (5, 256), (2, 513), (17, 7)])
def test_smoother_kernel_matches_plain(dev, b, n):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
    x = torch.randn(b, n, generator=g, device=dev)
    aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    before, chunked = cuda_kernels.SMOOTHER.launches, cuda_kernels.SMOOTHER_CHUNKED.launches
    s = cuda_kernels.switched_one_pole_batched(x, aa, ar)
    assert cuda_kernels.SMOOTHER.launches == before + 1
    assert cuda_kernels.SMOOTHER_CHUNKED.launches == chunked  # the row schedule
    ref = cuda_kernels.switched_one_pole_reference(x, aa, ar)
    torch.cuda.synchronize()
    assert torch.all(s[:, 0] == 0)
    torch.testing.assert_close(s, ref, atol=1e-6, rtol=0)


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
    torch.testing.assert_close(s, plain, atol=1e-6, rtol=0)
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
    torch.testing.assert_close(s, plain, atol=1e-6, rtol=0)


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
    before = cuda_frontend.ANALYSIS_BWD.launches
    dxp, dw = cuda_frontend.fused_analysis_bwd(xp, w, inp["a"], inp["c"], ft, hop)
    dxp2, dw2 = cuda_frontend.fused_analysis_bwd(xp, w, inp["a"], inp["c"], ft, hop)
    assert cuda_frontend.ANALYSIS_BWD.launches == before + 2
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
