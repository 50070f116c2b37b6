"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from signaltrain_tpu_torch/csrc at first use); without a card they
skip. Run them on a GPU machine without the JAX package's test setup:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances are those the port's CPU tests hold the plain versions to against
the JAX package: magnitude 2e-5, wrapped phase 2e-4, synthesis 3e-4,
smoother 1e-6, model output 1e-3.
"""

import os

import numpy as np
import pytest
import torch

from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, cuda_kernels, frontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _wrapped(d):
    return torch.remainder(d + np.pi, 2 * np.pi) - np.pi


GEOMS = [(64, 24, 512, 5), (1024, 384, 8192, 3), (100, 30, 700, 7), (1024, 384, 8192, 130)]


@pytest.mark.parametrize("ft,hop,chunk,b", GEOMS)
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
    torch.testing.assert_close(mag, rmag, atol=2e-5, rtol=2e-5)
    d = _wrapped(phs.double() - rphs.double()).abs()
    assert float((d - (2e-4 + 2e-4 * rphs.double().abs())).max()) <= 0
    assert torch.all(mag[0] == np.float32(1e-18)) and torch.all(phs[0] == 0)


@pytest.mark.parametrize("ft,hop,chunk,b", GEOMS)
def test_synthesis_kernel_matches_plain(dev, ft, hop, chunk, b):
    g = torch.Generator(device=dev).manual_seed(ft + b + 1)
    half, ot = ft // 2 + 1, 9
    sy = frontend.Synthesis(ft, hop, device=dev)
    with torch.no_grad():
        w = sy.stacked_weights()
        mag = torch.nn.functional.softplus(torch.randn(ot, b, half, generator=g, device=dev))
        phs = torch.randn(ot, b, half, generator=g, device=dev) * 2.0
        wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop)
        ref = cuda_frontend.fused_synthesis_reference(mag, phs, w, ft, hop)
    torch.cuda.synchronize()
    assert wave.shape == ref.shape == (b, (ot - 1) * hop - ft)
    torch.testing.assert_close(wave, ref, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("b,n", [(1, 8), (3, 50), (1024, 40), (33, 2 * 512 + 137), (1, 20000),
                                 (9, 257), (5, 256), (2, 513), (17, 7)])
def test_smoother_kernel_matches_plain(dev, b, n):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + n)
    x = torch.randn(b, n, generator=g, device=dev)
    aa = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    ar = torch.empty(b, device=dev).uniform_(0.9, 0.999, generator=g)
    before = cuda_kernels.SMOOTHER.launches
    s = cuda_kernels.switched_one_pole_batched(x, aa, ar)
    assert cuda_kernels.SMOOTHER.launches == before + 1
    ref = cuda_kernels.switched_one_pole_reference(x, aa, ar)
    torch.cuda.synchronize()
    assert torch.all(s[:, 0] == 0)
    torch.testing.assert_close(s, ref, atol=1e-6, rtol=0)


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
    wr = torch.zeros(64, 66, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError):
        cuda_frontend.fused_analysis(x, wr, 64, 24)


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
