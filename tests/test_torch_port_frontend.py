"""The port's front-end (signaltrain_tpu_torch.ops) against the JAX package.

windows: exact. framing: values. Analysis / Synthesis GEMM path: against the
JAX XLA path with the same random weights. The plain versions of kernels A
and B: against the Pallas kernels in interpret mode. Tolerances are those of
tests/test_pallas_frontend.py: magnitude 2e-5, wrapped phase 2e-4, synthesis
3e-4 (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import framing as jframing
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu.ops import windows as jwindows
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, framing, frontend, windows
from tests.torch_port_util import FLAGSHIP, SMALL, assert_phase_close, n, t

GEOMS = [dict(SMALL, b=5), dict(FLAGSHIP, b=2)]
IDS = ["small", "flagship"]


@pytest.mark.parametrize("ft,hop", [(64, 24), (1024, 384), (512, 192), (100, 30)])
def test_windows_exact(ft, hop):
    np.testing.assert_array_equal(windows.hamming(ft), jwindows.hamming(ft))
    for a, b in zip(windows.dft_basis(ft), jwindows.dft_basis(ft)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(windows.gla_synthesis_window(ft, hop),
                                  jwindows.gla_synthesis_window(ft, hop))
    for a, b in zip(windows.analysis_init(ft), jwindows.analysis_init(ft)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(windows.synthesis_init(ft, hop), jwindows.synthesis_init(ft, hop)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ft,hop,length,pad", [(64, 24, 512, 64), (1024, 384, 8192, 1024),
                                               (16, 5, 37, 0)])
def test_frame_signal_and_overlap_add(ft, hop, length, pad):
    rng = np.random.default_rng(ft + length)
    x = rng.normal(size=(3, length)).astype(np.float32)
    got = framing.frame_signal(t(x), ft, hop, pad)
    want = jframing.frame_signal(jnp.asarray(x), ft, hop, pad)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    frames = rng.normal(size=(2, 7, ft)).astype(np.float32)
    np.testing.assert_allclose(n(framing.overlap_add(t(frames), hop)),
                               np.asarray(jframing.overlap_add(jnp.asarray(frames), hop)),
                               atol=1e-6)


def test_frame_signal_too_short_raises():
    with pytest.raises(ValueError):
        framing.frame_signal(torch.zeros(1, 10), 64, 24, 0)


@pytest.mark.parametrize("length,size,overlap", [(10, 5, 2), (5000, 512, 384), (300, 512, 384),
                                                 (512, 512, 384), (8192 + 3 * 2048, 8192, 6144)])
def test_sliding_window(length, size, overlap):
    x = np.arange(length, dtype=np.float32)
    got = framing.sliding_window(t(x), size, overlap)
    want = jframing.sliding_window(jnp.asarray(x), size, overlap)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    if (length, size, overlap) == (10, 5, 2):
        np.testing.assert_array_equal(n(got), [[0, 1, 2, 3, 4], [3, 4, 5, 6, 7], [6, 7, 8, 9, 0]])


def _random_frontend(ft, hop, seed):
    """JAX Analysis/Synthesis params with random (not windowed-DFT) matrices,
    so a transposed or mirrored layout cannot pass; and the port's modules
    holding the same values."""
    rng = np.random.default_rng(seed)
    mats = {k: (rng.normal(size=(ft, ft)) / np.sqrt(ft)).astype(np.float32)
            for k in ("ar", "ai", "sr", "si")}
    an = frontend.Analysis(ft, hop, device="cpu")
    sy = frontend.Synthesis(ft, hop, device="cpu")
    with torch.no_grad():
        an.conv_analysis_real.weight.copy_(t(mats["ar"])[:, None, :])
        an.conv_analysis_imag.weight.copy_(t(mats["ai"])[:, None, :])
        sy.conv_synthesis_real.weight.copy_(t(mats["sr"])[:, None, :])
        sy.conv_synthesis_imag.weight.copy_(t(mats["si"])[:, None, :])
    jan = {"params": {"w_real": jnp.asarray(mats["ar"]), "w_imag": jnp.asarray(mats["ai"])}}
    jsy = {"params": {"w_real": jnp.asarray(mats["sr"]), "w_imag": jnp.asarray(mats["si"])}}
    return an, sy, jan, jsy, mats


@pytest.mark.parametrize("g", GEOMS, ids=IDS)
def test_analysis_gemm_matches_xla(g):
    ft, hop, chunk, b = g["ft"], g["hop"], g["chunk"], g["b"]
    an, _, jan, _, _ = _random_frontend(ft, hop, seed=1)
    x = (np.random.default_rng(0).normal(size=(b, chunk)) * 0.3).astype(np.float32)
    jmod = jfrontend.Analysis(ft_size=ft, hop_size=hop, compute_dtype=jnp.float32)
    jre, jim = jmod.apply(jan, jnp.asarray(x))
    with torch.no_grad():
        re, im = an(t(x))
    np.testing.assert_allclose(n(re), np.asarray(jre), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(n(im), np.asarray(jim), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("g", GEOMS, ids=IDS)
def test_synthesis_gemm_matches_xla(g):
    ft, hop, b = g["ft"], g["hop"], g["b"]
    half, ot = ft // 2 + 1, 9
    _, sy, _, jsy, _ = _random_frontend(ft, hop, seed=2)
    rng = np.random.default_rng(3)
    re = rng.normal(size=(b, ot, half)).astype(np.float32)
    im = rng.normal(size=(b, ot, half)).astype(np.float32)
    jmod = jfrontend.Synthesis(ft_size=ft, hop_size=hop, compute_dtype=jnp.float32)
    want = jmod.apply(jsy, jnp.asarray(re), jnp.asarray(im))
    with torch.no_grad():
        got = sy(t(re), t(im))
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), np.asarray(want), atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("g", GEOMS, ids=IDS)
def test_fused_analysis_plain_matches_pallas(g):
    ft, hop, chunk, b = g["ft"], g["hop"], g["chunk"], g["b"]
    half = ft // 2 + 1
    an, _, _, _, mats = _random_frontend(ft, hop, seed=4)
    x = (np.random.default_rng(5).normal(size=(b, chunk)) * 0.3).astype(np.float32)
    xp = np.pad(x, ((0, 0), (ft, ft)))
    jw = pf.stack_analysis_weights(jnp.asarray(mats["ar"]), jnp.asarray(mats["ai"]), half)
    jmag, jphs = pf.fused_analysis(jnp.asarray(xp), jw, ft, hop, half, jnp.float32, True)

    _cuda.reset_counts()
    with torch.no_grad():
        mag, phs = cuda_frontend.fused_analysis(t(xp), an.stacked_weights(), ft, hop)
    assert cuda_frontend.ANALYSIS.plain_calls == 1 and cuda_frontend.ANALYSIS.launches == 0
    assert mag.shape == jmag.shape == ((chunk + ft) // hop + 1, b, half)
    np.testing.assert_allclose(n(mag), np.asarray(jmag), atol=2e-5, rtol=2e-5)
    assert_phase_close(n(phs), np.asarray(jphs), atol=2e-4, rtol=2e-4)
    # edge frames cover only padding: the floor and atan2(0, 1e-7), exactly
    assert np.all(n(mag)[0] == np.float32(1e-18)) and np.all(n(phs)[0] == 0.0)
    assert np.all(n(mag)[-1] == np.float32(1e-18)) and np.all(n(phs)[-1] == 0.0)


@pytest.mark.parametrize("g", GEOMS, ids=IDS)
def test_fused_synthesis_plain_matches_pallas(g):
    ft, hop, b = g["ft"], g["hop"], g["b"]
    half, ot = ft // 2 + 1, 9
    _, sy, _, _, mats = _random_frontend(ft, hop, seed=6)
    rng = np.random.default_rng(7)
    mag = np.log1p(np.exp(rng.normal(size=(ot, b, half)))).astype(np.float32)
    phs = (rng.normal(size=(ot, b, half)) * 2.0).astype(np.float32)
    jwr, jwi = jfrontend.fold_synthesis_weights(jnp.asarray(mats["sr"]),
                                                jnp.asarray(mats["si"]), half)
    jw = pf.stack_synthesis_weights(jwr, jwi, half)
    want = pf.fused_synthesis(jnp.asarray(mag), jnp.asarray(phs), jw, ft, hop, half,
                              jnp.float32, True)

    _cuda.reset_counts()
    with torch.no_grad():
        got = cuda_frontend.fused_synthesis(t(mag), t(phs), sy.stacked_weights(), ft, hop)
    assert cuda_frontend.SYNTHESIS.plain_calls == 1 and cuda_frontend.SYNTHESIS.launches == 0
    assert got.shape == want.shape == (b, (ot - 1) * hop - ft)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=3e-4, rtol=3e-4)


def test_fold_matches_jax():
    ft = 64
    half = ft // 2 + 1
    rng = np.random.default_rng(8)
    wr, wi = (rng.normal(size=(2, ft, ft))).astype(np.float32)
    got = frontend.fold_synthesis_weights(t(wr), t(wi), half)
    want = jfrontend.fold_synthesis_weights(jnp.asarray(wr), jnp.asarray(wi), half)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def test_wrappers_refuse_other_devices():
    """A tensor that is on neither the CPU nor a CUDA card is refused: the
    wrappers launch a kernel or run the plain version, nothing else."""
    xp = torch.zeros(1, 3 * 64, device="meta")
    w = torch.zeros(64, 66, device="meta")
    with pytest.raises(ValueError):
        cuda_frontend.fused_analysis(xp, w, 64, 24)
    with pytest.raises(ValueError):
        cuda_frontend.fused_synthesis(torch.zeros(9, 1, 33, device="meta"),
                                      torch.zeros(9, 1, 33, device="meta"),
                                      torch.zeros(66, 64, device="meta"), 64, 24)
