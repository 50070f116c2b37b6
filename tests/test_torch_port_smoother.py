"""The port's envelope smoother and comp_4c effect against the JAX package.

The plain version of kernel C (dsp/iir.switched_one_pole, reached through
ops/cuda_kernels.switched_one_pole_batched on CPU tensors) is held to the
Pallas kernel in interpret mode and to the lax.scan smoother at atol 1e-6
(tests/test_pallas_smoother.py:52); the compressor and Compressor_4c to the
JAX compressor at atol 1e-5 (tests/test_pallas_smoother.py:185: log10/exp/
pow round differently in the two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.dsp import compressors as jcomp
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import iir as jiir
from signaltrain_tpu.ops import pallas_kernels as pk
from signaltrain_tpu_torch.dsp import compressors, effects, iir
from signaltrain_tpu_torch.ops import _cuda, cuda_kernels
from tests.torch_port_util import n, t


def _case(b, length, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, length)).astype(np.float32)
    aa = rng.uniform(0.9, 0.999, size=(b,)).astype(np.float32)
    ar = rng.uniform(0.9, 0.999, size=(b,)).astype(np.float32)
    return g, aa, ar


@pytest.mark.parametrize(
    "b,length",
    [
        (1, 8),          # minimum
        (3, 50),         # N not a multiple of 8
        (1024, 40),      # batch exactly one (8, 128) tile: the round-5 crash width
        (4, 2 * 512 + 137),  # longer than one 512-step time block
        (200, 300),      # training-like batch, per-example alphas
    ],
)
def test_plain_smoother_matches_pallas_and_scan(b, length):
    g, aa, ar = _case(b, length, seed=b * 1000 + length)
    _cuda.reset_counts()
    got = n(cuda_kernels.switched_one_pole_batched(t(g), t(aa), t(ar)))
    assert cuda_kernels.SMOOTHER.plain_calls == 1 and cuda_kernels.SMOOTHER.launches == 0
    want_kernel = pk.switched_one_pole_batched(jnp.asarray(g), jnp.asarray(aa),
                                               jnp.asarray(ar), interpret=True)
    want_scan = jax.vmap(jiir.switched_one_pole)(jnp.asarray(g), jnp.asarray(aa),
                                                 jnp.asarray(ar))
    assert np.all(got[:, 0] == 0.0)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want_scan), atol=1e-6)


def test_plain_smoother_scalar_alphas_1d():
    g, aa, ar = _case(1, 500, seed=3)
    got = iir.switched_one_pole(t(g[0]), float(aa[0]), float(ar[0]))
    want = jiir.switched_one_pole(jnp.asarray(g[0]), aa[0], ar[0])
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)


def test_smoother_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        cuda_kernels.switched_one_pole_batched(torch.zeros(1, 8, device="meta"),
                                               torch.zeros(1, device="meta"),
                                               torch.zeros(1, device="meta"))


def _knobs(b, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, size=(b,)).astype(np.float32)
            for lo, hi in ((-30, 0), (1, 5), (1e-3, 4e-2), (1e-3, 4e-2))]


def test_compressor_4controls_batched_per_example():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(6, 300)) * 0.5).astype(np.float32)
    th, ra, at, re = _knobs(6, seed=12)
    want = jcomp.compressor_4controls(jnp.asarray(x), jnp.asarray(th), jnp.asarray(ra),
                                      jnp.asarray(at), jnp.asarray(re))
    got = compressors.compressor_4controls(t(x), t(th), t(ra), t(at), t(re))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_compressor_4controls_1d_scalar_knobs():
    x = (np.random.default_rng(13).normal(size=(2000,)) * 0.5).astype(np.float32)
    args = (-20.0, 3.0, 0.005, 0.02)
    want = jcomp.compressor_4controls(jnp.asarray(x), *args)
    got = compressors.compressor_4controls(t(x), *args)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_compressor_4c_go_wc_and_go_batch():
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(4, 1500)) * 0.4).astype(np.float32)
    knobs_wc = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)
    knobs_nn = rng.uniform(-0.5, 0.5, size=(4, 4)).astype(np.float32)
    jfx = jeffects.Compressor_4c()
    fx = effects.Compressor_4c(device="cpu")

    y, x_out = fx.go_wc(x[0], knobs_wc)
    jy, _ = jfx.go_wc(jnp.asarray(x[0]), jnp.asarray(knobs_wc))
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(n(x_out), x[0])

    yb, _ = fx.go_batch(x, knobs_nn)
    jyb, _ = jfx.go_batch(jnp.asarray(x), jnp.asarray(knobs_nn))
    np.testing.assert_allclose(n(yb), np.asarray(jyb), atol=1e-5)

    np.testing.assert_allclose(n(fx.knobs_wc(knobs_nn)),
                               np.asarray(jfx._knobs_wc_batch(jnp.asarray(knobs_nn))),
                               rtol=1e-6)
    yg, _ = fx.go(x[1], knobs_nn[1])
    jyg, _ = jfx.go(jnp.asarray(x[1]), jnp.asarray(knobs_nn[1]))
    np.testing.assert_allclose(n(yg), np.asarray(jyg), atol=1e-5)


def test_mu_law_matches_jax():
    y = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_allclose(n(compressors.mu_compand(t(y))),
                               np.asarray(jcomp.mu_compand(jnp.asarray(y))), atol=1e-6)
    np.testing.assert_allclose(n(compressors.mu_decompand(t(y))),
                               np.asarray(jcomp.mu_decompand(jnp.asarray(y))), atol=1e-6)


def test_make_effect():
    fx = effects.make_effect("comp_4c", sr=22050, device="cpu")
    assert isinstance(fx, effects.Compressor_4c) and fx.sr == 22050 and len(fx.knob_names) == 4
    for name in ("comp", "echo", "denoise", "no_such_effect"):
        with pytest.raises(ValueError):
            effects.make_effect(name, device="cpu")
