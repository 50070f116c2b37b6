"""The port's model (signaltrain_tpu_torch.models) against the JAX package.

Random init: the JAX model's parameters (with the front-end matrices
perturbed off their DFT init, so a layout error cannot hide) go to the port
through training/checkpoint.params_to_state_dict. Shipped checkpoints: each
demo/model_comp4c_*.tar loads into the port with strict=True and runs two
windows next to the JAX model built from the same file. Tolerances: output
atol 1e-3, magnitude 3e-4, spectral-L1 <= 1e-3 (tests/test_torch_cross_
parity.py:146-150); the fused path's plain versions against the Pallas
interpreter as tests/test_fused_model.py holds the fused path to XLA.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.dsp import synths as jsynths
from signaltrain_tpu.models import autoencoder as jae
from signaltrain_tpu.models import st_model as jst
from signaltrain_tpu.utils.load_model import load_model as jload_model
from signaltrain_tpu_torch.dsp import synths
from signaltrain_tpu_torch.models import autoencoder, st_model
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import jax_params as _jax_params
from tests.torch_port_util import model_inputs as _inputs
from tests.torch_port_util import n, port_model as _port_model, t, tiny_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = tiny_spec()


@pytest.mark.parametrize("args", [
    dict(), dict(scale_factor=0.5, shrink_factor=1), dict(shrink_factor=2),
    dict(scale_factor=0.5, scale_scheme="legacy"), dict(scale_factor=2.0, num_knobs=3, sr=48000),
])
def test_compute_spec_matches_jax(args, capsys):
    got = st_model.compute_spec(**args)
    got_out = capsys.readouterr().out
    want = jst.compute_spec(**args)
    want_out = capsys.readouterr().out
    assert dataclasses_dict(got) == dataclasses_dict(want)
    assert got_out == want_out  # the same y_size warning, or none


def dataclasses_dict(spec):
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_mpaec_gemm_path_matches_jax_xla(size):
    spec = TINY if size == "tiny" else jst.compute_spec()
    jm, params = _jax_params(spec, seed=0)
    x, knobs = _inputs(spec, 3 if size == "tiny" else 2, seed=1)
    jy, jmag, jmh = jm.apply(params, jnp.asarray(x), jnp.asarray(knobs))
    with torch.no_grad():
        y, mag, mh = _port_model(spec, params, "gemm")(t(x), t(knobs))
    np.testing.assert_allclose(n(mag), np.asarray(jmag), atol=3e-4)
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-3)
    assert float(np.mean(np.abs(n(mh) - np.asarray(jmh)))) <= 1e-3


@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_mpaec_fused_path_plain_matches_jax_pallas(size):
    spec = TINY if size == "tiny" else jst.compute_spec()
    jm, params = _jax_params(spec, seed=2)
    x, knobs = _inputs(spec, 3 if size == "tiny" else 2, seed=3)
    jfused = jm.module.clone(frontend="pallas")  # interpreter off-TPU
    jy, jmag, jmh = jfused.apply(params, jnp.asarray(x), jnp.asarray(knobs))
    _cuda.reset_counts()
    with torch.no_grad():
        y, mag, mh = _port_model(spec, params, "fused")(t(x), t(knobs))
    assert cuda_frontend.ANALYSIS.plain_calls == 1 and cuda_frontend.SYNTHESIS.plain_calls == 1
    assert mag.shape == jmag.shape and mh.shape == jmh.shape  # frame-major
    np.testing.assert_allclose(n(mag), np.asarray(jmag), atol=3e-4)
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-3)
    assert float(np.mean(np.abs(n(mh) - np.asarray(jmh)))) <= 1e-3


def test_gemm_and_fused_paths_agree():
    spec = TINY
    _, params = _jax_params(spec, seed=4)
    x, knobs = _inputs(spec, 4, seed=5)
    with torch.no_grad():
        yg, magg, mhg = _port_model(spec, params, "gemm")(t(x), t(knobs))
        yf, magf, mhf = _port_model(spec, params, "fused")(t(x), t(knobs))
    np.testing.assert_allclose(n(yf), n(yg), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(n(magf.transpose(0, 1)), n(magg), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(n(mhf.transpose(0, 1)), n(mhg), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("skip", ["res", "sf", ""])
def test_autoencoder_both_layouts_match_jax(skip):
    rng = np.random.default_rng(6)
    b, tf, f, k, ot = 2, 25, 7, 4, 9
    x = rng.normal(size=(b, tf, f)).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=(b, k)).astype(np.float32)
    jmod = jae.AsymAutoEncoder(time_frames=tf, n_knobs=k, output_frames=ot)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(knobs)))
    want, _ = jmod.apply(params, jnp.asarray(x), jnp.asarray(knobs), skip_connections=skip)
    ae = autoencoder.AsymAutoEncoder(tf, 64, k, ot, device="cpu")
    sd = {}
    for name, node in params["params"].items():
        sd[f"{name}.weight"] = t(np.asarray(node["kernel"]).T)
        sd[f"{name}.bias"] = t(node["bias"])
    ae.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = ae(t(x), t(knobs), skip_connections=skip)
        got_fm = ae.frame_major(t(x).transpose(0, 1).contiguous(), t(knobs), skip_connections=skip)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(got_fm.transpose(0, 1)), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        ae(t(x), t(knobs), skip_connections="exp")


def test_param_count_matches_jax():
    jm = jst.st_model()
    want = jst.param_count(jm.init(jax.random.PRNGKey(0)))
    got = sum(p.numel() for p in st_model.st_model(device="cpu").parameters())
    assert got == want
    assert 4.0e6 < got < 4.5e6


@pytest.mark.parametrize("name", ["model_comp4c_demo.tar", "model_comp4c_4k.tar",
                                  "model_comp4c_refdefault.tar", "model_comp4c_8k4k.tar"])
def test_shipped_checkpoint_strict_load_and_forward(name):
    path = os.path.join(REPO, "demo", name)
    jm, jparams, _ = jload_model(path, compute_dtype=jnp.float32)
    model, rv = load_model(path, device="cpu")  # strict=True inside
    with pytest.raises(FileNotFoundError):
        load_model(path + ".missing", device="cpu")
    assert model.spec == st_model.ModelSpec(**dataclasses_dict(jm.spec))
    x, knobs = _inputs(jm.spec, 2, seed=8)
    jy, jmag, jmh = jm.apply(jparams, jnp.asarray(x), jnp.asarray(knobs))
    with torch.no_grad():
        y, mag, mh = model(t(x), t(knobs))  # default fused path, plain versions on CPU
    np.testing.assert_allclose(n(mag.transpose(0, 1)), np.asarray(jmag), atol=3e-4)
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-3)
    assert float(np.mean(np.abs(n(mh.transpose(0, 1)) - np.asarray(jmh)))) <= 1e-3


def test_music_like_clip_matches_jax():
    np.testing.assert_array_equal(synths.music_like_clip(2.0, seed=3),
                                  jsynths.music_like_clip(2.0, seed=3))
