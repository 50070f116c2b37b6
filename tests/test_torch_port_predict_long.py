"""The port's serving path (inference/predict_long, the CLI) against the JAX
package, on the CPU (the kernels' plain versions).

predict_long on demo/model_comp4c_demo.tar with a ~1.5 s clip: atol 1e-3 and
equal lengths (the model-output tolerance of tests/test_torch_cross_parity.
py:147). calc_ct: atol 1e-5 (the compressor's, tests/test_pallas_smoother.py:
185).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from signaltrain_tpu.data import audio_io as jaudio_io
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.inference import predict_long as jpl
from signaltrain_tpu.models import st_model as jst
from signaltrain_tpu.utils.load_model import load_model as jload_model
from signaltrain_tpu_torch.cli import predict_long as cli
from signaltrain_tpu_torch.data import audio_io
from signaltrain_tpu_torch.dsp import effects, synths
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models import st_model
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "model_comp4c_demo.tar")
KNOBS_WC = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)


@pytest.fixture(scope="module")
def demo():
    jm, jparams, rv = jload_model(DEMO, compute_dtype=jnp.float32)
    model, _ = load_model(DEMO, device="cpu")
    kr = np.asarray(rv["knob_ranges"], np.float32)
    knobs_nn = (KNOBS_WC - kr[:, 0]) / (kr[:, 1] - kr[:, 0]) - 0.5
    clip = synths.music_like_clip(1.5, seed=5)
    return jm, jparams, model, knobs_nn, clip


def test_predict_long_matches_jax(demo):
    jm, jparams, model, knobs_nn, clip = demo
    want = jpl.predict_long(clip, knobs_nn, jm, jparams)
    got = pl.predict_long(clip, knobs_nn, model)
    assert got.shape == want.shape == (len(clip) - (8192 - 2048),)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_predict_long_int16_and_device_result(demo):
    jm, jparams, model, knobs_nn, clip = demo
    clip = clip[: 8192 + 5 * 2048 + 100]
    y = pl.predict_long(clip, knobs_nn, model)
    y16 = pl.predict_long(clip, knobs_nn, model, out_dtype="int16")
    assert y16.dtype == np.int16
    np.testing.assert_array_equal(y16, audio_io.to_pcm16(y))
    j16 = np.asarray(jpl.predict_long(clip, knobs_nn, jm, jparams, out_dtype="int16"))
    assert np.abs(y16.astype(np.int32) - j16.astype(np.int32)).max() <= 33  # 1e-3 of full scale
    with pytest.raises(ValueError):
        pl.predict_long(clip, knobs_nn, model, out_dtype="float16")
    dev = pl.predict_long(clip, knobs_nn, model, return_device=True)
    assert isinstance(dev, torch.Tensor) and dev.device == model.device
    np.testing.assert_array_equal(n(dev), y)


def _tiny(seed):
    spec = jst.ModelSpec(
        scale_factor=512 / 8192.0, shrink_factor=4.0, num_knobs=4, sr=44100,
        in_chunk_size=512, out_chunk_size=128, ft_size=64, hop_size=24,
        time_frames=25, output_time_frames=9,
    )
    jm = jst.STModel(spec)
    params = jm.init(jax.random.PRNGKey(seed))
    model = st_model.STModel(st_model.ModelSpec(**spec.__dict__), device="cpu")
    model.load_state_dict(checkpoint.params_to_state_dict(jax.device_get(params)), strict=True)
    return jm, params, model.eval()


@pytest.mark.parametrize("length,compand", [(512 + 10 * 128, False), (5000, False),
                                            (3001, True)])
def test_predict_long_tiny_matches_jax(length, compand):
    """Exact tiling with no trim (11 windows), a trimmed tail, and companding."""
    jm, params, model = _tiny(seed=length)
    rng = np.random.default_rng(length)
    signal = (rng.normal(size=length) * 0.3).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=4).astype(np.float32)
    want = jpl.predict_long(signal, knobs, jm, params, compand=compand)
    got = pl.predict_long(signal, knobs, model, compand=compand)
    assert got.shape == want.shape == (length - (512 - 128),)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_predict_long_shorter_than_one_output_raises():
    """A signal no longer than the lookback (chunk - out_chunk) has no full
    output window. The port does not raise there: like the JAX package it
    runs the 16 windows of the smallest bucket over the zero-padded signal
    and cuts them at the negative keep (1,964 samples for 300), and its
    output is held to the JAX package's at the model's 1e-3."""
    jm, params, model = _tiny(seed=11)
    signal = np.full(300, 0.1, np.float32)
    got = pl.predict_long(signal, np.zeros(4, np.float32), model)
    want = jpl.predict_long(signal, np.zeros(4, np.float32), jm, params)
    assert got.shape == want.shape == (1964,)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # one sample more than the lookback gives one window in both
    signal = np.full(511, 0.1, np.float32)
    got = pl.predict_long(signal, np.zeros(4, np.float32), model)
    want = jpl.predict_long(signal, np.zeros(4, np.float32), jm, params)
    assert got.shape == want.shape == (127,)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_predict_long_many_super_batches(monkeypatch):
    """The super-batch loop (1024 windows at full size) gives the same audio."""
    _, _, model = _tiny(seed=3)
    signal = (np.random.default_rng(4).normal(size=512 + 40 * 128 + 17) * 0.3).astype(np.float32)
    knobs = np.zeros(4, np.float32)
    whole = pl.predict_long(signal, knobs, model)
    monkeypatch.setattr(pl, "SUPER_BATCH", 7)
    np.testing.assert_allclose(pl.predict_long(signal, knobs, model), whole, atol=1e-6)


def test_calc_ct_matches_jax(demo):
    clip = demo[4][:30000]
    want = jpl.calc_ct(clip, jeffects.Compressor_4c(), KNOBS_WC, 2048, 8192)
    got = pl.calc_ct(clip, effects.Compressor_4c(device="cpu"), KNOBS_WC, 2048, 8192)
    assert got.shape == want.shape == clip.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_audio_io_roundtrip_and_resample(tmp_path):
    rng = np.random.default_rng(9)
    x = (rng.uniform(-0.9, 0.9, size=3000)).astype(np.float32)
    p16 = str(tmp_path / "a16.wav")
    audio_io.write_audio_file(p16, audio_io.to_pcm16(x), sr=22050)
    got, sr = audio_io.read_audio_file(p16, sr=44100)
    want, _ = jaudio_io.read_audio_file(p16, sr=44100)
    assert sr == 44100 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(audio_io.to_pcm16(x), jaudio_io.to_pcm16(x))
    np.testing.assert_array_equal(n(audio_io.to_pcm16(torch.from_numpy(x))), jaudio_io.to_pcm16(x))
    with pytest.raises(ValueError):
        audio_io.read_audio_file(str(tmp_path / "x.mp3"))


def test_cli_cpu_writes_wavs(tmp_path, monkeypatch, demo):
    model, knobs_nn, clip = demo[2], demo[3], demo[4][:8192 + 6 * 2048]
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, 44100, clip)
    monkeypatch.chdir(tmp_path)
    cli.main([DEMO, wav, "-e", "comp_4c", "--knobs=-25,4,0.005,0.02", "--device", "cpu"])
    tag = "__-25.0__4.0__0.005__0.02"
    for stem in ("pl_input", "pl_pred", "pl_st", "pl_ct"):
        assert (tmp_path / f"{stem}{tag}.wav").exists(), stem
    _, pred = wavfile.read(str(tmp_path / f"pl_pred{tag}.wav"))
    want = pl.predict_long(clip, knobs_nn, model)
    assert pred.shape == clip.shape
    np.testing.assert_array_equal(pred[-len(want):], want)
    assert np.all(pred[: len(clip) - len(want)] == 0)
    _, st = wavfile.read(str(tmp_path / f"pl_st{tag}.wav"))
    y_st, _ = effects.Compressor_4c(device="cpu").go_wc(clip, KNOBS_WC)
    np.testing.assert_array_equal(st, n(y_st))
