"""The port's observability surface against the JAX package, on the CPU.

* ``return_acts``: the 30 activations and the three outputs of the port's
  model against ``model.apply(..., return_acts=True)`` with the JAX weights
  carried across (``params_to_state_dict``), at the model-output tolerance
  (atol 1e-3, tests/test_torch_cross_parity.py:146-150);
* dropout: deterministic with ``dropout_rate`` > 0 equal to the JAX model's
  deterministic output (same tolerance); the mask drops whole (example, bin)
  rows, scales the kept ones by 1 / (1 - p) and repeats from the generator;
* ``utils/flops.py`` equal to the JAX package's counts, and no MFU on a
  device it does not know;
* ``utils/plots.py``: the four front-end matrices and the two spectrograms
  the JAX package's ``plot_spectrograms`` draws, from carried weights, and
  the JAX file names (``num_plots=2``);
* ``utils/async_io.py``: the writer's FIFO order and its first failure
  raised at ``close()`` (as tests/test_misc_utils.py:100-150 holds the JAX
  writer), and a snapshot that survives an in-place update of its original.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.models import st_model as jst
from signaltrain_tpu.utils import flops as jflops
from signaltrain_tpu.utils import plots as jplots
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.models import autoencoder
from signaltrain_tpu_torch.models import st_model as pst
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.utils import async_io, flops, plots
from tests.torch_port_util import jax_params, model_inputs, n, port_model, t, tiny_spec

ATOL = 1e-3  # the model-output tolerance


@pytest.mark.parametrize("frontend", ["gemm", "fused"])
def test_return_acts_match_jax(frontend):
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=7)
    x, knobs = model_inputs(spec, 3, seed=8)
    jy, jmag, jmh, jacts = jm.apply(params, jnp.asarray(x), jnp.asarray(knobs), return_acts=True)
    with torch.no_grad():  # return_acts takes the batch-major path on either front-end
        y, mag, mh, acts = port_model(spec, params, frontend)(t(x), t(knobs), return_acts=True)
    assert len(acts) == len(jacts) == 4 + 10 + 10 + 6
    for i, (a, ja) in enumerate(zip(acts, jacts)):
        assert tuple(a.shape) == ja.shape, i
        np.testing.assert_allclose(n(a), np.asarray(ja, np.float32), atol=ATOL, err_msg=str(i))
    for a, ja in ((y, jy), (mag, jmag), (mh, jmh)):
        assert tuple(a.shape) == ja.shape
        np.testing.assert_allclose(n(a), np.asarray(ja), atol=ATOL)


@pytest.mark.parametrize("frontend", ["gemm", "fused"])
def test_deterministic_dropout_matches_jax(frontend):
    spec = tiny_spec()
    _, params = jax_params(spec, seed=9)
    jm = jst.STModel(spec, dropout_rate=0.2)
    x, knobs = model_inputs(spec, 3, seed=10)
    jy, jmag, jmh = jm.apply(params, jnp.asarray(x), jnp.asarray(knobs), deterministic=True)
    m = pst.STModel(pst.ModelSpec(**vars(spec)), frontend=frontend, device="cpu",
                    dropout_rate=0.2)
    m.load_state_dict(checkpoint.params_to_state_dict(params), strict=True)
    with torch.no_grad():
        y, _, mh = m(t(x), t(knobs), deterministic=True)
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=ATOL)
    if frontend == "fused":  # frame-major, as the fused path returns it
        mh = mh.transpose(0, 1)
    np.testing.assert_allclose(n(mh), np.asarray(jmh), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_drops_whole_rows_from_the_generator(dtype):
    rate, (b, f, w) = 0.25, (16, 200, 6)
    z = torch.ones(b, f, w, dtype=dtype)
    out = autoencoder.dropout_rows(z, rate, torch.Generator().manual_seed(3))
    scale = float(torch.tensor(1 - rate, dtype=dtype))
    kept = out[..., 0] != 0
    # whole rows: every row is all zero or all 1 / (1 - p) in the activations' dtype
    assert torch.equal(out, torch.where(kept[..., None], 1 / torch.tensor(scale, dtype=dtype),
                                        torch.zeros((), dtype=dtype)).expand(b, f, w))
    share, sigma = float(kept.float().mean()), (rate * (1 - rate) / (b * f)) ** 0.5
    assert abs(share - (1 - rate)) < 3 * sigma
    again = autoencoder.dropout_rows(z, rate, torch.Generator().manual_seed(3))
    other = autoencoder.dropout_rows(z, rate, torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)

    # through a model (float32: a bf16 product rounds to an exact zero now
    # and then): the output activation of the phase autoencoder (no skip)
    # has its dropped rows zero; the same generator state, the same run
    spec = tiny_spec()
    m = pst.STModel(pst.ModelSpec(**vars(spec)), device="cpu", dropout_rate=rate,
                    generator=torch.Generator().manual_seed(0))
    x, knobs = (t(a) for a in model_inputs(spec, 4, seed=11))
    with torch.no_grad():
        runs = [m(x, knobs, deterministic=False, return_acts=True,
                  generator=torch.Generator().manual_seed(5)) for _ in range(2)]
        with pytest.raises(ValueError, match="Generator"):
            m(x, knobs, deterministic=False)
    assert all(torch.equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    rows = runs[0][3][4 + 10 + 9]  # (B, F, OT)
    dropped = (rows == 0).all(-1)
    assert dropped.any() and torch.equal(dropped, (rows == 0).any(-1))


@pytest.mark.parametrize("which", ["flagship", "small"])
def test_flops_match_jax(which):
    jspec = jst.compute_spec() if which == "flagship" else tiny_spec()
    spec = pst.ModelSpec(**vars(jspec))
    assert flops.forward_gemm_flops_per_example(spec) == jflops.forward_gemm_flops_per_example(jspec)
    assert flops.train_step_flops_per_example(spec) == jflops.train_step_flops_per_example(jspec)
    assert (flops.aenc_gemm_flops_per_example(25, 9, 4, 513, rank=32)
            == jflops.aenc_gemm_flops_per_example(25, 9, 4, 513, rank=32))
    achieved, ratio = flops.mfu(spec, 1000.0, device="cpu")
    assert achieved == jflops.train_step_flops_per_example(jspec) * 1000.0 and ratio is None
    assert flops.peak_flops("cpu") is None


def _jax_images(monkeypatch, params, mag, mag_hat) -> dict:
    """What the JAX package's plot_spectrograms hands to matplotlib:
    {filename: (title, matrix)}, nothing written."""
    drawn, saved = [], {}
    monkeypatch.setattr(jplots.plt, "imshow", lambda m, **kw: drawn.append(np.asarray(m)))
    monkeypatch.setattr(jplots.plt, "matshow", lambda m, **kw: drawn.append(np.asarray(m)))
    monkeypatch.setattr(jplots.plt, "title", lambda s: drawn.append(s))
    monkeypatch.setattr(jplots, "_savefig", lambda name: saved.update({name: drawn[-2:]}))
    jplots.plot_spectrograms(params, mag, mag_hat)
    return {k: (v[1], v[0]) for k, v in saved.items()}


def test_plot_spectrograms_draws_the_jax_matrices(monkeypatch, tmp_path):
    spec = tiny_spec()
    _, params = jax_params(spec, seed=12)
    rng = np.random.default_rng(13)
    mag = rng.random((2, spec.time_frames, spec.ft_size // 2 + 1)).astype(np.float32)
    mag_hat = rng.random((2, spec.output_time_frames, spec.ft_size // 2 + 1)).astype(np.float32)
    want = _jax_images(monkeypatch, params, mag, mag_hat)
    got = plots.spectrogram_images(checkpoint.params_to_state_dict(params), mag, mag_hat)
    assert sorted(got) == sorted(want) == sorted(
        ["mag.png", "mag_hat.png", "conv_anal_real.png", "conv_anal_imag.png",
         "conv_synth_real.png", "conv_synth_imag.png"])
    for name, (title, matrix) in want.items():
        assert got[name][0] == title, name
        np.testing.assert_array_equal(got[name][1], matrix, err_msg=name)
    monkeypatch.chdir(tmp_path)
    plots.plot_spectrograms(checkpoint.params_to_state_dict(params), mag, mag_hat)
    assert sorted(os.listdir(tmp_path)) == sorted(want)


def test_plot_valdata_writes_the_jax_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(14)
    x = rng.uniform(-0.5, 0.5, (3, 512)).astype(np.float32)
    y, y_hat = x[:, -128:] * 0.7, x[:, -128:] * 0.6
    knobs = rng.uniform(-0.5, 0.5, (3, 4)).astype(np.float32)
    for where, module, fx in (("jax", jplots, jeffects.Compressor_4c()),
                              ("port", plots, effects.Compressor_4c(device="cpu"))):
        os.makedirs(tmp_path / where)
        monkeypatch.chdir(tmp_path / where)
        module.plot_valdata(x, knobs, y, y_hat, fx, 4, 1.5e-3, num_plots=2, target_size=128)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "val_data_0.png", "val_data_1.png"]


def test_async_writer_keeps_order_and_raises_the_first_failure():
    writer, seen = async_io.AsyncWriter(), []
    gate = threading.Event()
    writer.submit(gate.wait)
    for i in range(20):
        writer.submit(lambda i=i: seen.append(i))
    gate.set()

    def fail(msg):
        raise OSError(msg)

    writer.submit(lambda: fail("first"))
    writer.submit(lambda: fail("second"))
    writer.submit(lambda: seen.append("after"))  # the worker keeps going after a failure
    with pytest.raises(RuntimeError) as e:
        writer.close(timeout=30)
    assert seen == list(range(20)) + ["after"]
    assert isinstance(e.value.__cause__, OSError) and str(e.value.__cause__) == "first"
    assert not writer._thread.is_alive()


def test_snapshot_survives_an_update_of_its_original():
    live = {"w": torch.arange(6.0).reshape(2, 3), "moments": [torch.ones(3), (torch.zeros(2), 7)]}
    snap = async_io.snapshot(live)
    live["w"].mul_(-1)
    live["moments"][0].add_(5)
    live["moments"][1][0].fill_(3)
    got = snap.to_host()
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["moments"][0], torch.ones(3))
    assert torch.equal(got["moments"][1][0], torch.zeros(2)) and got["moments"][1][1] == 7
    assert snap.event is None  # on the CPU a snapshot is a clone

