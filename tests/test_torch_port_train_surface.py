"""The rest of train()'s surface in the port, on the CPU at a tiny geometry.

* ``train()`` with a status cadence that divides the epoch and with one
  that does not (losses read one block late, validation one epoch late):
  ``history`` and both ``.dat`` logs equal to ``eager_steps`` /
  ``eager_validation`` on the same seed, bit for bit;
* an error in epoch 2 still writes epoch 1's ``.dat`` lines, and the
  original error is raised; a failed checkpoint write fails the run;
* ``make_plots`` writes the JAX package's images at its epochs, and
  ``mag.png`` is drawn from example 0 of the fused front-end's frame-major
  ``mag`` (within the gemm and fused paths' tolerance of each other,
  tests/test_torch_port_model.py);
* ``train()`` and ``RunConfig`` take ``plot_every`` / ``make_plots`` with the
  JAX package's defaults, and importing the loop imports no plotting library;
* ``cli.lr_finder`` and ``cli.ptsd2full`` on the CPU;
* the two repairs: ``calc_ct`` on Denoise equals the JAX one, on TimeAlign
  gives every full-length window the same draws as the JAX one does (and
  comp_4c's still equals the JAX one with ``sr`` and a generator given),
  and ``lfilter`` on (2, 3, N) at orders 1 and 3 equals the JAX one.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu import config as jconfig
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import iir as jiir
from signaltrain_tpu.inference import predict_long as jpl
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch import config
from signaltrain_tpu_torch.cli import lr_finder, ptsd2full
from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import effects, iir
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models.st_model import st_model
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils import plots
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import n, t

REPO = Path(__file__).resolve().parent.parent
SEED, BATCH, STEPS = 3, 8, 4  # 4 steps an epoch, one validation batch
KW = dict(n_data_points=STEPS * BATCH, batch_size=BATCH, lr_max=1e-3, scale_factor=512 / 8192.0,
          seed=SEED, device="cpu", compute_dtype=torch.float32)


def _by_hand(epochs: int, run: int | None = None):
    """train()'s run of ``epochs`` epochs, stepped by hand for its first
    ``run`` (all by default): (losses, vl_avg and MAE lines, model)."""
    effect = effects.Compressor_4c(device="cpu")
    m = st_model(scale_factor=KW["scale_factor"], device="cpu",
                 generator=torch.Generator().manual_seed(SEED), compute_dtype=torch.float32).train()
    opt, lr_fn = train_mod.make_optimizer(m, KW["lr_max"], KW["n_data_points"], epochs, BATCH)
    spec = m.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    val_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size,
                                            augment=False)
    g = torch.Generator()
    losses, vl_lines, mae_lines, vl_avg = [], [], [], 0.0
    for epoch in range(epochs if run is None else run):
        losses += train_mod.eager_steps(m, opt, lr_fn, batch_fn, BATCH, g, SEED, epoch * STEPS,
                                        STEPS).tolist()
        m.eval()
        lv, maes, _ = train_mod.eager_validation(m, val_fn, BATCH, g, 1)
        m.train()
        for v in lv.tolist():
            vl_avg = 0.98 * vl_avg + 0.02 * v
        maes = maes.numpy()
        vl_lines.append(f"{epoch + 1} {vl_avg:.3e}")
        mae_lines.append(f"{epoch + 1} {float(maes[-1]):.3e} {float(maes.mean()):.3e}")
    return losses, vl_lines, mae_lines, m


def _lines(name):
    return open(name).read().strip().splitlines()


@pytest.mark.parametrize("status_every", [2, 3])  # n_inner 4 (one block an epoch) and 1
def test_pipelined_train_equals_eager_steps(status_every, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert train_mod.pick_n_inner(STEPS, status_every) == (4 if status_every == 2 else 1)
    model, hist = train_mod.train(effects.Compressor_4c(device="cpu"), epochs=2, cp_every=2,
                                  status_every=status_every, make_plots=False, **KW)
    losses, vl_lines, mae_lines, ref = _by_hand(2)
    assert hist["train_loss"] == losses and hist["step"] == 2 * STEPS
    assert _lines("vl_avg_out.dat") == vl_lines and _lines("val_err_mae.dat") == mae_lines
    assert [f"{v:.3e}" for v in hist["val_loss"]] == [ln.split()[1] for ln in vl_lines]
    assert [f"{v:.3e}" for v in hist["val_mae_mean"]] == [ln.split()[2] for ln in mae_lines]
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), ref.parameters()))


class Boom(Exception):
    pass


def test_an_error_in_epoch_2_keeps_epoch_1_and_raises_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    steps = train_mod.eager_steps

    def failing(*args, **kwargs):
        if args[-2] >= STEPS:  # step0 of epoch 2's block
            raise Boom("epoch 2")
        return steps(*args, **kwargs)

    monkeypatch.setattr(train_mod, "eager_steps", failing)
    with pytest.raises(Boom, match="epoch 2"):
        train_mod.train(effects.Compressor_4c(device="cpu"), epochs=3, make_plots=False, **KW)
    _, vl_lines, mae_lines, _ = _by_hand(3, run=1)
    assert _lines("vl_avg_out.dat") == vl_lines and _lines("val_err_mae.dat") == mae_lines


def test_a_log_write_that_fails_is_processed_once(tmp_path, monkeypatch):
    """Epoch 1's validation fails half way through its logs (its
    vl_avg_out.dat line written, val_err_mae.dat a directory): the error path
    processes epoch 2's validation, not epoch 1's again, so each epoch has
    one vl_avg_out.dat line, its smoothed loss applied once."""
    monkeypatch.chdir(tmp_path)
    os.mkdir("val_err_mae.dat")
    with pytest.raises(IsADirectoryError):
        train_mod.train(effects.Compressor_4c(device="cpu"), epochs=2, make_plots=False, **KW)
    _, vl_lines, _, _ = _by_hand(2)
    assert _lines("vl_avg_out.dat") == vl_lines


def test_a_failed_checkpoint_write_fails_the_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def refuse(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save_checkpoint", refuse)
    with pytest.raises(RuntimeError, match="background write") as e:
        train_mod.train(effects.Compressor_4c(device="cpu"), epochs=1, make_plots=False, **KW)
    assert isinstance(e.value.__cause__, OSError)
    assert len(_lines("val_err_mae.dat")) == 1  # the run itself went to its end


def test_checkpoint_moments_are_tensor_records_that_load_as_numpy(tmp_path):
    """Adam's moments are written as tensor records, not pickled inline (the
    pickler holds the interpreter lock over their bytes), and still load as
    the numpy leaves of the JAX package's ``optax_state``."""
    import zipfile

    model = st_model(scale_factor=KW["scale_factor"], device="cpu",
                     generator=torch.Generator().manual_seed(SEED), compute_dtype=torch.float32)
    opt, _ = train_mod.make_optimizer(model, 1e-3, 32, 1, BATCH)
    path = str(tmp_path / "c.tar")
    checkpoint.save_checkpoint(path, model.spec, effects.Compressor_4c(device="cpu"), 0,
                               checkpoint.training_tensors(model, opt), step=5)
    with zipfile.ZipFile(path) as z:
        pkl = [i.file_size for i in z.infolist() if i.filename.endswith("data.pkl")]
    moment_bytes = 2 * 4 * sum(p.numel() for p in model.parameters())
    assert len(pkl) == 1 and pkl[0] < 0.05 * moment_bytes
    leaves = checkpoint.load_checkpoint(path)[1]["optax_state"]
    assert all(type(a) is np.ndarray for a in leaves)
    assert leaves[0].dtype == np.int32 and leaves[0].shape == () and int(leaves[-1]) == 5


def test_make_plots_draws_at_the_jax_epochs_from_example_0(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = {"valdata": [], "spectrograms": []}
    draw_val, draw_spec = plots.plot_valdata, plots.plot_spectrograms

    def spy_val(*args, **kwargs):
        calls["valdata"].append(args[5])  # the epoch
        draw_val(*args, **kwargs)

    def spy_spec(sd, mag, mag_hat):
        calls["spectrograms"].append((sd, mag, mag_hat))
        draw_spec(sd, mag, mag_hat)

    monkeypatch.setattr(plots, "plot_valdata", spy_val)
    monkeypatch.setattr(plots, "plot_spectrograms", spy_spec)
    model, _ = train_mod.train(effects.Compressor_4c(device="cpu"), epochs=3, plot_every=2,
                               **KW)
    # JAX: val_data every plot_every epochs, the spectrograms every 20 and at the last
    assert calls["valdata"] == [1] and len(calls["spectrograms"]) == 1
    names = sorted(os.listdir(tmp_path))
    assert [f"val_data_{i}.png" for i in range(BATCH)] == [x for x in names
                                                          if x.startswith("val_data")]
    assert {"mag.png", "mag_hat.png", "conv_anal_real.png", "conv_anal_imag.png",
            "conv_synth_real.png", "conv_synth_imag.png"} <= set(names)
    # the last epoch's weights and last validation batch, batch-major
    sd, mag, mag_hat = calls["spectrograms"][0]
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    spec = model.spec
    val_fn = synth_data.make_synth_batch_fn(effects.Compressor_4c(device="cpu"),
                                            spec.in_chunk_size, spec.out_chunk_size,
                                            augment=False)
    x, _, knobs = val_fn(BATCH, synth_data.val_step_generator(torch.Generator(), 0))
    model.mpaec.frontend = "gemm"
    with torch.no_grad():
        _, want_mag, want_mh = model.eval()(x, knobs)
    assert mag.shape == tuple(want_mag.shape) and mag_hat.shape == tuple(want_mh.shape)
    np.testing.assert_allclose(mag, n(want_mag), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(mag_hat, n(want_mh), atol=2e-4, rtol=2e-4)


def test_plot_options_have_the_jax_defaults():
    sig, jsig = inspect.signature(train_mod.train), inspect.signature(jtrain.train)
    for name in ("plot_every", "make_plots", "cp_every", "status_every"):
        assert sig.parameters[name].default == jsig.parameters[name].default, name
    for name in ("plot_every", "make_plots"):
        assert getattr(config.RunConfig(), name) == getattr(jconfig.RunConfig(), name), name
    code = ("import sys, signaltrain_tpu_torch.training.train, signaltrain_tpu_torch.config; "
            "assert not {'matplotlib', 'PIL'} & set(sys.modules), sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_lr_finder_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    lr_finder.main(["--device", "cpu", "--npoints", "3", "--trials", "1", "-b", "4", "--scale",
                    "0.0625", "--dtype", "float32"])
    got = np.loadtxt("lrfind.dat")
    assert got.shape == (3, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, 0], np.logspace(-6, np.log10(4e-3), 3))
    assert os.path.isfile("lrfind.png")
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card by default
        if torch.cuda.is_available():
            raise RuntimeError("a card is present: device='cpu' is not the default error here")
        lr_finder.main(["--npoints", "1"])


def test_ptsd2full_round_trips_the_demo_model(tmp_path, capsys):
    src = str(REPO / "demo" / "model_comp4c_demo.tar")
    out = str(tmp_path / "full.tar")
    ptsd2full.main([src, out, "--device", "cpu"])
    assert "Saved full model to" in capsys.readouterr().out
    model, rv = load_model(src, device="cpu")
    full, rv_full = load_model(out, device="cpu")  # strict=True inside
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 full.state_dict().values()))
    for key in ("effect_name", "knob_names", "epoch", "scale_factor", "in_chunk_size", "sr"):
        assert np.all(np.asarray(rv_full[key]) == np.asarray(rv[key])), key
    assert "optax_state" not in rv_full


KNOBS_WC = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)


def test_calc_ct_denoise_equals_jax():
    """Denoise's target is the clean input, so its chunked target equals the
    JAX one exactly, whatever either draws."""
    clip = (np.random.default_rng(15).normal(size=6000) * 0.3).astype(np.float32)
    knobs = np.array([0.25], np.float32)
    got = pl.calc_ct(clip, effects.Denoise(device="cpu"), knobs, 128, 512, sr=44100)
    want = jpl.calc_ct(clip, jeffects.Denoise(), knobs, 128, 512, sr=44100)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, clip)


class _JaxDraws:
    """A JAX effect that shows its key: uniform draws of the window's shape."""

    def go_wc(self, x, knobs_wc, key=None):
        return jax.random.uniform(key, x.shape), x


class _PortDraws(effects.Effect):
    """The port's counterpart: uniform draws from the generator."""

    draws = True

    def _apply(self, x, wc, generator):
        return torch.rand(x.shape, generator=generator, device=generator.device), x


def _full_chunks(ct: np.ndarray, n: int) -> np.ndarray:
    """The chunks of a calc_ct target of n samples (128-sample windows of
    512) that only full-length windows wrote: all of them but the last,
    which the first shorter window partly overwrites."""
    n_full = (n + 512 - 128 - 512) // 128
    return ct[: n_full * 128].reshape(n_full, 128)


def test_calc_ct_gives_every_window_the_same_draws_as_jax():
    """The JAX function passes one key to every window, so every full-length
    window draws the same values; the port's gives each window the
    generator's state at entry (seeded with 0 by default), so its windows do
    too (the values differ: the generators do). TimeAlign ignores its input,
    so all its full-length windows give the same chunk: one shift, one
    chooser. (The JAX TimeAlign runs op by op at ~4 s a window on the CPU,
    so its draws are held through ``_JaxDraws``.)"""
    clip = (np.random.default_rng(15).normal(size=1500) * 0.3).astype(np.float32)
    knobs = np.array([0.25], np.float32)
    for got in (jpl.calc_ct(clip, _JaxDraws(), knobs, 128, 512),
                pl.calc_ct(clip, _PortDraws(device="cpu"), knobs, 128, 512),
                pl.calc_ct(clip, effects.TimeAlign(device="cpu"), knobs, 128, 512)):
        chunks = _full_chunks(got, len(clip))
        assert got.shape == clip.shape and np.all(np.isfinite(got)) and np.any(got != 0)
        assert len(chunks) > 2 and np.array_equal(chunks, np.broadcast_to(chunks[0], chunks.shape))
    fx = effects.TimeAlign(device="cpu")
    seeded = pl.calc_ct(clip, fx, knobs, 128, 512)
    np.testing.assert_array_equal(
        seeded, pl.calc_ct(clip, fx, knobs, 128, 512, generator=torch.Generator().manual_seed(0)))
    assert not np.array_equal(
        seeded, pl.calc_ct(clip, fx, knobs, 128, 512, generator=torch.Generator().manual_seed(1)))


def test_calc_ct_comp_4c_takes_sr_and_a_generator():
    """comp_4c draws nothing: the target with ``sr`` and a generator is the
    one test_torch_port_predict_long.py::test_calc_ct_matches_jax holds to
    the JAX package's."""
    rng = np.random.default_rng(16)
    clip = (rng.normal(size=1500) * 0.3).astype(np.float32)
    fx = effects.Compressor_4c(device="cpu")
    got = pl.calc_ct(clip, fx, KNOBS_WC, 128, 512, sr=22050,
                     generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(got, pl.calc_ct(clip, fx, KNOBS_WC, 128, 512))


@pytest.mark.parametrize("order", [1, 3])
def test_lfilter_folds_leading_axes_as_jax(order):
    rng = np.random.default_rng(17 + order)
    x = (rng.normal(size=(2, 3, 300)) * 4.0).astype(np.float32)
    jb, ja = jiir.butter_lowpass(order, 0.05)
    wn = np.array([[0.01, 0.05, 0.2], [0.1, 0.3, 0.6]], np.float32)
    rows = [jiir.butter_lowpass(order, float(w)) for w in wn.ravel()]
    pb = np.stack([np.asarray(r[0]) for r in rows]).reshape(2, 3, order + 1)
    pa = np.stack([np.asarray(r[1]) for r in rows]).reshape(2, 3, order + 1)
    zi = rng.normal(size=(2, 3, order)).astype(np.float32)
    for b, a, z in ((jb, ja, None), (pb, pa, zi), (jb, ja, zi)):  # shared and per-row filters
        want = jiir.lfilter(jnp.asarray(b), jnp.asarray(a), jnp.asarray(x),
                            zi=None if z is None else jnp.asarray(z))
        got = iir.lfilter(t(b), t(a), t(x), None if z is None else t(z))
        assert got.shape == want.shape == (2, 3, 300)
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
