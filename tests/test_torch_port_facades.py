"""The port's reference-API surface (``import signaltrain_tpu_torch as st``)
against the JAX package's, on the CPU.

* The lazy ``_SUBMODULES`` and every facade's public names (not modules,
  not underscored) are the JAX package's sets.
* The deterministic functions against JAX: ``learningrate.get_1cycle_schedule``
  and ``loss_functions.calc_loss`` (rtol 1e-6), ``audio.sliding_window`` /
  ``undo_sliding_window`` (exact), ``nn_proc.st_model``'s spec and parameter
  count (exact), the ``misc`` checkpoint mappings (exact), ``datasets.do_augment``
  on the same numpy generator (exact).
* torch cannot reproduce ``jax.random``, so the facade's draws are held to
  their distributions (``random_ends``: Beta(0.8, 0.8)'s mean and variance,
  within 4 standard errors), ``seed`` to repeating them, and
  ``SynthAudioDataSet(recycle=True)`` to giving item idx twice.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import signaltrain_tpu as jst
import signaltrain_tpu_torch as st
from tests.torch_port_util import n, t

def public(mod) -> set:
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType) and k != "annotations"}


def test_submodules_are_the_jax_packages():
    assert st._SUBMODULES == jst._SUBMODULES
    assert set(st._SUBMODULES) <= set(dir(st))
    with pytest.raises(AttributeError):
        st.no_such_module  # noqa: B018


@pytest.mark.parametrize("name", jst._SUBMODULES)
def test_facade_public_names_are_the_jax_facades(name):
    got = public(getattr(st, name))
    want = public(importlib.import_module(f"signaltrain_tpu.{name}"))
    assert got == want


def test_learningrate_and_loss_match_jax():
    kw = dict(lr_max=2e-3, n_data_points=4000, epochs=3, batch_size=40)
    for got, want in zip(st.learningrate.get_1cycle_schedule(**kw),
                         jst.learningrate.get_1cycle_schedule(**kw)):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    rng = np.random.default_rng(0)
    y_hat, y = (rng.normal(size=(4, 128)).astype(np.float32) for _ in range(2))
    mag_hat = np.abs(rng.normal(size=(4, 9, 33))).astype(np.float32)
    for scale in (None, 33):
        ps = None if scale is None else st.loss_functions.freq_scale(scale)
        js = None if scale is None else jst.loss_functions.freq_scale(scale)
        got = st.loss_functions.calc_loss(t(y_hat), t(y), t(mag_hat), scale_by_freq=ps)
        want = jst.loss_functions.calc_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                            jnp.asarray(mag_hat), scale_by_freq=js)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("length,size,overlap", [(10, 5, 2), (3000, 512, 128), (100, 512, 0)])
def test_audio_windows_match_jax(length, size, overlap):
    x = np.random.default_rng(length).normal(size=length).astype(np.float32)
    win = st.audio.sliding_window(x, size, overlap, device="cpu")
    np.testing.assert_array_equal(win, jst.audio.sliding_window(x, size, overlap))
    for flat in (None, length):
        np.testing.assert_array_equal(
            st.audio.undo_sliding_window(win, overlap, flat, device="cpu"),
            jst.audio.undo_sliding_window(win, overlap, flat))


def test_audio_draws():
    st.audio.seed(3, device="cpu")
    u = st.audio.random_ends(20000, device="cpu")
    var = 0.64 / (2.56 * 2.6)  # Beta(a, b): ab / ((a + b)^2 (a + b + 1))
    assert u.shape == (20000,) and u.min() >= 0 and u.max() <= 1
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(var / 20000)
    assert abs(u.var() - var) < 4 * 0.0011  # the variance's standard error at n = 20000
    tt = np.arange(512, dtype=np.float32) / 44100
    st.audio.seed(7, device="cpu")
    a = st.audio.synth_input_sample(tt, device="cpu"), st.audio.pinknoise(512, device="cpu")
    st.audio.seed(7, device="cpu")
    b = st.audio.synth_input_sample(tt, device="cpu"), st.audio.pinknoise(512, device="cpu")
    for p, q in zip(a, b):
        assert p.shape == (512,) and np.array_equal(p, q)
    assert np.abs(b[1]).max() == pytest.approx(1.0)
    y = st.audio.normish(np.sin(tt * 2000), (0.2, 0.3), device="cpu")
    assert 0.2 <= np.abs(y).max() <= 0.3
    np.testing.assert_array_equal(st.audio.my_clip_min(tt - 0.005, 0.0),
                                  jst.audio.my_clip_min(tt - 0.005, 0.0))


def test_nn_proc_st_model_matches_jax():
    model = st.nn_proc.st_model(device="cpu")
    jmodel = jst.nn_proc.st_model()
    assert model.spec == st.nn_proc.compute_spec()
    assert {k: getattr(model.spec, k) for k in jmodel.spec.__dataclass_fields__} == \
        jmodel.spec.__dict__
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want
    assert isinstance(model, st.nn_proc.STModel)
    assert isinstance(model.mpaec, st.nn_proc.AsymMPAEC)
    assert isinstance(model.mpaec.aenc, st.nn_proc.AsymAutoEncoder)


def test_misc_checkpoint_round_trip_matches_jax(tmp_path):
    model = st.nn_proc.st_model(scale_factor=512 / 8192, device="cpu",
                                generator=torch.Generator().manual_seed(4))
    spec = model.spec
    # a JAX parameter tree (numpy leaves), the front-end moved off its init
    params = st.misc.torch_state_dict_to_params(model.state_dict())
    rng = np.random.default_rng(4)
    for side in ("dft_analysis", "dft_synthesis"):
        for k, w in params["params"][side].items():
            params["params"][side][k] = (w + 0.1 * rng.normal(size=w.shape)).astype(np.float32)
    got = st.misc.params_to_torch_state_dict(params)
    want = jst.misc.params_to_torch_state_dict(params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    back = st.misc.torch_state_dict_to_params(got)
    jback = jst.misc.torch_state_dict_to_params(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a .tar written by the JAX package loads through the facade
    path = str(tmp_path / "m.tar")
    jst.misc.save_checkpoint(path, params, spec, st.audio.Compressor_4c(device="cpu"), 2)
    sd, rv = st.misc.load_checkpoint(path)
    assert rv["epoch"] == 3 and all(torch.equal(sd[k], want[k]) for k in want)


def test_print_choochoo_prints_the_version(capsys):
    st.misc.print_choochoo(st.__version__)
    assert st.__version__ in capsys.readouterr().out


def test_synth_dataset_recycle_gives_the_same_item_twice():
    effect = st.audio.Compressor_4c(device="cpu")
    ds = st.datasets.SynthAudioDataSet(512, effect, datapoints=10, recycle=True, y_size=128)
    a, b = ds[3], ds[3]
    assert len(ds) == 10 and [v.shape for v in a] == [(512,), (128,), (4,)]
    assert all(np.array_equal(p, q) for p, q in zip(a, b))
    assert not np.array_equal(ds[4][0], a[0])
    fresh = st.datasets.SynthAudioDataSet(512, effect, y_size=128)
    assert not np.array_equal(fresh[0][0], fresh[0][0])  # a stream: each item new
    x, y, k = next(fresh.batches(6, steps=1))
    assert x.shape == (6, 512) and y.shape == (6, 128) and k.shape == (6, 4)
    assert np.all(np.abs(n(k)) <= 0.5)


def test_audio_file_dataset_and_do_augment(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(2):
        x = (0.3 * rng.standard_normal(4096)).astype(np.float32)
        st.audio.write_audio_file(str(tmp_path / f"input_{i}_.wav"), x)
        name = f"target_{i}_Compressor_4c__-20.0__2.0__0.01__0.01.wav"
        st.audio.write_audio_file(str(tmp_path / name), 0.5 * x)
    ds = st.datasets.AudioFileDataSet(1024, st.audio.Compressor_4c(device="cpu"),
                                      path=str(tmp_path), datapoints=5, y_size=256)
    x, y, k = ds[0]
    assert len(ds) == 5 and x.shape == (1024,) and y.shape == (256,) and k.shape == (4,)
    np.testing.assert_allclose(y, 0.5 * x[-256:], atol=1e-6)
    xa = rng.normal(size=600).astype(np.float32)
    ya = xa[-200:].copy()
    for seed in range(4):
        got = st.datasets.do_augment(xa.copy(), ya.copy(), mult_some=True, add_some=True,
                                     rng=np.random.default_rng(seed))
        want = jst.datasets.do_augment(xa.copy(), ya.copy(), mult_some=True, add_some=True,
                                       rng=np.random.default_rng(seed))
        for p, q in zip(got, want):
            np.testing.assert_array_equal(p, q)


def test_train_facade_steps(tmp_path):
    """make_train_step / make_eval_step run one step and one validation batch
    on the CPU, equal to the port's own functions; the graphs need a card."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.training import train as train_mod

    def build():
        m = st.nn_proc.st_model(scale_factor=512 / 8192, device="cpu",
                                generator=torch.Generator().manual_seed(0))
        return m, st.train.make_optimizer(m, 1e-3, 64, 2, 8)

    effect = st.audio.Compressor_4c(device="cpu")
    (m1, tx1), (m2, tx2) = build(), build()
    batch_fn = synth_data.make_synth_batch_fn(effect, 512, m1.spec.out_chunk_size)
    step = st.train.make_train_step(m1, tx1, batch_fn, 8, generator=torch.Generator(), seed=5)
    l1 = step(0)
    g = synth_data.step_generator(torch.Generator(), 5, 0)
    l2 = train_mod.train_step_from_arrays(m2, tx2[0], tx2[1], 0, *batch_fn(8, g))
    assert torch.equal(l1, l2)
    for (k, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), k
    evaluate = st.train.make_eval_step(m1, batch_fn, 8, generator=torch.Generator())
    l, mae, outs = evaluate(0)
    assert torch.isfinite(l) and torch.isfinite(mae) and outs[0].shape == (8, 512)
    with pytest.raises(ValueError, match="CUDA"):
        st.train.make_train_multi_step(m1, tx1, batch_fn, 8, 4, generator=torch.Generator())
    with pytest.raises(ValueError, match="CUDA"):
        st.train.make_eval_scan(m1, batch_fn, 8, 2, generator=torch.Generator())
