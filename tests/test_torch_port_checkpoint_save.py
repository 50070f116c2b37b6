"""save_checkpoint, the optimizer-state round trip and train() of the port.

* JAX save_checkpoint (with optax_state) -> port load -> port save -> JAX
  load_checkpoint + restore_optax_state: parameters and Adam moments
  bit-equal, step equal. The leaf order the port documents is checked
  against jax.tree_util.tree_leaves of optax.adam(...).init(params).
* A checkpoint written by the port after real steps resumes in the JAX
  package with the moments torch.optim.Adam holds.
* train() for 2 epochs on the CPU at a tiny geometry writes the checkpoint
  and both logs in the reference's format, the validation error falls, and a
  resumed run continues at the saved step with the saved geometry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.models import st_model as jst
from signaltrain_tpu.training import checkpoint as jcheckpoint
from signaltrain_tpu.training import schedule as jschedule
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import jax_params, model_inputs, n, port_model, t, tiny_spec


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_state_dict_to_params_inverts_params_to_state_dict():
    _, params = jax_params(tiny_spec(), seed=0)
    back = checkpoint.state_dict_to_params(checkpoint.params_to_state_dict(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(params))
    _tree_equal(back, params)
    _tree_equal(jcheckpoint.torch_state_dict_to_params(checkpoint.params_to_state_dict(params)),
                back)


def test_round_trip_jax_port_jax_is_bit_equal(tmp_path):
    # a geometry that the checkpoint's run values rebuild (load_model goes
    # through compute_spec): 512 -> 128 samples at ft 1024, T 5, OT 4
    spec = jst.compute_spec(scale_factor=512 / 8192.0)
    _, params = jax_params(spec, seed=1)
    tx = optax.adam(learning_rate=jschedule.one_cycle_fn(2e-4, 80, 3, 8), b1=0.9, b2=0.999,
                    eps=1e-8)
    opt_state = tx.init(params)
    rng = np.random.default_rng(2)
    for _ in range(3):  # real, distinct moments in every leaf
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    first, second = str(tmp_path / "jax.tar"), str(tmp_path / "port.tar")
    jcheckpoint.save_checkpoint(first, jax.device_get(params), spec, jeffects.Compressor_4c(), 4,
                                optax_state=jax.device_get(opt_state), step=3)

    # the documented leaf order: [count, mu..., nu..., count]
    leaves = jax.tree_util.tree_leaves(opt_state)
    n_params = len(jax.tree_util.tree_leaves(params))
    assert len(leaves) == 2 * n_params + 2
    assert leaves[0].shape == () and leaves[-1].shape == () and leaves[0].dtype == jnp.int32
    for mu, p in zip(leaves[1 : 1 + n_params], jax.tree_util.tree_leaves(params)):
        assert mu.shape == p.shape

    model, rv = load_model(first, device="cpu")
    assert rv["optax_step"] == 3 and rv["epoch"] == 5
    opt, _ = train_mod.make_optimizer(model, 2e-4, 80, 3, 8)
    checkpoint.restore_optimizer(model, opt, rv["optax_state"], rv["optax_step"])
    name = "mpaec.aenc.fnn_enc.weight"
    p = dict(model.named_parameters())[name]
    np.testing.assert_array_equal(  # (in, out) kernel moments arrive transposed
        n(opt.state[p]["exp_avg"]), np.asarray(opt_state[0].mu["params"]["aenc"]["fnn_enc"]["kernel"]).T)
    assert float(opt.state[p]["step"]) == 3.0
    checkpoint.save_checkpoint(second, model.spec, effects.Compressor_4c(device="cpu"), 4,
                               checkpoint.training_tensors(model, opt), step=rv["optax_step"])

    params2, rv2 = jcheckpoint.load_checkpoint(second)
    _tree_equal(params2, params)
    restored = jcheckpoint.restore_optax_state(tx.init(params2), rv2["optax_state"])
    _tree_equal(restored, opt_state)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(opt_state)
    assert rv2["optax_step"] == 3 and rv2["epoch"] == 5
    for key in ("effect_name", "knob_names", "scale_factor", "shrink_factor", "in_chunk_size",
                "out_chunk_size", "sr"):
        assert rv2[key] == rv[key], key
    np.testing.assert_array_equal(rv2["knob_ranges"], rv["knob_ranges"])
    with pytest.raises(ValueError):
        checkpoint.restore_optimizer(model, opt, rv["optax_state"][:-1], 3)


def test_port_checkpoint_after_real_steps_resumes_in_jax(tmp_path):
    spec = tiny_spec()
    _, params = jax_params(spec, seed=3)
    model = port_model(spec, params, "fused").train()
    opt, lr_fn = train_mod.make_optimizer(model, 2e-4, 40, 1, 8)
    for step in range(2):
        x, knobs = model_inputs(spec, 8, seed=step)
        y = x[:, -spec.out_chunk_size :] * 0.5
        train_mod.train_step_from_arrays(model, opt, lr_fn, step, t(x), t(y), t(knobs))
    path = str(tmp_path / "port.tar")
    checkpoint.save_checkpoint(path, model.spec, effects.Compressor_4c(device="cpu"), 0,
                               checkpoint.training_tensors(model, opt), step=2)
    jparams, rv = jcheckpoint.load_checkpoint(path)
    tx = optax.adam(learning_rate=jschedule.one_cycle_fn(2e-4, 40, 1, 8))
    state = jcheckpoint.restore_optax_state(tx.init(jparams), rv["optax_state"])
    assert int(state[0].count) == 2 and int(state[1].count) == 2
    p = dict(model.named_parameters())
    np.testing.assert_array_equal(
        np.asarray(state[0].nu["params"]["dft_synthesis"]["w_imag"]),
        n(opt.state[p["mpaec.dft_synthesis.conv_synthesis_imag.weight"]]["exp_avg_sq"])[:, 0, :])
    np.testing.assert_array_equal(
        np.asarray(state[0].mu["params"]["phs_aenc"]["fnn_dec"]["bias"]),
        n(opt.state[p["mpaec.phs_aenc.fnn_dec.bias"]]["exp_avg"]))
    np.testing.assert_array_equal(np.asarray(jparams["params"]["aenc"]["fnn_dec2"]["kernel"]),
                                  n(p["mpaec.aenc.fnn_dec2.weight"]).T)


def test_train_two_epochs_writes_logs_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    effect = effects.Compressor_4c(device="cpu")
    kw = dict(n_data_points=80, batch_size=8, lr_max=1e-3, scale_factor=512 / 8192.0,
              device="cpu", compute_dtype=torch.float32, make_plots=False)
    model, hist = train_mod.train(effect, epochs=2, cp_every=2, **kw)
    out = capsys.readouterr().out
    assert "\repoch 2/2" in out and "lr=" in out and "mom=" in out and "loss:" in out
    assert "Expect run to finish" in out and "saving model to modelcheckpoint.tar" in out
    assert model.spec.in_chunk_size == 512 and model.spec.out_chunk_size == 128
    assert len(hist["train_loss"]) == 20 and np.all(np.isfinite(hist["train_loss"]))
    assert hist["step"] == 20
    for name in ("vl_avg_out.dat", "val_err_mae.dat", "modelcheckpoint.tar"):
        assert os.path.exists(name), name
    lines = open("vl_avg_out.dat").read().strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["1", "2"]
    assert all(len(ln.split()) == 2 and np.isfinite(float(ln.split()[1])) for ln in lines)
    mae_lines = [ln.split() for ln in open("val_err_mae.dat").read().strip().splitlines()]
    assert [len(ln) for ln in mae_lines] == [3, 3]
    mean_maes = [float(ln[2]) for ln in mae_lines]
    assert mean_maes[-1] < mean_maes[0], mean_maes  # the frozen validation set improves

    # the checkpoint carries the step and loads in both packages
    _, rv = jcheckpoint.load_checkpoint("modelcheckpoint.tar")
    assert rv["optax_step"] == 20 and rv["epoch"] == 2
    served, _ = load_model("modelcheckpoint.tar", device="cpu")
    for a, b in zip(served.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)

    # resume: geometry from the checkpoint (not the arguments), step continues
    kw["scale_factor"] = 1.0
    model2, hist2 = train_mod.train(effect, epochs=1, cp_every=1, **kw)
    out = capsys.readouterr().out
    assert "Restored optimizer state at step 20." in out
    assert model2.spec.in_chunk_size == 512
    assert hist2["step"] == 30
    _, rv2 = jcheckpoint.load_checkpoint("modelcheckpoint.tar")
    assert rv2["optax_step"] == 30
    assert len(open("vl_avg_out.dat").read().strip().splitlines()) == 3  # appended


def test_train_refuses_an_effect_on_another_device():
    class Elsewhere(effects.Compressor_4c):
        def __init__(self):
            super().__init__(device="cpu")
            self.device = torch.device("meta")

    with pytest.raises(ValueError):
        train_mod.train(Elsewhere(), epochs=1, n_data_points=8, batch_size=8, device="cpu")


def test_run_train_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run_train.main(["--epochs", "1", "-n", "16", "-b", "8", "--scale", "0.0625", "--device", "cpu",
                    "--out-checkpoint", "out.tar", "--profile", "prof"])
    assert os.path.exists("out.tar") and not os.path.exists("modelcheckpoint.tar")
    out = capsys.readouterr().out
    assert "Execution completed" in out and "profiler trace written to prof" in out
    traces = os.listdir("prof")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(os.path.join("prof", traces[0])) as f:
        assert '"train.block"' in f.read()  # the loop's blocks are named in the trace
    with pytest.raises(SystemExit) as e:  # --nmodel 2 needs n_data x 2 ranks, not one
        run_train.main(["--nmodel", "2", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "--nmodel 2" in out and "not n_data x 2" in out
    with pytest.raises(SystemExit) as e:  # bfloat16 and float32 run; nothing else does
        run_train.main(["--dtype", "float16", "--device", "cpu"])
    assert e.value.code == 1 and "--dtype float16" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_train.main(["--effect", "no_such_effect", "--device", "cpu"])
    assert "not yet added" in capsys.readouterr().out
    for path in ([], ["--path", str(tmp_path / "somewhere")]):  # no dataset there
        with pytest.raises(SystemExit) as e:
            run_train.main(["--effect", "files", "--device", "cpu"] + path)
        assert e.value.code == 1
        assert "can't find target output files" in capsys.readouterr().out
