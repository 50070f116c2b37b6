"""TCN-300-C (``models/tcn.py``) on the port's normal path, on the CPU,
against the plain reference ``tests/tcn_reference.py`` on seeded random
weights, at a small size: 4 blocks, kernel 3, dilation growth 2, 8
channels (receptive field 31), batch 3, 64 output samples.

Tolerances, float32 against float64, each well above the float32 rounding
it allows for (the readings on the CPU beside them): the forward within 2e-6
of tanh's outputs in [-1, 1] (a few float32 ulps through 4 blocks of
products and normalisations; read 8.4e-8), the running statistics within
1e-6 relative (1.0e-7); the loss within 1e-6 relative (4.4e-8); each
gradient within 1e-4 x the largest of its leaf (float32 sums over the 192
samples of a channel; 3.7e-7); Adam's first update within 1e-3 x lr of the
reference's, element by element (its first step is lr x g / (|g| + eps),
which moves only where a gradient is near eps; 2.6e-5). ``predict_long``'s
windows against one forward of the whole signal: within 2e-6, as the forward
(the model is causal and unpadded, so each window's last 64 outputs are the
whole signal's at those samples; 9e-9).
"""

import dataclasses

import numpy as np
import pytest
import torch

from signaltrain_tpu_torch import config
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models.kinds import build_model
from signaltrain_tpu_torch.models.tcn import TCNSpec
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils.load_model import load_model
from tests import tcn_reference as ref

SPEC = TCNSpec(kernel_size=3, dilation_growth=2, channels=8, out_chunk_size=64)
REF_SPEC = dict(n_blocks=4, dilation_growth=2, causal=True)
B = 3
FWD_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The sizes here are tiny: one thread runs them fastest, and leaves the
    other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed: int = 0, spec: TCNSpec = SPEC):
    """The TCN with its initialisation from ``seed``, its PReLU slopes and
    running statistics moved off their starting values."""
    model = build_model("tcn", device="cpu", tcn=spec,
                        generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for block in model.blocks:
            block.relu.weight.add_(torch.rand(SPEC.channels, generator=g) * 0.2 - 0.1)
            block.film.bn.running_mean.copy_(torch.randn(SPEC.channels, generator=g) * 0.1)
            block.film.bn.running_var.copy_(torch.rand(SPEC.channels, generator=g) + 0.5)
    return model


def _inputs(seed: int = 0, n: int = SPEC.in_chunk_size):
    g = torch.Generator().manual_seed(seed + 100)
    x = torch.randn(B, n, generator=g) * 0.3
    y = torch.tanh(2 * x[:, SPEC.receptive_field - 1 :])
    return x, y, torch.rand(B, 4, generator=g) - 0.5


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_the_sizes_are_tcn_300_c():
    spec = TCNSpec()
    assert (spec.receptive_field, spec.in_chunk_size) == (13_333, 78_868)
    assert sum(p.numel() for p in build_model("tcn", device="cpu").parameters()) == 50_769
    assert (SPEC.receptive_field, SPEC.in_chunk_size) == (31, 94)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("training", [True, False])
def test_the_forward_in_float32_is_the_float64_reference(training, causal):
    model = _model(spec=dataclasses.replace(SPEC, causal=causal))
    state = _state(model)
    x, _, knobs = _inputs()
    model.train(training)
    with torch.no_grad():
        y, mag, mag_hat = model(x, knobs)
    want, running = ref.forward(state, x, knobs, dict(REF_SPEC, causal=causal), training=training)
    assert mag is None and mag_hat is None and y.shape == (B, 64) and y.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), want.numpy(), atol=FWD_TOL, rtol=0)
    for k, v in running.items():  # the batch's statistics moved the running ones (training only)
        np.testing.assert_allclose(model.state_dict()[k].double().numpy(), v.numpy(), rtol=1e-6)
    assert bool(running) == training


def test_one_eager_step_is_the_references_loss_gradients_and_update():
    model = _model(seed=3)
    state = _state(model)
    batch = _inputs(seed=3)
    lr = 1e-3
    opt = train_mod.adam(model, lr)
    loss = train_mod.optimizer_step(model, opt, *batch)
    grads = {k: p.grad for k, p in model.named_parameters()}
    losses, want_grads, params, _ = ref.train_steps(state, [batch], [lr], REF_SPEC)
    np.testing.assert_allclose(float(loss), losses[0], rtol=1e-6)
    assert set(grads) == set(want_grads[0]) and len(grads) == 6 + 4 * 5 + 2
    for k, g in grads.items():
        w = want_grads[0][k]
        assert float((g.double() - w).abs().max()) <= 1e-4 * float(w.abs().max()), k
    for k, p in model.named_parameters():
        step, want = p.detach().double() - state[k].double(), params[k] - state[k].double()
        assert float((step - want).abs().max()) <= 1e-3 * lr, k


def test_predict_long_over_several_windows_is_one_forward_of_the_signal(monkeypatch):
    model = _model(seed=5).eval()
    state = _state(model)
    n = SPEC.in_chunk_size + 6 * SPEC.out_chunk_size + 17  # 8 windows, the last padded
    signal = torch.randn(n, generator=torch.Generator().manual_seed(9)) * 0.3
    knobs = np.array([0.1, -0.2, 0.3, -0.4], np.float32)
    monkeypatch.setattr(pl, "SUPER_BATCH", 3)  # three forwards
    got = pl.predict_long(signal.numpy(), knobs, model)
    want, _ = ref.forward(state, signal[None], torch.from_numpy(knobs)[None], REF_SPEC,
                          training=False)
    assert got.shape == (n - SPEC.receptive_field + 1,)
    np.testing.assert_allclose(got, want[0].numpy(), atol=FWD_TOL, rtol=0)


def test_the_tcn_refuses_what_it_does_not_compute(monkeypatch):
    with pytest.raises(ValueError, match="float32 only"):
        build_model("tcn", device="cpu", compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="model kind"):
        build_model("wavenet", device="cpu")
    effect = effects.Compressor_4c(device="cpu")
    monkeypatch.setenv("ST_TPU_MICROBATCH", "3")
    with pytest.raises(ValueError, match="ST_TPU_MICROBATCH"):
        train_mod.train(effect, epochs=1, n_data_points=6, batch_size=6, device="cpu",
                        model_kind="tcn", tcn=SPEC, make_plots=False)
    with pytest.raises(ValueError, match="one process"):
        train_mod.train(effect, epochs=1, n_data_points=6, batch_size=6, device="cpu",
                        model_kind="tcn", tcn=SPEC, make_plots=False, n_model=2)


ARGV = ["--model", "tcn", "--kernel-size", "3", "--dilation-growth", "2", "--channels", "8",
        "--out-chunk-size", "64", "--epochs", "2", "-n", "12", "-b", "6", "--lrmax", "1e-3",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``run_train``'s flags through ``RunConfig`` into ``train()``: two
    tiny epochs of a TCN on the CPU, in a directory of their own."""
    import os

    cwd, d = os.getcwd(), tmp_path_factory.mktemp("tcn_run")
    os.chdir(d)
    try:
        cfg = config.RunConfig.from_args(run_train.build_parser().parse_args(ARGV))
        cfg = cfg.replace(make_plots=False, cp_every=1)
        model, history = config.train_from_config(cfg)
    finally:
        os.chdir(cwd)
    return cfg, model, history, d


def test_train_runs_two_tiny_epochs_of_a_tcn(trained):
    cfg, model, history, d = trained
    assert cfg.model_kind == "tcn" and cfg.tcn == SPEC and cfg.compute_dtype() == torch.float32
    assert model.spec == dataclasses.replace(SPEC, num_knobs=4, sr=44100)
    assert len(history["train_loss"]) == 4 and len(history["val_loss"]) == 2
    assert all(np.isfinite(history["train_loss"])) and history["step"] == 4
    assert len((d / "vl_avg_out.dat").read_text().splitlines()) == 2
    assert all(int(b.film.bn.num_batches_tracked) == 4 for b in model.blocks)


def test_a_tcn_checkpoint_reloads_to_the_same_outputs(trained):
    _, model, _, d = trained
    _, rv = checkpoint.load_checkpoint(str(d / "modelcheckpoint.tar"))
    assert rv["model_kind"] == "tcn" and rv["tcn"] == SPEC.sizes() and rv["adam_step"] == 4
    assert (rv["in_chunk_size"], rv["out_chunk_size"]) == (94, 64)
    assert set(rv["adam_state"]["exp_avg"]) == {k for k, _ in model.named_parameters()}
    served, _ = load_model(str(d / "modelcheckpoint.tar"), device="cpu")
    x, _, knobs = _inputs(seed=11)
    with torch.no_grad():
        want = model.eval()(x, knobs)[0]
        got = served(x, knobs)[0]
    assert not served.training and torch.equal(got, want)
    # resuming restores Adam's state at its step; a spectral run refuses the file
    opt = train_mod.adam(served, 1e-3)
    checkpoint.restore_adam(served, opt, rv["adam_state"], rv["adam_step"])
    p = next(served.parameters())
    assert float(opt.state[p]["step"]) == 4 and torch.equal(
        opt.state[p]["exp_avg"], rv["adam_state"]["exp_avg"]["gen.0.weight"])
    with pytest.raises(ValueError, match="holds a tcn model"):
        train_mod.train(effects.Compressor_4c(device="cpu"), epochs=1, n_data_points=8,
                        batch_size=8, device="cpu",
                        in_checkpointname=str(d / "modelcheckpoint.tar"))
