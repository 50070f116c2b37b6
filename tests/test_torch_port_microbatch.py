"""``ST_TPU_MICROBATCH`` in the port (``train.microbatches``,
``train.loss_and_grads(micro=)``) against the JAX package's ``_make_lg_fn``,
on the CPU, at the JAX test's geometry (ft 64, hop 24, 512 -> 128, batch 8;
tests/test_training.py ``test_microbatch_grad_accum_equivalent``).

* (a) ``loss_and_grads(micro=4)`` on a numpy batch against JAX's
  ``_make_lg_fn(loss_fn, 8)`` under ``ST_TPU_MICROBATCH=4`` (Pallas front-end
  in interpret mode), the parameters carried across: the loss within rtol
  1e-5 and every gradient within 1e-3 * max|g| of its leaf, the tolerances
  the unsliced step is held to (tests/test_torch_port_train.py
  ``test_loss_and_grads_match_jax_pallas``).
* (b) 2 steps of ``eager_steps`` at k = 4 against k = 1 on the same
  synthesized batches, at the JAX test's tolerances: losses rtol 1e-5 / atol
  1e-9, weights rtol 1e-5 / atol 1e-8.
* (c) the JAX rule for k: 1 when unset, at most 1, or not dividing the local
  batch; so ``train()`` under k = 3 at batch 8 is bit-equal to ``train()``
  without the variable.
* ``train()`` reads the variable once: its synthetic and device-resident
  file steps run in k slices, its host tier's never (JAX's host-fed step
  takes the whole batch).

The microbatched data-parallel and tensor-parallel steps against
``oracle_steps(micro=2)`` run inside the spawns of
tests/test_torch_port_parallel.py; the train graph's slices on the card in
tests/test_torch_port_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.models.st_model import ModelSpec, STModel
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from tests.test_torch_port_file_data import TRAIN_KW as FILE_TRAIN_KW
from tests.test_torch_port_file_data import write_dataset
from tests.test_torch_port_train import _batch, _jax_loss_fn
from tests.torch_port_util import assert_dw_close, jax_params, n, port_model, t, tiny_spec

BATCH = 8
OPT = dict(lr_max=1e-4, n_data_points=256, epochs=2, batch_size=BATCH)  # the JAX test's
TRAIN_KW = dict(epochs=1, n_data_points=16, batch_size=BATCH, scale_factor=0.0625, lr_max=2e-4,
                seed=5, make_plots=False, device="cpu", compute_dtype=torch.float32)


@pytest.mark.parametrize("frontend", ["fused", "gemm"])
def test_microbatched_loss_and_grads_match_jax(frontend, monkeypatch):
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=4)
    x, y, knobs = _batch(spec, BATCH, seed=5)
    monkeypatch.setenv("ST_TPU_MICROBATCH", "4")
    jl, jg = jtrain._make_lg_fn(_jax_loss_fn(jm), BATCH)(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(knobs))
    micro = train_mod.microbatches(BATCH)
    assert micro == 4
    model = port_model(spec, params, frontend).train()
    l = train_mod.loss_and_grads(model, t(x), t(y), t(knobs), micro=micro)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    want = checkpoint.params_to_state_dict(jax.device_get(jg))
    for name, p in model.named_parameters():
        assert_dw_close(n(p.grad), n(want[name]), name)


def _steps(frontend: str, micro: int, n_steps: int = 2):
    """n_steps eager steps from seeded weights on comp_4c batches: (losses,
    weights)."""
    spec = ModelSpec(**dataclasses.asdict(tiny_spec()))
    model = STModel(spec, frontend=frontend, device="cpu",
                    generator=torch.Generator().manual_seed(0)).train()
    opt, lr_fn = train_mod.make_optimizer(model, **OPT)
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              spec.in_chunk_size, spec.out_chunk_size)
    losses = train_mod.eager_steps(model, opt, lr_fn, batch_fn, BATCH, torch.Generator(), 5, 0,
                                   n_steps, micro=micro)
    return n(losses), {k: n(v) for k, v in model.named_parameters()}


@pytest.mark.parametrize("frontend", ["fused", "gemm"])
def test_four_slices_match_the_unsliced_steps(frontend):
    l1, w1 = _steps(frontend, 1)
    l4, w4 = _steps(frontend, 4)
    assert not np.array_equal(l1, l4) or any(not np.array_equal(w1[k], w4[k]) for k in w1)
    np.testing.assert_allclose(l4, l1, rtol=1e-5, atol=1e-9)
    for k in w1:
        np.testing.assert_allclose(w4[k], w1[k], rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("value,local_batch,want", [
    (None, 8, 1), ("0", 8, 1), ("1", 8, 1), ("-4", 8, 1), ("4", 8, 4), ("2", 8, 2), ("8", 8, 8),
    ("3", 8, 1), ("16", 8, 1), ("4", 100, 4), ("3", 100, 1)])
def test_microbatches_is_the_jax_rule(value, local_batch, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("ST_TPU_MICROBATCH", raising=False)
    else:
        monkeypatch.setenv("ST_TPU_MICROBATCH", value)
    assert train_mod.microbatches(local_batch) == want


def test_micro_must_divide_the_batch():
    model = STModel(ModelSpec(**dataclasses.asdict(tiny_spec())), device="cpu")
    x = torch.zeros(6, 512)
    with pytest.raises(ValueError, match="do not divide a batch of 6"):
        train_mod.loss_and_grads(model, x, torch.zeros(6, 128), torch.zeros(6, 4), micro=4)


def _train(tmp_path, monkeypatch, value, **kw):
    monkeypatch.chdir(tmp_path)
    if value is None:
        monkeypatch.delenv("ST_TPU_MICROBATCH", raising=False)
    else:
        monkeypatch.setenv("ST_TPU_MICROBATCH", value)
    model, hist = train_mod.train(effects.make_effect("comp_4c", device="cpu"), **TRAIN_KW, **kw)
    return hist, {k: v.detach().clone() for k, v in model.named_parameters()}


def test_a_k_that_does_not_divide_the_batch_is_bit_equal_to_unsliced(tmp_path, monkeypatch,
                                                                      capsys):
    """k = 3 on a batch of 8: train() runs the unsliced step, bit for bit."""
    (tmp_path / "off").mkdir()
    (tmp_path / "three").mkdir()
    hist_off, w_off = _train(tmp_path / "off", monkeypatch, None)
    capsys.readouterr()
    hist_3, w_3 = _train(tmp_path / "three", monkeypatch, "3")
    assert "ST_TPU_MICROBATCH" not in capsys.readouterr().out
    assert hist_3 == hist_off
    assert all(torch.equal(w_3[k], w_off[k]) for k in w_off)


def test_train_runs_the_synthetic_step_in_slices(tmp_path, monkeypatch, capsys):
    """train() under k = 4 is eager_steps at micro=4 from the same weights,
    bit for bit, and says so once."""
    from signaltrain_tpu_torch.models.st_model import st_model

    hist, weights = _train(tmp_path, monkeypatch, "4")
    assert capsys.readouterr().out.count("ST_TPU_MICROBATCH: the forward and backward run in 4 "
                                         "slices of 2 rows a step") == 1
    model = st_model(scale_factor=TRAIN_KW["scale_factor"], device="cpu",
                     generator=torch.Generator().manual_seed(TRAIN_KW["seed"]),
                     compute_dtype=torch.float32).train()
    opt, lr_fn = train_mod.make_optimizer(model, TRAIN_KW["lr_max"], TRAIN_KW["n_data_points"],
                                          TRAIN_KW["epochs"], BATCH)
    spec = model.spec
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              spec.in_chunk_size, spec.out_chunk_size)
    losses = train_mod.eager_steps(model, opt, lr_fn, batch_fn, BATCH, torch.Generator(),
                                   TRAIN_KW["seed"], 0, 2, micro=4)
    assert hist["train_loss"] == n(losses).tolist()
    assert all(torch.equal(weights[k], v) for k, v in model.named_parameters())


@pytest.mark.parametrize("tier,limit,want", [("resident", 4 << 30, 4), ("host", 1, 1)])
def test_file_tiers_slice_as_jax_does(tier, limit, want, tmp_path, monkeypatch):
    """On a file dataset under k = 4: the device-resident tier's step runs in
    slices, the host tier's whole (every call of loss_and_grads seen)."""
    seen = []
    real = train_mod.loss_and_grads

    def spy(*args, micro=1, **kw):
        seen.append(micro)
        return real(*args, micro=micro, **kw)

    monkeypatch.setattr(train_mod, "loss_and_grads", spy)
    monkeypatch.setenv("ST_TPU_MICROBATCH", "4")
    path = write_dataset(tmp_path / "ds", n_train=4, n_val=1)
    monkeypatch.chdir(tmp_path)
    fx = effects.make_effect("files", path=path, device="cpu")
    train_mod.train(fx, epochs=1, datapath=path, device_resident_limit_bytes=limit,
                    **FILE_TRAIN_KW)
    assert seen == [want, want]
