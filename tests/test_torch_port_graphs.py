"""The port's dispatch slice on the CPU: pick_n_inner, train()'s eager loop,
the optimizer state's device, and the host copies taken out of the step.

On the card ``train()`` replays CUDA graphs (``training/graphs.py``); their
tests, bit-equality with the eager step included, are in
tests/test_torch_port_cuda.py. Here:

* ``pick_n_inner`` equals the JAX package's over a grid of (steps_per_epoch,
  status_every, cap), with ``ST_TPU_N_INNER_CAP`` unset;
* ``train()`` on the CPU with a status cadence that does not divide the epoch
  records and prints the losses of stepping ``train_step_from_arrays`` by
  hand from the same seeds, bit for bit;
* ``restore_optimizer`` puts every tensor of Adam's state, ``step`` included,
  on its parameter's device, in float32;
* ``compressor_4controls`` (its knobs filled in on the device, ln 9 a
  constant, one division by the tensor), ``sweep`` and ``knobs_wc`` are
  bit-equal to the expressions they replace, written out here.
"""

import math
import re

import numpy as np
import pytest
import torch

from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import compressors, effects, synths
from signaltrain_tpu_torch.models.st_model import st_model
from signaltrain_tpu_torch.training import checkpoint, graphs
from signaltrain_tpu_torch.training import train as train_mod


@pytest.mark.parametrize("cap", [1, 7, 50, 250])
def test_pick_n_inner_matches_jax(cap, monkeypatch):
    monkeypatch.delenv("ST_TPU_N_INNER_CAP", raising=False)
    for steps in list(range(1, 121)) + [250, 1000, 1001]:
        for every in range(1, 13):
            assert train_mod.pick_n_inner(steps, every, cap) == jtrain.pick_n_inner(
                steps, every, cap), (steps, every, cap)
    assert train_mod.pick_n_inner(1000, 10) == jtrain.pick_n_inner(1000, 10) == 50


def _status_losses(out: str) -> list[tuple[str, str]]:
    """(data_point, smoothed loss) of every status line train() printed."""
    return re.findall(r"data_point (\d+): loss: (\S+)", out)


def test_train_on_cpu_with_a_ragged_status_cadence_matches_stepping_by_hand(tmp_path, monkeypatch,
                                                                         capsys):
    """7 steps an epoch, a status line every 3 batches: pick_n_inner gives 1,
    the losses are fetched every step, and the lines fall where the
    batch count says, across the epoch's end as before."""
    monkeypatch.chdir(tmp_path)
    seed, kw = 5, dict(n_data_points=56, batch_size=8, lr_max=1e-3, scale_factor=512 / 8192.0)
    effect = effects.Compressor_4c(device="cpu")
    assert train_mod.pick_n_inner(7, 3) == 1
    model, hist = train_mod.train(effect, epochs=2, cp_every=2, seed=seed, status_every=3,
                                  device="cpu", compute_dtype=torch.float32, make_plots=False,
                                  **kw)
    printed = _status_losses(capsys.readouterr().out)

    ref = st_model(scale_factor=kw["scale_factor"], device="cpu",
                   generator=torch.Generator().manual_seed(seed), compute_dtype=torch.float32)
    ref.train()
    opt, lr_fn = train_mod.make_optimizer(ref, kw["lr_max"], kw["n_data_points"], 2, 8)
    spec = ref.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    g = torch.Generator()
    losses = [float(train_mod.train_step_from_arrays(
        ref, opt, lr_fn, s, *batch_fn(8, synth_data.step_generator(g, seed, s))))
        for s in range(14)]
    assert hist["train_loss"] == losses and hist["step"] == 14
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    want, avg = [], 0.0
    for i, lv in enumerate(losses, start=1):
        avg = 0.98 * avg + 0.02 * lv
        if i % 3 == 0:
            want.append((str(((i - 1) % 7 + 1) * 8), f"{avg / (1 - 0.98 ** i):.3e}"))
    assert printed == want


def test_restore_optimizer_puts_step_on_the_parameters_device(tmp_path):
    model = st_model(scale_factor=512 / 8192.0, device="cpu",
                     generator=torch.Generator().manual_seed(0), compute_dtype=torch.float32)
    opt, _ = train_mod.make_optimizer(model, 1e-3, 80, 1, 8)
    path = str(tmp_path / "c.tar")
    checkpoint.save_checkpoint(path, model.spec, effects.Compressor_4c(device="cpu"), 0,
                               checkpoint.training_tensors(model, opt))
    leaves = checkpoint.load_checkpoint(path)[1]["optax_state"]
    checkpoint.restore_optimizer(model, opt, leaves, 12)
    for p in model.parameters():
        st = opt.state[p]
        assert st["step"].device == p.device and st["step"].dtype == torch.float32
        assert float(st["step"]) == 12.0 and st["step"].dim() == 0
        assert st["exp_avg"].device == p.device and st["exp_avg_sq"].device == p.device


def test_graphs_need_a_cuda_generator():
    model = st_model(scale_factor=512 / 8192.0, device="cpu",
                     generator=torch.Generator().manual_seed(0), compute_dtype=torch.float32)
    opt, lr_fn = train_mod.make_optimizer(model, 1e-3, 80, 1, 8)
    assert not isinstance(opt.param_groups[0]["lr"], torch.Tensor)  # the CPU keeps plain Adam
    with pytest.raises(ValueError):
        graphs.TrainGraph(model, opt, lr_fn, None, 8, torch.Generator(), 0, 10)
    with pytest.raises(ValueError):
        graphs.EvalGraph(model, None, 8, torch.Generator(), 2)


def _old_compressor(x, thresh, ratio, attack_time, release_time, sr=44100.0):
    """compressor_4controls as it was written before its knobs were filled in
    on the device: torch.as_tensor of each knob, ln 9 by torch.log of a
    tensor, and the division of the negated tensor."""

    def per_example(k):
        k = torch.as_tensor(k, dtype=torch.float32, device=x.device)
        return k if k.dim() == 0 else k.reshape(x.shape[:-1] + (1,))

    thresh, ratio = per_example(thresh), per_example(ratio)
    attack_time, release_time = per_example(attack_time), per_example(release_time)
    ln9 = torch.log(torch.tensor(9.0, dtype=torch.float32, device=x.device))
    alpha_a = torch.exp(-ln9 / (sr * attack_time))
    alpha_r = torch.exp(-ln9 / (sr * release_time))
    x_db = torch.clamp_min(20.0 * torch.log10(torch.abs(x) + 1e-8), -96.0)
    gc = torch.where(x_db > thresh, thresh + (x_db - thresh) / ratio - x_db, torch.zeros_like(x_db))
    env = compressors._smooth(gc, alpha_a, alpha_r)
    return torch.pow(10.0, env / 20.0) * x, (gc, alpha_a, alpha_r)


@pytest.mark.parametrize("knobs", ["floats", "numpy_float32", "per_example"])
def test_compressor_is_bit_equal_to_its_earlier_expressions(knobs):
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.normal(size=(4, 700)) * 0.5).astype(np.float32))
    if knobs == "per_example":
        k = [torch.from_numpy(rng.uniform(lo, hi, size=4).astype(np.float32))
             for lo, hi in ((-30, 0), (1, 5), (1e-3, 4e-2), (1e-3, 4e-2))]
    else:
        k = [-17.3, 3.1, 0.0071, 0.023]
        if knobs == "numpy_float32":
            k = [np.float32(v) for v in k]
    y, want = compressors.compressor_4controls(x, *k), _old_compressor(x, *k)
    got = compressors.gain_curve(x, *k)
    for a, b in zip(got, want[1]):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(y, want[0])
    assert compressors.LN9 == torch.log(torch.tensor(9.0, dtype=torch.float32)).item()


def test_sweep_and_knob_scaling_are_bit_equal_to_their_earlier_expressions():
    rng = np.random.default_rng(4)
    t = torch.arange(512, dtype=torch.float32) / 44100.0
    d = {"amp": torch.rand(1, generator=torch.Generator().manual_seed(1)),
         "norm": torch.rand(1, generator=torch.Generator().manual_seed(2))}
    amp_too = torch.tensor([True])
    col = lambda v: v[:, None]  # noqa: E731
    # sweep's body with torch.as_tensor of its two frequencies
    lnfr = torch.log(torch.as_tensor(13000.0, dtype=t.dtype)
                     / torch.as_tensor(55.0, dtype=t.dtype)).reshape(-1, 1)
    tmax = t[-1]
    old = col(0.9 * d["amp"]) * torch.sin(
        20.0 * 2.0 * math.pi * tmax / lnfr * (torch.exp(t / tmax * lnfr) - 1.0))
    old = torch.where(col(amp_too), old * torch.exp(lnfr * t / tmax), old)
    old = synths.normish(old, d["norm"])
    assert torch.equal(synths.sweep(t, d, 55.0, 13000.0, amp_too), old)
    as_tensors = synths.sweep(t, d, torch.tensor([55.0]), torch.tensor([13000.0]), amp_too)
    assert torch.equal(as_tensors, old)

    effect = effects.Compressor_4c(device="cpu")
    kn = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(6, 4)).astype(np.float32))
    kr = torch.as_tensor(effect.knob_ranges, dtype=torch.float32)
    assert torch.equal(effect.knobs_wc(kn), kr[:, 0] + (kn + 0.5) * (kr[:, 1] - kr[:, 0]))
    assert effect.knob_ranges_on(kn.device) is effect.knob_ranges_on(kn.device)  # copied once
