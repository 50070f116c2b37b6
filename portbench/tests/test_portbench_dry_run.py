"""Each cell's whole run on the CPU at a tiny size, its outputs checked by
the cell's own limits; then the same run with the timed path broken
underneath, once for each fault the cell can have, and ``correct`` must
come out false; and the control (the reference in the precision below the
configuration's, in the program's place) must fail the limits."""

import numpy as np
import pytest
import torch

from portbench import compare, run as prun
from portbench.drivers import serve, train

SEED = 2**40 + 12345
TRAIN = ["train-8k2k-bf16", "train-8k2k-f32"]
SERVE = ["serve-4k-songs", "serve-8k2k-songs"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_sound_run_is_correct(tiny, cell, trace):
    result, card = tiny.execute(cell, SEED, 0.3, trace, "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    _, e2e, layer = tiny.cell_entries(cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    if trace:
        assert set(result["metrics"]) <= want and "busy_s" in result["device"]
    else:
        assert set(result["metrics"]) == want
    assert "launches" in card and "plain_calls" in card


def _no_step(model, opt, *a, **k):
    from signaltrain_tpu_torch.training import train as train_mod

    return train_mod.loss_and_grads(model, *a[:3])


def _half_batch(orig):
    def half(model, x, y, knobs, *a, **k):
        n = x.shape[0] // 2
        return orig(model, x[:n], y[:n], knobs[:n], *a, **k)
    return half


def _loss_altered(orig):
    def altered(*a, **k):
        return orig(*a, **k) * 1.1
    return altered


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "target_altered",
                                   "loss_altered"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_broken_train_step_is_not_correct(tiny, monkeypatch, cell, fault):
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.training import train as train_mod

    if fault == "state_unchanged":
        monkeypatch.setattr(train_mod, "optimizer_step", _no_step)
    elif fault == "half_batch":
        monkeypatch.setattr(train_mod, "loss_and_grads", _half_batch(train_mod.loss_and_grads))
    elif fault == "target_altered":
        monkeypatch.setattr(effects.Compressor_4c, "_apply", lambda self, x, wc, g: (x, x))
    else:
        monkeypatch.setattr(train_mod, "optimizer_step", _loss_altered(train_mod.optimizer_step))
    result, _ = tiny.execute(cell, SEED, 0.2, False, "cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", SERVE)
def test_a_broken_serve_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from signaltrain_tpu_torch.inference import predict_long as pl
    from signaltrain_tpu_torch.models import st_model

    if fault == "half_batch":
        forward = st_model.STModel.forward

        def half(self, x, knobs, *a, **k):
            n = max(1, x.shape[0] // 2)
            y, mag, mag_hat = forward(self, x[:n], knobs[:n], *a, **k)
            return torch.cat([y, torch.zeros_like(y)])[: x.shape[0]], mag, mag_hat

        monkeypatch.setattr(st_model.STModel, "forward", half)
    else:
        orig = pl.predict_long

        def other_knobs(signal, knobs, model, **k):
            return orig(signal, np.roll(np.asarray(knobs), 1), model, **k)

        monkeypatch.setattr(pl, "predict_long", other_knobs)
    result, _ = tiny.execute(cell, SEED, 0.2, False, "cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_the_training_control_fails(tiny, cell):
    r = prun.Run(cell, SEED, 0.0, False, "cpu")
    from portbench import weights

    state = weights.make(r.config, r.weight_seed, r.device)
    control = {"bfloat16": "fp8", "float32": "tf32"}[r.workload["compute_dtype"]]
    nums = train.numbers(train.reference(r, state, control), train.reference(r, state))
    ok, checks = compare.judge(nums, r.workload["limits"], 0)
    assert not ok, checks


@pytest.mark.parametrize("cell", SERVE)
def test_the_serving_control_fails(tiny, cell):
    r = prun.Run(cell, SEED, 0.0, False, "cpu")
    from portbench import songs, weights

    state = weights.make(r.config, r.weight_seed, r.device)
    traffic = songs.Traffic(r.workload, r.config, np.random.default_rng(1))
    sig, knobs = traffic.next()
    y = serve.ref_model.predict_long(state, torch.from_numpy(sig), torch.from_numpy(knobs),
                                     r.config, "tf32").numpy()
    ok, checks = compare.judge(serve.gaps(r, state, [(sig, knobs, y)])[0],
                               r.workload["limits"], 0)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_cell_runs_on_the_card(card, cell):
    result, _ = prun.execute(cell, SEED, 2.0, False, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
