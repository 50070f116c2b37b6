"""The ``train-tcn300c-f32`` cell on the CPU: its arithmetic against direct
counts, its reference against the tests' plain reference, and its whole run
at a tiny size (TCN-300-C's 4 blocks at kernel 3, growth 2, 8 channels, 256
outputs; a batch of 6, a block of 2 steps), sound and broken: a broken train
step, FiLM dropped, BatchNorm on its running statistics, the target altered
(comp_4c's compressor bypassed), the control, and a program that has no
TCN."""

import importlib.util
import json
import sys

import pytest
import torch
import torch.nn.functional as F

from portbench import compare, counts_tcn, run as prun, weights_tcn
from portbench.drivers import train, train_tcn
from portbench.reference import tcn as ref_tcn

CELL = "train-tcn300c-f32"
SEED = 2**40 + 12345
CFG = json.loads((prun.HERE / "configs" / "tcn300c.json").read_text())
TINY = dict(kernel_size=3, dilation_growth=2, channels=8, out_chunk_size=256, in_chunk_size=286)


@pytest.fixture
def tiny(monkeypatch):
    full = prun.workload_files

    def small(name):
        wl, cfg = full(name)
        return (dict(wl, batch=6, n_data_points=12, status_every=1, trace_blocks=1),
                dict(cfg, **TINY))

    monkeypatch.setattr(prun, "workload_files", small)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield prun
    torch.set_num_threads(threads)


def test_the_cells_counts_by_hand():
    lengths = [78_856, 78_736, 77_536, 65_536]  # 78,868 less 12 x 1, 10, 100, 1000
    assert [l for _, _, l, _ in counts_tcn.blocks(CFG)] == lengths
    dilated = 2 * 13 * (32 * lengths[0] + 32 * 32 * sum(lengths[1:]))
    ones = 2 * 32 * (78_868 + 65_536)  # block 0's residual, the output
    assert counts_tcn.forward_flops(CFG) == dilated + ones == 5_980_266_240
    assert counts_tcn.train_step_flops(CFG) == 3 * counts_tcn.forward_flops(CFG) - (
        2 * 13 * 32 * lengths[0] + 2 * 32 * 78_868)  # block 0 and its residual: no data gradient
    name, flops, nbytes = counts_tcn.conv_calls(CFG, 32)[2]
    assert name == "fwd.1" and flops == 32 * 2 * 13 * 32 * 32 * lengths[1]
    assert nbytes == 4 * (32 * 32 * 78_856 + 32 * 32 * 13 + 32 * 32 * lengths[1])


def test_a_small_convolutions_counts_are_pytorchs():
    """One dilated convolution's forward, data and weight gradients against
    ``torch.utils.flop_counter``'s count of the same call."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dict(n_blocks=2, kernel_size=3, dilation_growth=4, channels=5, in_chunk_size=40)
    x = torch.randn(2, 5, 38, requires_grad=True)  # block 1's input: 40 - 2 x 1
    w = torch.randn(5, 5, 3, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        F.conv1d(x, w, dilation=4).sum().backward()
    calls = dict((n, f) for n, f, _ in counts_tcn.conv_calls(cfg, 2))
    assert calls["fwd.1"] + calls["dgrad.1"] + calls["wgrad.1"] == fc.get_total_flops()
    assert calls["fwd.1"] == 2 * 2 * 5 * 5 * 3 * (38 - 2 * 4)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_frozen_reference_is_the_tests_reference_in_float64():
    """``reference/tcn.py`` and ``tests/tcn_reference.py``, each loaded by its
    path, on the same weights and batches: the same losses, first gradients
    and parameters after three Adam steps, to float64 rounding."""
    # in its package, so that its import of reference/model.py resolves
    frozen = _load(prun.HERE / "reference" / "tcn.py", "portbench.reference.frozen_tcn")
    plain = _load(prun.ROOT / "tests" / "tcn_reference.py", "plain_tcn_reference")
    cfg = dict(CFG, **TINY)
    state = weights_tcn.make(cfg, 7, "cpu")
    g = torch.Generator().manual_seed(3)
    batches = [(torch.randn(4, 286, generator=g) * 0.3, torch.randn(4, 256, generator=g) * 0.3,
                torch.rand(4, 4, generator=g) - 0.5) for _ in range(3)]
    lrs = [1e-3, 2e-3, 3e-3]
    losses, first, params = frozen.train_steps(state, batches, lrs, cfg, "f64")
    want_losses, want_grads, want_params, _ = plain.train_steps(state, batches, lrs, cfg)
    assert losses == pytest.approx(want_losses, rel=1e-12)
    for k, v in first.items():
        torch.testing.assert_close(v, want_grads[0][k], rtol=1e-10, atol=1e-14)
        torch.testing.assert_close(params[k], want_params[k], rtol=1e-10, atol=1e-14)


def test_a_sound_run_of_the_cell_is_correct(tiny):
    for trace in (False, True):
        result, card = tiny.execute(CELL, SEED, 0.3, trace, "cpu")
        assert result["correct"], result["checks"]
        assert result["attempted"] > 0 and result["failed"] == 0
        _, e2e, layer = tiny.cell_entries(CELL)
        if trace:  # the readers find nothing on the CPU
            assert set(result["metrics"]) <= {m["name"] for m in layer}
        else:
            assert set(result["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {"tcn_mfu.train", "tcn_conv_roofline.train",
                                          "tcn_norm_phase_ms.train"}


def _film_dropped(self, u, c):
    return self.bn(u)


def _bn_running(self, u, c):
    g, b = self.adaptor(c)[..., None].chunk(2, dim=1)
    bn = self.bn
    return F.batch_norm(u, bn.running_mean, bn.running_var, training=False, eps=bn.eps) * g + b


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "film_dropped",
                                   "bn_running", "target_altered"])
def test_a_broken_tcn_step_is_not_correct(tiny, monkeypatch, fault):
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models import tcn
    from signaltrain_tpu_torch.training import train as train_mod

    if fault == "target_altered":  # synthesis at the TCN's rows: synth_gap's fault
        monkeypatch.setattr(effects.Compressor_4c, "_apply", lambda self, x, wc, g: (x, x))
    elif fault == "state_unchanged":
        monkeypatch.setattr(train_mod, "optimizer_step",
                            lambda model, opt, *a, **k: train_mod.loss_and_grads(model, *a[:3]))
    elif fault == "half_batch":
        orig = train_mod.loss_and_grads

        def half(model, x, y, knobs, *a, **k):
            n = x.shape[0] // 2
            return orig(model, x[:n], y[:n], knobs[:n], *a, **k)

        monkeypatch.setattr(train_mod, "loss_and_grads", half)
    else:
        monkeypatch.setattr(tcn.FiLM, "forward",
                            _film_dropped if fault == "film_dropped" else _bn_running)
    result, _ = tiny.execute(CELL, SEED, 0.2, False, "cpu")
    assert not result["correct"], result["checks"]


def test_the_control_fails(tiny):
    r = prun.Run(CELL, SEED, 0.0, False, "cpu")
    state = weights_tcn.make(r.config, r.weight_seed, r.device)
    nums = train.numbers(train_tcn.reference(r, state, "tf32"), train_tcn.reference(r, state))
    ok, checks = compare.judge(nums, r.workload["limits"], 0)
    assert not ok, checks
    assert ref_tcn.PRECISIONS == ("f64", "tf32")


def test_the_reference_with_the_compressor_bypassed_fails_synth_gap(tiny):
    r = prun.Run(CELL, SEED, 0.0, False, "cpu")
    state = weights_tcn.make(r.config, r.weight_seed, r.device)
    nums = train.numbers(train_tcn.reference(r, state, bypass=True),
                         train_tcn.reference(r, state))
    assert nums["synth_gap"] > r.workload["limits"]["synth_gap"], nums


def test_a_program_without_a_tcn_fails_at_once(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "signaltrain_tpu_torch.models.kinds", None)
    with pytest.raises(ImportError):
        tiny.execute(CELL, SEED, 0.2, False, "cpu")
