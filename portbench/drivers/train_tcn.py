"""Training TCN-300-C: the program's train step replayed in blocks, as
``train()`` replays it; ``drivers/train.py``'s loop and check with the TCN.

Set-up builds the program's TCN (``models/kinds.build_model("tcn")`` at
the configuration's sizes, which must give its ``in_chunk_size``) with the
seeded weights of ``weights_tcn.py``, ``make_optimizer``'s Adam and 1cycle
schedule, the comp_4c batches synthesized on the device at the TCN's
windows, and one ``graphs.TrainGraph`` (on the CPU, the eager steps). The
first three steps, the blocks of ``pick_n_inner`` steps and the window are
``drivers/train.py``'s; after the window ``reference/tcn.py`` follows the
first three steps from the same weights and seed in float64, and
``compare`` judges the program's numbers (``drivers/train.numbers``).

A program without a TCN fails at once, as the build's import raises.
"""

from __future__ import annotations

import math

import torch

from .. import weights_tcn
from ..reference import synth as ref_synth, tcn as ref_tcn
from . import train as base


def build(r):
    """(model, opt, steps, state, n_inner) of the run, as ``drivers/train.build``."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp.effects import make_effect
    from signaltrain_tpu_torch.models.kinds import build_model
    from signaltrain_tpu_torch.models.tcn import TCNSpec
    from signaltrain_tpu_torch.training import train as train_mod

    wl, cfg, dev = r.workload, r.config, r.device
    b = wl["batch"]
    model = build_model("tcn", num_knobs=cfg["num_knobs"], sr=cfg["sr"], device=dev,
                        compute_dtype=getattr(torch, wl["compute_dtype"]),
                        tcn=TCNSpec(**{k: cfg[k] for k in TCNSpec.SIZES}))
    if model.spec.in_chunk_size != cfg["in_chunk_size"]:
        raise ValueError(f"the TCN's window is {model.spec.in_chunk_size} samples, the "
                         f"configuration's {cfg['in_chunk_size']}")
    state = weights_tcn.make(cfg, r.weight_seed, dev)
    r.note("weights made")
    model.load_state_dict(state, strict=True)
    model.train()
    r.note("model built")
    opt, lr_fn = train_mod.make_optimizer(model, wl["lr_max"], wl["n_data_points"], wl["epochs"], b)
    effect = make_effect(cfg["effect"], sr=float(cfg["sr"]), device=dev)
    batch_fn = synth_data.make_synth_batch_fn(effect, cfg["in_chunk_size"], cfg["out_chunk_size"],
                                              sr=cfg["sr"], augment=True)
    n_inner = train_mod.pick_n_inner(wl["n_data_points"] // b, wl["status_every"])
    r.note("optimizer and data built")
    gen = torch.Generator(device=dev)
    if dev.type == "cuda":
        from signaltrain_tpu_torch.training import graphs

        steps = graphs.TrainGraph(model, opt, lr_fn, batch_fn, b, gen, r.data_seed, n_inner)
    else:
        steps = base._EagerSteps(train_mod, synth_data, model, opt, lr_fn, batch_fn, b, gen,
                                 r.data_seed)
    return model, opt, steps, state, n_inner


def reference(r, state: dict, precision: str = "f64", fault: str | None = None,
              bypass: bool = False) -> dict:
    """What ``drivers/train.first_three`` reads, from ``reference/tcn.py`` in
    ``precision`` (with ``fault`` in the program's place, or the compressor
    bypassed at the cell's rows: the calibration's faults)."""
    wl, cfg, b = r.workload, r.config, r.workload["batch"]
    batches = [ref_synth.batch(cfg, r.data_seed, s, b, r.device, bypass=bypass)
               for s in range(3)]
    lr = ref_tcn.one_cycle_lr(wl["lr_max"], wl["n_data_points"], wl["epochs"], b)
    losses, grads, params = ref_tcn.train_steps(state, batches, [lr(s) for s in range(3)], cfg,
                                                precision, fault)
    return {"losses": losses, "grads": base._norms(grads),
            "update": base._norms({k: params[k] - state[k].double() for k in params}),
            "batch": list(batches[2][:2])}


def run(r):
    from signaltrain_tpu_torch.training import train as train_mod

    if r.device.type == "cuda":
        from signaltrain_tpu_torch.training import graphs  # noqa: F401  (timed as imports)

    from ..run import Outcome

    wl, cfg = r.workload, r.config
    b = wl["batch"]
    r.note("imports")
    model, opt, steps, state, n_inner = build(r)
    r.note("train graph made")
    got = base.first_three(model, opt, steps)
    r.note("first three steps (capture included)")
    step = 3
    steps(step, n_inner)
    step += n_inner
    r.synchronize()
    r.note("one block warm")

    blocks = wl["trace_blocks"] if r.trace else None
    losses = []
    r.open_window()
    pending = None
    while (r.elapsed() < r.seconds) if blocks is None else (blocks > 0):
        with r.span("train_block"):
            copy = train_mod.HostCopy(steps(step, n_inner))
        step += n_inner
        if blocks is not None:
            blocks -= 1
        if pending is not None:
            losses += pending.get().tolist()
        pending = copy
    losses += pending.get().tolist()
    window_s = r.close_window()
    memory = r.memory_peak()
    del steps, opt, model
    r.free()

    done = len(losses)
    audio_s = b * cfg["out_chunk_size"] / cfg["sr"]
    return Outcome(
        attempted=done, failed=sum(1 for v in losses if not math.isfinite(v)),
        numbers=base.numbers(got, reference(r, state)), memory_peak=memory,
        end_to_end={"train_audio_s_per_s": done * audio_s / window_s},
        window={"window_s": window_s, "steps": done, "examples": done * b,
                "steps_per_block": n_inner, "batch": b, "dtype": wl["compute_dtype"]})
