"""Training: the program's train step replayed in blocks, as ``train()``
replays it.

Set-up builds the model with the seeded weights, ``make_optimizer``'s Adam
and 1cycle schedule, the comp_4c batches synthesized on the device and one
``graphs.TrainGraph`` (on the CPU, which has no graphs, the eager steps
``train()`` runs there). It runs the first three steps through that object
(the capture's warm-up, then two replays), keeps what the check compares,
then one block of ``pick_n_inner`` steps. The window replays blocks of that
many steps, copies each block's losses to the host behind it and reads them
after the next block is dispatched; a step counts once its block's losses
are on the host. The traffic file gives the batch, the schedule's
``n_data_points`` and ``epochs``, ``status_every``, ``lr_max`` and
``trace_blocks``, the blocks the traced run profiles.

After the window the reference follows the first three steps from the same
weights and seed in float64, and ``compare`` judges the program's.
"""

from __future__ import annotations

import math
import statistics

import torch

from .. import compare, weights
from ..reference import model as ref_model, synth as ref_synth


class _EagerSteps:
    """The CPU's counterpart of ``TrainGraph``: the same call, the eager steps."""

    def __init__(self, train_mod, synth_data, model, opt, lr_fn, batch_fn, batch, gen, seed):
        self.args = (model, opt, lr_fn, batch_fn, batch, gen, seed)
        self.train_mod, self.synth_data = train_mod, synth_data
        self.last = None

    def __call__(self, step0: int, n: int) -> torch.Tensor:
        self.last = step0 + n - 1
        return self.train_mod.eager_steps(*self.args, step0, n)

    @property
    def batch(self):
        _, _, _, batch_fn, b, gen, seed = self.args
        return batch_fn(b, self.synth_data.step_generator(gen, seed, self.last))


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def build(r):
    """The program's model, optimizer, schedule and step object for the run:
    (model, opt, steps, state, n_inner), ``state`` the seeded weights. Notes
    each part's end on stderr."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp.effects import make_effect
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.training import train as train_mod

    wl, cfg, dev = r.workload, r.config, r.device
    b = wl["batch"]
    state = weights.make(cfg, r.weight_seed, dev)
    r.note("weights made")
    model = st_model(cfg["scale_factor"], cfg["shrink_factor"], cfg["num_knobs"], cfg["sr"],
                     device=dev, compute_dtype=getattr(torch, wl["compute_dtype"]))
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
        steps = _EagerSteps(train_mod, synth_data, model, opt, lr_fn, batch_fn, b, gen,
                            r.data_seed)
    return model, opt, steps, state, n_inner


def first_three(model, opt, steps) -> dict:
    """Steps 0, 1 and 2 through ``steps`` (the capture's warm-up and two
    replays on the card), and what the check compares: each step's loss,
    each leaf's norm of the first gradient as Adam got it (its first moment
    over 1 - beta1; 0 where Adam holds none), of the change over the three
    steps, and the third step's batch."""
    params = dict(model.named_parameters())
    theta0 = {k: p.detach().clone() for k, p in params.items()}
    losses = [steps(0, 1)]
    moments = {k: opt.state.get(p, {}).get("exp_avg") for k, p in params.items()}
    grads = {k: 0.0 if m is None else float(m.double().norm()) / 0.1 for k, m in moments.items()}
    losses.append(steps(1, 2))
    return {"losses": [float(v) for v in torch.cat(losses).tolist()], "grads": grads,
            "update": {k: float((p.detach().double() - theta0[k].double()).norm())
                       for k, p in params.items()},
            "batch": [t.detach().clone() for t in steps.batch[:2]]}


def reference(r, state: dict, precision: str = "f64", rows=None, bypass: bool = False) -> dict:
    """What ``first_three`` reads, from the reference in ``precision`` (with
    ``rows`` of each batch, or the compressor bypassed: the faults the
    calibration reads)."""
    wl, cfg, b = r.workload, r.config, r.workload["batch"]
    batches = [ref_synth.batch(cfg, r.data_seed, s, b, r.device, bypass=bypass) for s in range(3)]
    lr = ref_model.one_cycle_lr(wl["lr_max"], wl["n_data_points"], wl["epochs"], b)
    losses, grads, params = ref_model.train_steps(state, batches, [lr(s) for s in range(3)], cfg,
                                                  precision, rows)
    return {"losses": losses, "grads": _norms(grads),
            "update": _norms({k: params[k] - state[k].double() for k in state}),
            "batch": list(batches[2][:2])}


def numbers(got: dict, ref: dict, leaves: bool = False) -> dict:
    """The numbers compared; with ``leaves`` also each leaf's gaps."""
    grad = compare.leaf_gaps(got["grads"], ref["grads"], ref["grads"])
    update = compare.leaf_gaps(got["update"], ref["update"], ref["grads"])
    out = {
        "synth_gap": max(compare.max_gap(p, q) for p, q in zip(got["batch"], ref["batch"])),
        "loss_gap": max(compare.rel(a, c) for a, c in zip(got["losses"], ref["losses"])),
        "grad_gap_median": statistics.median(grad.values()),
        "update_gap": max(update.values()),
    }
    if leaves:
        out.update(grad_leaves=grad, update_leaves=update)
    return out


def run(r):
    from signaltrain_tpu_torch.data import synth_data  # noqa: F401  (timed as imports)
    from signaltrain_tpu_torch.models import st_model  # noqa: F401
    from signaltrain_tpu_torch.training import train as train_mod

    if r.device.type == "cuda":
        from signaltrain_tpu_torch.training import graphs  # noqa: F401

    from ..run import Outcome

    wl, cfg = r.workload, r.config
    b = wl["batch"]
    r.note("imports")
    model, opt, steps, state, n_inner = build(r)
    r.note("train graph made")
    got = first_three(model, opt, steps)
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
        numbers=numbers(got, reference(r, state)), memory_peak=memory,
        end_to_end={"train_audio_s_per_s": done * audio_s / window_s},
        window={"window_s": window_s, "steps": done, "examples": done * b,
                "steps_per_block": n_inner, "batch": b, "dtype": wl["compute_dtype"]})
