"""Training: the train / eval steps and the orchestration loop.

Counterpart of signaltrain_tpu/training/train.py. One step is data synthesis
on the device (``data/synth_data.py``, kernel C inside the effect), the model
forward (kernels A and B with ``frontend="fused"``), ``calc_loss``, backward
(kernels E and D), the L1 clip of the front-end gradients, and Adam under the
1cycle schedule. The loop dispatches step by step; losses stay on the device
and are fetched once per status line.

Float32 only: the JAX package's bf16 operand policy is not ported, and
neither are its plots, background writer, file datasets and multi-device
paths. Artifacts keep the reference's shapes: ``vl_avg_out.dat`` and
``val_err_mae.dat`` append logs in the working directory, the ``\\r`` status
line with lr / mom / smoothed loss, the checkpoint cadence, the first-epoch
ETA.
"""

from __future__ import annotations

import os
import time

import torch

from ..data import synth_data
from ..models.st_model import STModel, st_model
from ..utils.device import resolve_device
from . import checkpoint, loss as loss_mod, schedule

FRONTEND_PARAMS = (
    "mpaec.dft_analysis.conv_analysis_real.weight",
    "mpaec.dft_analysis.conv_analysis_imag.weight",
    "mpaec.dft_synthesis.conv_synthesis_real.weight",
    "mpaec.dft_synthesis.conv_synthesis_imag.weight",
)


def clip_frontend_grads(model: torch.nn.Module, max_norm: float = 1.0) -> torch.Tensor:
    """L1-norm clip of the front-end gradients only, in place: the joint norm
    over the four (ft, ft) matrices, coef = min(1, max_norm / (total + 1e-6)).
    Returns the norm (a device scalar; nothing is fetched)."""
    params = dict(model.named_parameters())
    grads = [params[name].grad for name in FRONTEND_PARAMS]
    total = torch.stack([g.abs().sum() for g in grads]).sum()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


def make_optimizer(model: torch.nn.Module, lr_max: float, n_data_points: int, epochs: int,
                   batch_size: int):
    """Adam (betas (0.9, 0.999), eps 1e-8, no weight decay) and the
    closed-form 1cycle schedule: (optimizer, lr_fn)."""
    lr_fn = schedule.one_cycle_fn(lr_max=lr_max, n_data_points=n_data_points, epochs=epochs,
                                  batch_size=batch_size)
    opt = torch.optim.Adam(model.parameters(), lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0)
    return opt, lr_fn


def _model_loss(model: STModel, x, y, knobs):
    y_hat, mag, mag_hat = model(x, knobs)
    scale = loss_mod.freq_scale(model.spec.ft_size // 2 + 1, str(x.device))
    return loss_mod.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale), (y_hat, mag, mag_hat)


def loss_and_grads(model: STModel, x: torch.Tensor, y: torch.Tensor,
                   knobs: torch.Tensor) -> torch.Tensor:
    """The training loss on one batch; leaves its gradients in ``.grad``."""
    model.zero_grad(set_to_none=True)
    l, _ = _model_loss(model, x, y, knobs)
    l.backward()
    return l.detach()


def train_step_from_arrays(model: STModel, opt: torch.optim.Optimizer, lr_fn, step: int,
                           x: torch.Tensor, y: torch.Tensor, knobs: torch.Tensor,
                           clip_max_norm: float = 1.0) -> torch.Tensor:
    """One optimizer step on the batch (x, y, knobs) at schedule position
    ``step``; returns the loss (a device scalar)."""
    l = loss_and_grads(model, x, y, knobs)
    clip_frontend_grads(model, clip_max_norm)
    lr = lr_fn(step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return l


@torch.no_grad()
def eval_step_from_arrays(model: STModel, x: torch.Tensor, y: torch.Tensor, knobs: torch.Tensor):
    """(loss, mae, (x, y, knobs, y_hat, mag, mag_hat)) on one batch."""
    l, (y_hat, mag, mag_hat) = _model_loss(model, x, y, knobs)
    return l, loss_mod.mae(y.float(), y_hat.float()), (x, y, knobs, y_hat, mag, mag_hat)


def train(
    effect,
    epochs: int = 100,
    n_data_points: int = 200000,
    batch_size: int = 20,
    cp_every: int = 25,
    sr: int = 44100,
    scale_factor: float = 1,
    shrink_factor: float = 4,
    lr_max: float = 1e-4,
    in_checkpointname: str = "modelcheckpoint.tar",
    out_checkpointname: str = "modelcheckpoint.tar",
    seed: int = 218,
    status_every: int = 10,
    device: str | torch.device = "cuda",
):
    """Main training routine on synthesized data, float32.

    Returns (model, history): the trained ``STModel`` and a dict of the
    per-step training losses (``train_loss``) and the per-epoch validation
    figures (``val_loss`` smoothed, ``val_mae`` of the last batch,
    ``val_mae_mean`` over the pass, ``step``). ``effect`` must live on
    ``device``. If ``in_checkpointname`` exists the run resumes from it: its
    geometry overrides the arguments, and its optimizer state and step are
    restored when it has them."""
    dev = resolve_device(device)
    if effect.device != dev:
        raise ValueError(f"effect is on {effect.device}, train() was given device {dev}")
    print(f"SignalTrain (PyTorch) training began at {time.ctime()}. Options:")
    print(f"    epochs = {epochs}, n_data_points = {n_data_points}, batch_size = {batch_size}")
    print(f"    scale_factor = {scale_factor}, shrink_factor = {shrink_factor}, "
          f"dtype = float32, device = {dev}")
    num_knobs = effect.num_knobs
    print(f"    num_knobs = {num_knobs}")
    effect.info()

    # checkpoint resume: its metadata overrides the geometry arguments
    state_dict, rv = None, {}
    if os.path.isfile(in_checkpointname):
        state_dict, rv = checkpoint.load_checkpoint(in_checkpointname)
        scale_factor, shrink_factor, sr = rv["scale_factor"], rv["shrink_factor"], rv["sr"]

    model = st_model(scale_factor=scale_factor, shrink_factor=shrink_factor, num_knobs=num_knobs,
                     sr=sr, device=dev, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.train()
    spec = model.spec
    print("Model defined.  Number of trainable parameters:",
          sum(p.numel() for p in model.parameters()))
    print("      in_chunk_size, out_chunk_size = ", spec.in_chunk_size, spec.out_chunk_size)

    opt, lr_fn = make_optimizer(model, lr_max, n_data_points, epochs, batch_size)
    mom_fn = schedule.momentum_fn(n_data_points, epochs, batch_size)
    step0 = 0
    if "optax_state" in rv:
        step0 = int(rv.get("optax_step", 0))
        checkpoint.restore_optimizer(model, opt, rv["optax_state"], step0)
        print(f"Restored optimizer state at step {step0}.")

    batch_fn = synth_data.make_synth_batch_fn(
        effect, spec.in_chunk_size, spec.out_chunk_size, sr=sr, augment=True)
    val_batch_fn = synth_data.make_synth_batch_fn(
        effect, spec.in_chunk_size, spec.out_chunk_size, sr=sr, augment=False)
    generator = torch.Generator(device=dev)
    steps_per_epoch = max(1, n_data_points // batch_size)
    val_steps = max(1, (n_data_points // 4) // batch_size)

    history = {"train_loss": [], "val_loss": [], "val_mae": [], "val_mae_mean": [], "step": step0}
    iter_count, batch_num = step0, 0
    avg_loss, vl_avg, beta = 0.0, 0.0, 0.98
    first_time = time.time()

    def report(pending, epoch, iter0, data_point0):
        """Fetch the pending device losses (one transfer) and print the
        status line: per-batch EMA, bias-corrected."""
        nonlocal avg_loss, batch_num
        for i, lv in enumerate(torch.stack(pending).cpu().tolist()):
            batch_num += 1
            history["train_loss"].append(lv)
            avg_loss = beta * avg_loss + (1 - beta) * lv
            if 0 == batch_num % status_every:
                smoothed = avg_loss / (1 - beta**batch_num)
                print(
                    f"\repoch {epoch + 1}/{epochs}, time: {time.time() - first_time:.2f}: "
                    f"lr={lr_fn(iter0 + i):.2e},mom={mom_fn(iter0 + i):.3f}, "
                    f"data_point {data_point0 + (i + 1) * batch_size}: "
                    f"loss: {smoothed:.3e}   ",
                    end="",
                )

    for epoch in range(epochs):
        print("")
        pending, iter0, data_point0 = [], iter_count, 0
        for s in range(steps_per_epoch):
            x, y, knobs = batch_fn(batch_size, synth_data.step_generator(generator, seed, iter_count))
            pending.append(train_step_from_arrays(model, opt, lr_fn, iter_count, x, y, knobs))
            iter_count += 1
            if len(pending) == status_every or s == steps_per_epoch - 1:
                report(pending, epoch, iter0, data_point0)
                iter0, data_point0 = iter_count, data_point0 + len(pending) * batch_size
                pending = []

        # ---- validation pass over the frozen batches, then the logs
        model.eval()
        losses_val, maes_val = [], []
        for v in range(val_steps):
            xv, yv, kv = val_batch_fn(batch_size, synth_data.val_step_generator(generator, v))
            lv, mv, _ = eval_step_from_arrays(model, xv, yv, kv)
            losses_val.append(lv)
            maes_val.append(mv)
        model.train()
        maes = torch.stack(maes_val).cpu().numpy()
        for lv in torch.stack(losses_val).cpu().tolist():
            vl_avg = beta * vl_avg + (1 - beta) * lv
        val_mae, val_mae_mean = float(maes[-1]), float(maes.mean())
        with open("vl_avg_out.dat", "a") as f:
            f.write(f"{epoch + 1} {vl_avg:.3e}\n")
        with open("val_err_mae.dat", "a") as f:
            # col 2: last-batch MAE (the reference's format); col 3: the mean
            # MAE over the whole validation pass
            f.write(f"{epoch + 1} {val_mae:.3e} {val_mae_mean:.3e}\n")
        history["val_loss"].append(vl_avg)
        history["val_mae"].append(val_mae)
        history["val_mae_mean"].append(val_mae_mean)
        history["step"] = iter_count

        if ((epoch + 1) % cp_every == 0) or (epoch == epochs - 1):
            checkpoint.save_checkpoint(out_checkpointname, model, effect, epoch,
                                       optimizer=opt, step=iter_count)

        if epoch == 0:
            secs_left = (time.time() - first_time) * (epochs - 1)
            print(f"\nExpect run to finish in roughly {secs_left / 3600.0:.1f} hours, "
                  f"on {time.ctime(time.time() + secs_left)}")

    print("\nTotal elapsed time for training loop =", time.time() - first_time)
    return model, history
