"""Training: the train / eval steps and the orchestration loop.

Counterpart of signaltrain_tpu/training/train.py. One step is data synthesis
on the device (``data/synth_data.py``, kernel C inside the effect), the model
forward (kernels A and B with ``frontend="fused"``), ``calc_loss``, backward
(kernels E and D), the L1 clip of the front-end gradients, and Adam under the
1cycle schedule.

On a CUDA device the loop runs the JAX package's fused multi-step dispatch as
CUDA graphs (``training/graphs.py``): each step and each validation batch
after the first (the capture's warm-up) is one replay of a captured graph,
and Adam is ``capturable``, its learning rate a tensor on the card. There is
no eager fallback: a capture that fails raises. On the CPU
(``device="cpu"``) the same steps run eagerly.

The host never waits on the card for what it only reports, as in the JAX
loop:

* the losses of a block of ``pick_n_inner`` steps (one step when the status
  cadence does not divide the epoch) are copied to pinned host memory behind
  the block, with an event, and read after the next block has been
  dispatched (``process_pending``);
* an epoch's validation figures (and, when a plot is due, its last batch and
  the weights, snapshotted on the card) are read after the next epoch's
  validation has been dispatched (``process_eval``): ``vl_avg_out.dat``,
  ``val_err_mae.dat`` and ``history`` get the same lines and values, one
  epoch later;
* checkpoints (``async_io.snapshot`` of the weights and Adam's state, then
  ``checkpoint.save_checkpoint``) and plots (``utils/plots.py``:
  ``val_data_*.png`` every ``plot_every`` epochs, the spectrogram and weight
  images every 20 epochs and at the last) are written by one background
  thread (``utils/async_io.AsyncWriter``). A failed write fails the run.

``ST_TPU_TIMING=1`` prints each epoch's wall time to stderr, split into the
loop's buckets: dispatch, pending, eval, evproc, cp and fetch (the host
tier's waits on its prefetcher), and the rest.

``ST_TPU_MICROBATCH=k`` (``microbatches``, read once, after the mesh fixes
the local batch) runs each step's forward and backward in k slices of the
synthesized or device-resident batch (``loss_and_grads(micro=k)``), as the
JAX package's ``_make_lg_fn``; the host tier's step and validation take the
whole batch, as JAX's do.

``train`` computes in ``compute_dtype``, bfloat16 by default as in the JAX
package (its mixed precision: bf16 products with float32 accumulation in the
front-end kernels and the autoencoders; parameters, Adam's state, the
trigonometry and the loss in float32), or float32.

With ``datapath`` it trains on a file dataset (``data/file_data.py``) over
``datapath/Train/`` and validates on ``datapath/Val/``. A corpus resident on
the device (f32 or int16) goes through the same graphs as synthesized data,
its batch function drawing from the step's generator. A host-resident
corpus is sampled from ``numpy.random.default_rng(seed)`` on a prefetch
thread and fed to ``graphs.ArraysTrainGraph`` (``host_steps`` on the CPU),
and validated on batches from a fresh ``default_rng(7)`` each pass, as the
JAX package does.

Inside a process group (``parallel/distributed.py``; ``cli.run_train --nproc``
or torchrun) ``train`` is one rank of a data-parallel run over the group's
world, the JAX package's ``shard_map`` over its ``"data"`` axis: each rank
takes ``batch_size // n_data`` rows a step from its own shard's stream
(``synth_data.step_generator(..., shard=rank)``, or its rows of the host
tier's global batch), the loss and the gradients are averaged over the ranks
(``reduce_grads``) before the front-end clip, and every rank takes the same
Adam step from the same weights (rank 0's, broadcast once after the build or
the resume). Validation draws the global frozen batches on every rank, each
evaluates its own rows and the figures are averaged (``pmean_validation``),
so they are the single-process ones up to float32 reassociation. Only the
primary (rank 0) prints, writes the logs, the checkpoints and the plots (its
plots draw its own rows; example 0 of the global batch is among them), and
the returned ``history`` is the same on every rank.

With ``n_model > 1`` the world is ``n_data x n_model`` ranks (the JAX
``("data", "model")`` mesh, ``parallel/mesh.py``): the ranks of one data
index draw the same rows (``shard=mesh.data_index``) and split the rows of
the four front-end matrices (the gemm front-end, with the model group's
collectives, ``parallel/tensor.py``); the gradient bucket is all-reduced over
the data group, the front-end clip's L1 total over the model group. The
replicated weights start from rank 0's and each shard from the rank of data
index 0 that holds its rows; checkpoints hold the gathered full matrices
(``checkpoint.training_tensors``), so a run resumes under any mesh shape. The
steps are dispatched op by op (``eager_steps``, ``host_steps``), over gloo
ranks and over NCCL across CUDA cards alike: gloo's collectives cannot be
captured in a CUDA graph, and a captured step of a model group of several
NCCL ranks has not been seen to finish (``Mesh.captures_collectives``). The
op-by-op steps match the single-process oracle on four cards
(``cli.time_data_parallel --nmodel 2`` and ``4``).
Artifacts keep the reference's shapes: ``vl_avg_out.dat`` and
``val_err_mae.dat`` append logs in the working directory, the ``\\r`` status
line with lr / mom / smoothed loss, the checkpoint cadence, the first-epoch
ETA.
"""

from __future__ import annotations

import functools
import os
import sys
import time
import traceback

import numpy as np
import torch

from ..data import synth_data
from ..models.st_model import STModel, st_model
from ..parallel import distributed
from ..parallel import mesh as meshlib
from ..parallel import tensor as tp
from ..utils import async_io
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
    On a tensor-parallel model the total is the sum of each rank's shard
    sums, all-reduced (summed) over the model group. Returns the norm (a
    device scalar; nothing is fetched)."""
    params = dict(model.named_parameters())
    grads = [params[name].grad for name in FRONTEND_PARAMS]
    total = torch.stack([g.abs().sum() for g in grads]).sum()
    shard = model.mpaec.dft_analysis.shard
    if shard is not None:
        total = tp.all_reduce_sum(total, shard.group)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


def make_optimizer(model: torch.nn.Module, lr_max: float, n_data_points: int, epochs: int,
                   batch_size: int):
    """Adam (betas (0.9, 0.999), eps 1e-8, no weight decay) and the
    closed-form 1cycle schedule: (optimizer, lr_fn).

    For parameters on a CUDA device the optimizer is
    ``Adam(capturable=True)`` with the learning rate a float32 tensor on the
    card (``set_lr`` fills it), so that its step can be captured in a CUDA
    graph; it takes its bias corrections on the card in float32, as optax
    does. On the CPU, which refuses ``capturable``, it is the plain Adam with
    a float learning rate."""
    lr_fn = schedule.one_cycle_fn(lr_max=lr_max, n_data_points=n_data_points, epochs=epochs,
                                  batch_size=batch_size)
    return adam(model, lr_fn(0)), lr_fn


def adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``make_optimizer``'s Adam at learning rate ``lr`` (``set_lr`` moves
    it): capturable with the rate a tensor on the card, or the plain Adam on
    the CPU."""
    dev = next(model.parameters()).device
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if dev.type == "cuda":
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        return torch.optim.Adam(model.parameters(), lr=lr_t, capturable=True, **kw)
    return torch.optim.Adam(model.parameters(), lr=lr, **kw)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every param group: into a capturable Adam's lr
    tensor on the card (a fill, no copy from the host), else as the float."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def pick_n_inner(steps_per_epoch: int, status_every: int, cap: int = 50) -> int:
    """Steps between two fetches of the losses: the largest k <= cap that
    divides the epoch and is a multiple of the status cadence (1 if there is
    none). The JAX package's rule for the steps of one fused device call
    (signaltrain_tpu/training/train.py ``pick_n_inner``); here the host
    dispatches k steps (k graph replays on the card) before it fetches."""
    best = 1
    for k in range(status_every, min(cap, steps_per_epoch) + 1, status_every):
        if steps_per_epoch % k == 0:
            best = k
    return best


def _model_loss(model: STModel, x, y, knobs):
    y_hat, mag, mag_hat = model(x, knobs)
    scale = loss_mod.freq_scale(model.spec.ft_size // 2 + 1, str(x.device))
    return loss_mod.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale), (y_hat, mag, mag_hat)


class GradBucket:
    """Every parameter's ``.grad`` as a view into one flat float32 buffer on
    the parameters' device, and one slot for the loss after them: what a
    data-parallel step sums over the ranks in one collective
    (``reduce_grads``). Each view starts at a multiple of ``ALIGN`` elements,
    the alignment of a fresh allocation, so that a reduction over a gradient
    adds up in the order it does over a gradient of its own (a world-1 run
    stays bit-equal to the run without a mesh). Its owner passes it to
    ``loss_and_grads``, which zeroes it and backward accumulates into the
    views in place, where the single-process step makes fresh gradients."""

    ALIGN = 128

    def __init__(self, model: torch.nn.Module):
        self.params = list(model.parameters())
        offsets, end = [], 0
        for p in self.params:
            offsets.append(end)
            end += -(-p.numel() // self.ALIGN) * self.ALIGN
        self.flat = torch.zeros(end + 1, dtype=torch.float32, device=self.params[0].device)
        self.views = [self.flat[o : o + p.numel()].view_as(p) for p, o in zip(self.params, offsets)]
        self.loss = self.flat[end:]

    def zero(self) -> None:
        """Clear the bucket (the padding too) and make each ``.grad`` its view."""
        self.flat.zero_()
        for p, v in zip(self.params, self.views):
            p.grad = v

    def put_loss(self, loss: torch.Tensor) -> None:
        self.loss.copy_(loss.reshape(1))

    def mean(self, n_data: int) -> torch.Tensor:
        """Divide the summed gradients and loss by ``n_data``; the mean loss."""
        self.flat.div_(n_data)
        return self.loss[0]


def microbatches(local_batch: int) -> int:
    """The slices of a local batch a train step runs (``ST_TPU_MICROBATCH``,
    the JAX package's ``_make_lg_fn`` rule): k when the variable is k > 1 and
    k divides ``local_batch``, else 1 (the unsliced step, exactly)."""
    k = int(os.environ.get("ST_TPU_MICROBATCH", "0"))
    return k if k > 1 and local_batch % k == 0 else 1


def loss_and_grads(model: STModel, x: torch.Tensor, y: torch.Tensor, knobs: torch.Tensor,
                   bucket: GradBucket | None = None, micro: int = 1) -> torch.Tensor:
    """The training loss on one batch; leaves its gradients in ``.grad``:
    fresh tensors, or with ``bucket`` its views, zeroed first.

    With ``micro`` k > 1 (``microbatches``) the batch runs as k equal slices
    of rows, in order, each forward and backward in turn, as the JAX
    package's ``lax.scan`` with gradient accumulation: backward adds each
    slice's gradients into ``.grad`` (0 + g0 + g1 + ..., the JAX sum's
    order), the slice losses are summed, and both sums are multiplied by
    float32 1 / k. The mean loss and gradients of the whole batch, to
    float32 reassociation; a slice's activations are freed before the next
    slice runs."""
    if bucket is None:
        model.zero_grad(set_to_none=True)
    else:
        bucket.zero()
    if micro == 1:
        l, _ = _model_loss(model, x, y, knobs)
        l.backward()
        return l.detach()
    if x.shape[0] % micro:
        raise ValueError(f"{micro} microbatches do not divide a batch of {x.shape[0]}")
    rows = x.shape[0] // micro
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xs, ys, ks in zip(x.split(rows), y.split(rows), knobs.split(rows)):
        l, _ = _model_loss(model, xs, ys, ks)
        l.backward()
        total = total + l.detach()
    inv = 1.0 / micro  # a multiply in float32, as JAX scales its sums
    torch._foreach_mul_([p.grad for p in model.parameters() if p.grad is not None], inv)
    return total * inv


def reduce_grads(bucket: GradBucket, loss: torch.Tensor, mesh) -> torch.Tensor:
    """The JAX ``pmean`` of the loss and the gradients over ``mesh``'s data
    ranks: the loss put in the ``GradBucket`` that ``loss_and_grads`` filled,
    one all-reduce (sum) of it, then a division by ``n_data`` (gloo has no
    average; at world 1 the division is exact). Returns the mean loss (a
    device scalar)."""
    bucket.put_loss(loss)
    mesh.all_reduce(bucket.flat)
    return bucket.mean(mesh.n_data).clone()


def optimizer_step(model: STModel, opt: torch.optim.Optimizer, x: torch.Tensor,
                   y: torch.Tensor, knobs: torch.Tensor, clip_max_norm: float = 1.0,
                   mesh=None, micro: int = 1) -> torch.Tensor:
    """Loss and gradients on the batch (x, y, knobs) in ``micro`` slices
    (``loss_and_grads``), with ``mesh`` their mean over the data ranks
    (``reduce_grads``), the front-end clip and one optimizer step at the
    learning rate already set; returns the loss (a device scalar). Without a
    mesh it runs no host work that reads the card: what a train graph
    captures."""
    if mesh is None:
        l = loss_and_grads(model, x, y, knobs, micro=micro)
    else:
        bucket = GradBucket(model)
        l = reduce_grads(bucket, loss_and_grads(model, x, y, knobs, bucket, micro), mesh)
    clip_frontend_grads(model, clip_max_norm)
    opt.step()
    return l


def train_step_from_arrays(model: STModel, opt: torch.optim.Optimizer, lr_fn, step: int,
                           x: torch.Tensor, y: torch.Tensor, knobs: torch.Tensor,
                           clip_max_norm: float = 1.0, mesh=None, micro: int = 1) -> torch.Tensor:
    """One optimizer step on the batch (x, y, knobs) at schedule position
    ``step``, in ``micro`` slices; returns the loss (a device scalar). With
    ``mesh`` the batch is this rank's rows and the step takes the mean
    gradient over the ranks."""
    set_lr(opt, lr_fn(step))
    return optimizer_step(model, opt, x, y, knobs, clip_max_norm, mesh, micro)


@torch.no_grad()
def eval_step_from_arrays(model: STModel, x: torch.Tensor, y: torch.Tensor, knobs: torch.Tensor):
    """(loss, mae, (x, y, knobs, y_hat, mag, mag_hat)) on one batch."""
    l, (y_hat, mag, mag_hat) = _model_loss(model, x, y, knobs)
    return l, loss_mod.mae(y.float(), y_hat.float()), (x, y, knobs, y_hat, mag, mag_hat)


def eager_steps(model: STModel, opt: torch.optim.Optimizer, lr_fn, batch_fn, batch_size: int,
                generator: torch.Generator, seed: int, step0: int, n: int,
                mesh=None, micro: int = 1) -> torch.Tensor:
    """Steps step0 .. step0 + n - 1, each on the batch of
    ``synth_data.step_generator(generator, seed, step)``, dispatched one op
    at a time: the (n,) losses on the device. The loop on the CPU and under
    a tensor-parallel mesh of several ranks, and the reference that
    ``graphs.TrainGraph`` is bit-equal to on the card. With ``mesh`` each
    rank draws its ``batch_size // n_data`` rows from its data index's
    stream (``shard=mesh.data_index``) and the step takes the mean over the
    data ranks (``reduce_grads``). The whole local batch is synthesized at
    once and its forward and backward run in ``micro`` slices."""
    local, shard = ((batch_size, 0) if mesh is None
                    else (mesh.local_batch(batch_size), mesh.data_index))
    return torch.stack([
        train_step_from_arrays(
            model, opt, lr_fn, s,
            *batch_fn(local, synth_data.step_generator(generator, seed, s, shard)), mesh=mesh,
            micro=micro)
        for s in range(step0, step0 + n)])


def pmean_validation(mesh, losses: torch.Tensor, maes: torch.Tensor):
    """A validation pass's (losses, maes) over this rank's rows -> their
    means over the ranks, the global batches' figures up to float32
    reassociation (the shards are of one size). One all-reduce; nothing
    without a mesh."""
    if mesh is None:
        return losses, maes
    both = mesh.pmean(torch.stack([losses, maes]))
    return both[0], both[1]


def eager_validation(model: STModel, val_batch_fn, batch_size: int, generator: torch.Generator,
                     n_batches: int, mesh=None) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The validation pass over the frozen batches 0 .. n_batches - 1, op by
    op: (losses, maes, last), the losses and MAEs each (n_batches,) on the
    device, ``last`` the last batch's (x, y, knobs, y_hat, mag, mag_hat).
    With ``mesh`` every rank draws the global batch, evaluates its own rows
    (``mesh.local_rows``; ``last`` holds them) and the figures are averaged
    over the ranks (``pmean_validation``)."""
    rows = slice(None) if mesh is None else mesh.local_rows(batch_size)
    losses, maes = [], []
    for v in range(n_batches):
        x, y, knobs = val_batch_fn(batch_size, synth_data.val_step_generator(generator, v))
        l, m, last = eval_step_from_arrays(model, x[rows], y[rows], knobs[rows])
        losses.append(l)
        maes.append(m)
    return *pmean_validation(mesh, torch.stack(losses), torch.stack(maes)), last


def host_steps(model: STModel, opt: torch.optim.Optimizer, lr_fn, next_batch, step0: int,
               n: int, mesh=None) -> torch.Tensor:
    """Steps step0 .. step0 + n - 1, each on the batch ``next_batch()`` gives
    (a ``file_data.HostBatch``; with ``mesh``, this rank's rows of it),
    dispatched one op at a time: the (n,) losses on the device. The host
    tier's loop on the CPU, and the reference ``graphs.ArraysTrainGraph`` is
    bit-equal to on the card."""
    dev = next(model.parameters()).device
    return torch.stack([train_step_from_arrays(model, opt, lr_fn, s, *next_batch().take(dev),
                                               mesh=mesh)
                        for s in range(step0, step0 + n)])


def host_validation(model: STModel, batches, mesh=None) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The validation pass over numpy (x, y, knobs) batches (with ``mesh``,
    this rank's rows of each), op by op: (losses, maes, last) on the device,
    as ``eager_validation``."""
    dev = next(model.parameters()).device
    losses, maes = [], []
    for arrays in batches:
        l, m, last = eval_step_from_arrays(model, *(torch.from_numpy(a).to(dev) for a in arrays))
        losses.append(l)
        maes.append(m)
    return *pmean_validation(mesh, torch.stack(losses), torch.stack(maes)), last


class HostCopy:
    """A device tensor's copy to the host, started now (into pinned memory,
    with an event behind it on the card) and read later (``get`` waits for
    the event only). On the CPU it is the tensor itself."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type != "cuda":
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class _Timing:
    """``ST_TPU_TIMING=1``: each epoch's wall time split into the loop's
    buckets, printed to stderr. A bucket's time excludes the buckets timed
    inside it."""

    BUCKETS = ("dispatch", "pending", "eval", "evproc", "cp", "fetch")

    def __init__(self, on: bool):
        self.on = on
        self.acc = dict.fromkeys(self.BUCKETS, 0.0)
        self.t_epoch = 0.0

    def clock(self, bucket: str, fn, *args, **kwargs):
        if not self.on:
            return fn(*args, **kwargs)
        inner = sum(self.acc.values())
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.acc[bucket] += time.perf_counter() - t0 - (sum(self.acc.values()) - inner)
        return out

    def start_epoch(self) -> None:
        self.acc = dict.fromkeys(self.BUCKETS, 0.0)
        self.t_epoch = time.perf_counter()

    def report(self, epoch: int) -> None:
        if not self.on:
            return
        total = time.perf_counter() - self.t_epoch
        print(f"\n[timing] epoch {epoch + 1}: total={total:.4f}s "
              + " ".join(f"{k}={v:.4f}" for k, v in self.acc.items())
              + f" other={total - sum(self.acc.values()):.4f}", file=sys.stderr)


def train(
    effect,
    epochs: int = 100,
    n_data_points: int = 200000,
    batch_size: int = 20,
    plot_every: int = 10,
    cp_every: int = 25,
    sr: int = 44100,
    scale_factor: float = 1,
    shrink_factor: float = 4,
    lr_max: float = 1e-4,
    in_checkpointname: str = "modelcheckpoint.tar",
    out_checkpointname: str = "modelcheckpoint.tar",
    seed: int = 218,
    status_every: int = 10,
    make_plots: bool = True,
    device: str | torch.device = "cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
    datapath: str | None = None,
    target_type: str = "stream",
    compand: bool = False,
    device_resident_limit_bytes: int = 4 << 30,
    n_model: int = 1,
):
    """Main training routine, computing in ``compute_dtype`` (torch.bfloat16,
    the JAX package's default, or torch.float32), on data synthesized on the
    device or, with ``datapath``, on the file dataset there (``target_type``
    "chunk" re-runs ``effect`` on each cropped input; ``compand`` mu-law
    companding; ``device_resident_limit_bytes`` the device budget that picks
    the corpus's tier; ``n_model`` the ranks of the process group's world
    that split the front-end, module docstring). With ``make_plots`` the
    validation triptychs are
    drawn every ``plot_every`` epochs, the spectrogram and weight images
    every 20 epochs and at the last, on the background writer.

    Returns (model, history): the trained ``STModel`` and a dict of the
    per-step training losses (``train_loss``) and the per-epoch validation
    figures (``val_loss`` smoothed, ``val_mae`` of the last batch,
    ``val_mae_mean`` over the pass, ``step``). ``effect`` must live on
    ``device``. If ``in_checkpointname`` exists the run resumes from it: its
    geometry overrides the arguments, and its optimizer state and step are
    restored when it has them. On a CUDA device every step and validation
    batch but the first is a CUDA-graph replay (``training/graphs.py``)."""
    dev = resolve_device(device)
    if effect.device != dev:
        raise ValueError(f"effect is on {effect.device}, train() was given device {dev}")
    tensor_parallel = n_model > 1
    mesh = None
    if distributed.is_initialized() or tensor_parallel:
        mesh = meshlib.make_mesh(n_model=n_model, device=dev)
    local_batch = batch_size if mesh is None else mesh.local_batch(batch_size)
    micro = microbatches(local_batch)
    primary = distributed.is_primary()
    say = print if primary else (lambda *a, **k: None)
    say(f"SignalTrain (PyTorch) training began at {time.ctime()}. Options:")
    say(f"    epochs = {epochs}, n_data_points = {n_data_points}, batch_size = {batch_size}")
    say(f"    scale_factor = {scale_factor}, shrink_factor = {shrink_factor}, "
        f"compute_dtype = {str(compute_dtype).removeprefix('torch.')}, device = {dev}")
    if mesh is not None:
        say(f"    data parallel over {mesh.n_data} ranks, {local_batch} rows each a step")
    if tensor_parallel:
        say(f"    tensor parallel over {n_model} ranks: each holds its rows of the front-end")
    num_knobs = effect.num_knobs
    say(f"    num_knobs = {num_knobs}")
    if primary:
        effect.info()

    # checkpoint resume: its metadata overrides the geometry arguments
    state_dict, rv = None, {}
    if os.path.isfile(in_checkpointname):
        state_dict, rv = checkpoint.load_checkpoint(in_checkpointname)
        scale_factor, shrink_factor, sr = rv["scale_factor"], rv["shrink_factor"], rv["sr"]

    model = st_model(scale_factor=scale_factor, shrink_factor=shrink_factor, num_knobs=num_knobs,
                     sr=sr, device=dev, generator=torch.Generator().manual_seed(seed),
                     compute_dtype=compute_dtype, mesh=mesh if tensor_parallel else None)
    if state_dict is not None:
        model.load_state_dict(checkpoint.shard_state_dict(model, state_dict), strict=True)
    model.train()
    spec = model.spec
    say("Model defined.  Number of trainable parameters:", checkpoint.param_count(model))
    say("      in_chunk_size, out_chunk_size = ", spec.in_chunk_size, spec.out_chunk_size)

    opt, lr_fn = make_optimizer(model, lr_max, n_data_points, epochs, batch_size)
    mom_fn = schedule.momentum_fn(n_data_points, epochs, batch_size)
    step0 = 0
    if "optax_state" in rv:
        step0 = int(rv.get("optax_step", 0))
        checkpoint.restore_optimizer(model, opt, rv["optax_state"], step0)
        say(f"Restored optimizer state at step {step0}.")
    if mesh is not None:  # every rank starts from one model
        mesh.broadcast_model(model)

    chunk, out_chunk = spec.in_chunk_size, spec.out_chunk_size
    steps_per_epoch = max(1, n_data_points // batch_size)
    val_steps = max(1, (n_data_points // 4) // batch_size)
    n_inner = pick_n_inner(steps_per_epoch, status_every)
    host_data, prefetcher = False, None
    # the primary rank alone times and prints its epochs (JAX: `if timing and primary`)
    timing = _Timing(os.environ.get("ST_TPU_TIMING", "0") == "1" and primary)
    if datapath is None:
        batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr, augment=True)
        val_batch_fn = synth_data.make_synth_batch_fn(effect, chunk, out_chunk, sr=sr,
                                                      augment=False)
    else:
        from ..data import file_data

        kw = dict(sr=sr, rerun=(target_type != "stream"), compand=compand,
                  device_resident_limit_bytes=device_resident_limit_bytes)
        train_ds = file_data.FileDataset(datapath + "/Train/", effect, chunk, out_chunk,
                                         augment=True, **kw)
        host_data = not train_ds.device_resident
        if host_data:  # the validation set is sampled on the host too
            kw["device_resident_limit_bytes"] = 0
        val_ds = file_data.FileDataset(datapath + "/Val/", effect, chunk, out_chunk,
                                       augment=False, **kw)
        batch_fn, val_batch_fn = train_ds.batch_fn, val_ds.batch_fn
    if host_data:  # the host tier's step is never sliced, as JAX's host-fed step
        micro = 1
    if micro > 1:
        say(f"ST_TPU_MICROBATCH: the forward and backward run in {micro} slices of "
            f"{local_batch // micro} rows a step")
    # graphs on the card, but not around a model group's collectives (gloo's, above)
    use_graphs = dev.type == "cuda" and not tensor_parallel
    if use_graphs:
        from . import graphs  # it builds on this module's steps
    generator = torch.Generator(device=dev)
    if host_data:
        # every rank draws the global batch from the one stream and crops its rows
        rows = None if mesh is None else mesh.local_rows(batch_size)
        prefetcher = train_ds.prefetch_batches(batch_size, np.random.default_rng(seed), rows=rows)
        next_batch = functools.partial(timing.clock, "fetch", prefetcher.next)
        shapes = [(local_batch, chunk), (local_batch, out_chunk), (local_batch, num_knobs)]

        def val_batches():  # the frozen validation stream
            vrng = np.random.default_rng(7)
            return (val_ds.host_batch(batch_size, vrng, rows=rows) for _ in range(val_steps))

        if use_graphs:
            run_steps = graphs.ArraysTrainGraph(model, opt, lr_fn, next_batch, shapes, n_inner,
                                                mesh=mesh)
            eval_graph = graphs.ArraysEvalGraph(model, shapes, val_steps, mesh=mesh)
            validate = lambda: eval_graph(val_batches())
        else:
            run_steps = functools.partial(host_steps, model, opt, lr_fn, next_batch, mesh=mesh)
            validate = lambda: host_validation(model, val_batches(), mesh=mesh)
    elif use_graphs:
        run_steps = graphs.TrainGraph(model, opt, lr_fn, batch_fn, batch_size, generator, seed,
                                      n_inner, mesh=mesh, micro=micro)
        validate = graphs.EvalGraph(model, val_batch_fn, batch_size, generator, val_steps,
                                    mesh=mesh)
    else:
        run_steps = functools.partial(eager_steps, model, opt, lr_fn, batch_fn, batch_size,
                                      generator, seed, mesh=mesh, micro=micro)
        validate = functools.partial(eager_validation, model, val_batch_fn, batch_size,
                                     generator, val_steps, mesh=mesh)

    history = {"train_loss": [], "val_loss": [], "val_mae": [], "val_mae_mean": [], "step": step0}
    iter_count, batch_num = step0, 0
    avg_loss, vl_avg, beta = 0.0, 0.0, 0.98
    pending = None  # (a block's losses on their way to the host, epoch, iter0, data_point0)
    pending_eval = None  # an epoch's validation results in flight
    frame_major = model.mpaec.frontend == "fused"  # mag / mag_hat come back (T, B, F)
    writer = async_io.AsyncWriter() if primary else None
    # the ranks that take part in gathering what rank 0 writes: rank 0's model group
    gathers = primary or (tensor_parallel and mesh.data_index == 0)
    first_time = time.time()

    def process_pending(pend):
        """A block's losses, read one block late: the per-batch EMA and the
        status line every ``status_every`` batches (bias-corrected)."""
        nonlocal avg_loss, batch_num
        losses, epoch, iter0, data_point0 = pend
        for i, lv in enumerate(losses.get().tolist()):
            batch_num += 1
            history["train_loss"].append(lv)
            avg_loss = beta * avg_loss + (1 - beta) * lv
            if 0 == batch_num % status_every:
                smoothed = avg_loss / (1 - beta**batch_num)
                say(
                    f"\repoch {epoch + 1}/{epochs}, time: {time.time() - first_time:.2f}: "
                    f"lr={lr_fn(iter0 + i):.2e},mom={mom_fn(iter0 + i):.3f}, "
                    f"data_point {data_point0 + (i + 1) * batch_size}: "
                    f"loss: {smoothed:.3e}   ",
                    end="",
                )

    def process_eval(ev):
        """An epoch's validation, read one epoch late: the logs, ``history``
        and the plots, handed to the writer."""
        nonlocal vl_avg
        epoch, step, losses_val, maes_val, last, weights, do_val_plot = ev
        losses = losses_val.get().tolist()
        maes = maes_val.get().numpy()
        for lv in losses:
            vl_avg = beta * vl_avg + (1 - beta) * lv
        val_mae, val_mae_mean = float(maes[-1]), float(maes.mean())
        if primary:
            with open("vl_avg_out.dat", "a") as f:
                f.write(f"{epoch + 1} {vl_avg:.3e}\n")
            with open("val_err_mae.dat", "a") as f:
                # col 2: last-batch MAE (the reference's format); col 3: the
                # mean MAE over the whole validation pass
                f.write(f"{epoch + 1} {val_mae:.3e} {val_mae_mean:.3e}\n")
        history["val_loss"].append(vl_avg)
        history["val_mae"].append(val_mae)
        history["val_mae_mean"].append(val_mae_mean)
        history["step"] = step
        if do_val_plot:
            def render_valdata(last=last, epoch=epoch, loss_val=losses[-1]):
                from ..utils import plots

                x, y, knobs, y_hat = (t.numpy() for t in last.to_host()[:4])
                plots.plot_valdata(x, knobs, y, y_hat, effect, epoch, loss_val,
                                   target_size=spec.out_chunk_size)

            print("\nSaving sample data plots", end="")
            writer.submit(render_valdata)
        if weights is not None:
            def render_spectrograms(last=last, weights=weights):
                from ..utils import plots

                mag, mag_hat = last.to_host()[4:]
                if frame_major:  # (T, B, F) -> (B, T, F)
                    mag, mag_hat = mag.transpose(0, 1), mag_hat.transpose(0, 1)
                plots.plot_spectrograms(weights.to_host(), mag.numpy(), mag_hat.numpy())

            writer.submit(render_spectrograms)

    def save(snap, epoch, step):
        checkpoint.save_checkpoint(out_checkpointname, spec, effect, epoch, snap.to_host(), step)

    try:
        for epoch in range(epochs):
            say("")
            timing.start_epoch()
            for block in range(steps_per_epoch // n_inner):
                with torch.profiler.record_function("train_block"):
                    losses = timing.clock("dispatch", run_steps, iter_count, n_inner)
                # each item leaves ``pending`` before it is processed, so the
                # error path never processes it twice
                pend, pending = pending, (HostCopy(losses), epoch, iter_count,
                                          block * n_inner * batch_size)
                iter_count += n_inner
                if pend is not None:
                    timing.clock("pending", process_pending, pend)

            # ---- validation over the frozen batches, dispatched; read next epoch
            do_val_plot = primary and make_plots and (epoch + 1) % plot_every == 0
            spec_due = make_plots and ((epoch + 1) % 20 == 0 or epoch == epochs - 1)
            do_spec_plot = primary and spec_due
            model.eval()
            losses_val, maes_val, last = timing.clock("eval", validate)
            model.train()
            weights = (checkpoint.training_tensors(model)["state_dict"] if gathers and spec_due
                       else None)
            new_eval = (epoch, iter_count, HostCopy(losses_val), HostCopy(maes_val),
                        async_io.snapshot(last) if do_val_plot or do_spec_plot else None,
                        async_io.snapshot(weights) if do_spec_plot else None,
                        do_val_plot)
            pend, pending = pending, None
            timing.clock("pending", process_pending, pend)
            ev, pending_eval = pending_eval, new_eval
            if ev is not None:
                timing.clock("evproc", process_eval, ev)

            if gathers and (((epoch + 1) % cp_every == 0) or (epoch == epochs - 1)):
                tensors = checkpoint.training_tensors(model, opt)
                if primary:
                    snap = timing.clock("cp", async_io.snapshot, tensors)
                    writer.submit(functools.partial(save, snap, epoch, iter_count))

            timing.report(epoch)
            if epoch == 0:
                secs_left = (time.time() - first_time) * (epochs - 1)
                say(f"\nExpect run to finish in roughly {secs_left / 3600.0:.1f} hours, "
                    f"on {time.ctime(time.time() + secs_left)}")

        # drain the pipelines: the last epoch's validation
        ev, pending_eval = pending_eval, None
        if ev is not None:
            process_eval(ev)
    except BaseException:
        # keep what already ran: the losses and the validation in flight are
        # written to the logs (a flush that fails must not hide the error)
        try:
            if pending is not None:
                process_pending(pending)
            if pending_eval is not None:
                process_eval(pending_eval)
        except Exception:
            traceback.print_exc()
        raise
    finally:
        # the producer thread ends with the run, or its error; the writer
        # drains, and re-raises a failed write unless another error is in flight
        in_flight = sys.exc_info()[0] is not None
        if prefetcher is not None:
            prefetcher.close()
        try:
            if writer is not None:
                writer.close()
        except Exception:
            if not in_flight:
                raise
            traceback.print_exc()

    say("\nTotal elapsed time for training loop =", time.time() - first_time)
    return model, history
