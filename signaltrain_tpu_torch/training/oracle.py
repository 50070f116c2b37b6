"""The single-process oracle of the data-parallel train step.

Counterpart of signaltrain_tpu/training/oracle.py. A data-parallel step
(``train.eager_steps`` or ``graphs.TrainGraph`` with a mesh) runs, on each
rank: reseed the generator for (step, shard), synthesize the rank's rows,
take the local loss and gradients, sum them over the ranks and divide by
``n_data``, clip the front-end gradients, step Adam. ``oracle_steps``
computes the same program in one process, on one device, with no process
group: a loop over the emulated shards draws each one's rows from its own
stream (``synth_data.step_generator(..., shard=s)``) and its gradients, the
mean over the ranks becomes an explicit mean of the stacked gradients and
losses, and the same clip and Adam step follow. It is plain PyTorch on the
model's device, so on a card it launches the kernels the ranks launch.

Agreement of the ranks' weights with the oracle's (``excess`` at most 1:
within the JAX test's ``ATOL`` / ``RTOL``, tests/test_multichip_oracle.py:41-42;
``max_param_delta`` reports the largest difference) shows the parallel
decomposition right: the shard streams, the scale of the mean, the order of
reduce and clip. The two add the shards in different orders, so beyond two
ranks they agree to float32 reassociation, not bit for bit. The oracle with
``reduce="sum"`` is the control that shows the check has teeth: the shards'
gradients added, not averaged (the classic data-parallel bug), must land
far outside it.

The oracle has no ``n_model``, as the JAX one has none
(signaltrain_tpu/training/oracle.py): tensor parallelism splits the
front-end's rows over the ranks of a data index, which all draw that index's
rows, so it changes only the order of the front-end's sums (the bins
gathered, the partial waveforms summed, the clip's L1 total summed over the
ranks), not the program. A dp x tp run is held against ``oracle_steps`` at
its ``n_data`` as it is, its front-end and Adam's moments gathered to whole
matrices (``checkpoint.training_tensors``).
"""

from __future__ import annotations

import torch

from ..data import synth_data
from . import train as train_mod

ATOL, RTOL = 2e-6, 2e-5
REDUCTIONS = {"mean": lambda t: t.mean(0), "sum": lambda t: t.sum(0)}


def oracle_steps(model: torch.nn.Module, opt: torch.optim.Optimizer, lr_fn, batch_fn,
                 batch_size: int, n_data: int, generator: torch.Generator, seed: int, step0: int,
                 n: int, clip_max_norm: float = 1.0, reduce: str = "mean",
                 micro: int = 1) -> torch.Tensor:
    """Steps step0 .. step0 + n - 1 of an ``n_data``-rank data-parallel run
    at global batch ``batch_size``, emulated in this process: the (n,) mean
    losses on the device. ``reduce="sum"`` adds the shards' gradients and
    losses instead (the control, module docstring). ``micro`` slices each
    shard's forward and backward as the ranks do (``train.loss_and_grads``),
    so a microbatched run is held against the same bits, not against the
    unsliced step."""
    combine = REDUCTIONS[reduce]
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} must divide over {n_data} shards")
    local = batch_size // n_data
    params = list(model.parameters())
    losses = []
    for step in range(step0, step0 + n):
        train_mod.set_lr(opt, lr_fn(step))
        shard_losses, shard_grads = [], []
        for shard in range(n_data):
            x, y, knobs = batch_fn(local, synth_data.step_generator(generator, seed, step, shard))
            shard_losses.append(train_mod.loss_and_grads(model, x, y, knobs, micro=micro))
            shard_grads.append([p.grad.clone() for p in params])
        for i, p in enumerate(params):
            p.grad = combine(torch.stack([g[i] for g in shard_grads]))
        losses.append(combine(torch.stack(shard_losses)))
        train_mod.clip_frontend_grads(model, clip_max_norm)
        opt.step()
    return torch.stack(losses)


def _tensors(m) -> dict:
    sd = dict(m.named_parameters()) if isinstance(m, torch.nn.Module) else m
    return {k: torch.as_tensor(v).detach().double().cpu() for k, v in sd.items()}


def _pairs(a, b):
    ta, tb = _tensors(a), _tensors(b)
    if ta.keys() != tb.keys():
        raise ValueError(f"the two hold different parameters: {sorted(ta.keys() ^ tb.keys())}")
    return [(ta[k], tb[k]) for k in ta]


def max_param_delta(a, b) -> float:
    """max over the parameters of max|a - b|, ``a`` and ``b`` models or state
    dicts of the same names (tensors or numpy arrays): the agreement bound."""
    return max(float((x - y).abs().max()) for x, y in _pairs(a, b))


def excess(got, want, atol: float = ATOL, rtol: float = RTOL) -> float:
    """The largest |got - want| / (atol + rtol |want|) over every entry,
    ``got`` and ``want`` as for ``max_param_delta``: at most 1 where every
    entry passes ``numpy.testing.assert_allclose(got, want, rtol, atol)``."""
    return max(float(((x - y).abs() / (atol + rtol * y.abs())).max()) for x, y in _pairs(got, want))


def state_excess(got: dict, want: dict, atol: float = ATOL, rtol: float = RTOL) -> float:
    """The check of a run against the oracle over the tensors of
    ``checkpoint.training_tensors`` (whole matrices): the largest of
    ``excess`` over the weights and Adam's two moments, entry by entry, as
    the JAX test holds the parameters and the optimizer state
    (tests/test_multichip_oracle.py:94-95), and, for each moment tensor,
    | |got| / |want| - 1 | / ``rtol`` of its norms. At most 1 passes. The
    moments carry the scale of the gradients, which Adam's normalized step
    hides from the weights and which their entries, far below ``atol`` at
    the flagship size, do not show; their norms do, and float32
    reassociation moves a norm by parts in a million."""
    worst = 0.0
    for key in ("state_dict", "exp_avg", "exp_avg_sq"):
        for x, y in _pairs(got[key], want[key]):
            worst = max(worst, float(((x - y).abs() / (atol + rtol * y.abs())).max()))
            if key != "state_dict" and float(y.norm()) > 0:
                worst = max(worst, abs(float(x.norm() / y.norm()) - 1) / rtol)
    return worst
