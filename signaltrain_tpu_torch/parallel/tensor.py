"""The collectives of the tensor-parallel front-end, with their backward
passes written out.

Counterpart of what GSPMD inserts around the JAX package's front-end GEMMs
when the ``"model"`` axis shards their rows (signaltrain_tpu/parallel/
mesh.py:64-75, signaltrain_tpu/training/train.py:165-194). Every model rank
of a data group runs the same replicated autoencoders on the same rows, so
each of them holds the whole cotangent of the autoencoders' outputs; the
three functions below follow the Megatron-LM pattern of conjugate pairs:

* ``gather_bins`` (Megatron's ``gather_from_tensor_model_parallel_region``):
  forward, an all-gather of each rank's bins along the last axis; backward,
  this rank's bins sliced out of the whole cotangent, with no sum (a sum
  would scale the analysis' gradient by ``n_model``).
* ``enter_shard`` (Megatron's ``f``, ``copy_to_tensor_model_parallel_
  region``, followed by the slice to this rank's channels): forward, the
  replicated spectrum sliced to this rank's bins; backward, the slice's
  cotangent put back in place and summed over the model group, since each
  rank's rows give only a part of the cotangent of ``mag_hat`` /
  ``phs_hat``.
* ``sum_partials`` (Megatron's ``g``, ``reduce_from_tensor_model_parallel_
  region``): forward, an all-reduce (sum) of the ranks' partial waveforms;
  backward, the identity (every rank needs the whole cotangent of its
  partial, which is the cotangent of the sum).

A ``group`` of None is this rank alone: each function is then its local
part (``parallel/mesh.FrontendShard``). ``all_reduce_sum`` and ``gather_rows``
are the plain collectives of the clip and the checkpoints.

``scale_control`` puts one of two wrong backward passes in place, for the
checks against the oracle (tests, ``chip_smoke.py``, ``cli.time_data_
parallel``), each of which must fail them: the gather's backward summing
where it must slice, and the synthesis input's not summing where it must.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in place (nothing for None); returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _all_gather_last(t: torch.Tensor, sizes: list[int], group) -> torch.Tensor:
    """Each rank's (..., sizes[rank]) -> their concatenation along the last
    axis, in rank order. gloo and NCCL gather equal shapes, so each part is
    padded to the largest and cut after."""
    width = max(sizes)
    part = torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()
    parts = [torch.empty_like(part) for _ in sizes]
    dist.all_gather(parts, part, group=group)
    return torch.cat([p[..., :s] for p, s in zip(parts, sizes)], dim=-1)


class _GatherBins(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        lo, hi = shard.bins()
        ctx.lo, ctx.hi, ctx.group = lo, hi, shard.group
        if shard.group is None:
            return x.clone()
        sizes = [shard.bins(m)[1] - shard.bins(m)[0] for m in range(shard.n_model)]
        return _all_gather_last(x, sizes, shard.group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo : ctx.hi].contiguous(), None


class _EnterShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        lo, hi = shard.bins()
        ctx.lo, ctx.hi, ctx.full, ctx.group = lo, hi, x.shape[-1], shard.group
        return x[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((*g.shape[:-1], ctx.full))
        full[..., ctx.lo : ctx.hi] = g
        return all_reduce_sum(full, ctx.group), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_bins(x: torch.Tensor, shard) -> torch.Tensor:
    """(..., hi - lo) values of this rank's bins -> (..., half) of every
    bin, the same on each rank of the model group (module docstring)."""
    return _GatherBins.apply(x, shard)


def enter_shard(x: torch.Tensor, shard) -> torch.Tensor:
    """(..., half) replicated -> (..., hi - lo), this rank's bins; its
    backward sums the cotangent over the model group (module docstring)."""
    return _EnterShard.apply(x, shard)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' partial sums of one tensor -> their sum, on every rank of
    ``group``; backward, the identity (module docstring)."""
    return _SumPartials.apply(x, group)


@torch.no_grad()
def gather_rows(t: torch.Tensor, shard) -> torch.Tensor:
    """This rank's rows (``shard.rows()``, along axis 0) of a tensor of
    ``shard.ft`` rows -> the whole tensor, on every rank of the model group:
    an all-gather (the checkpoints' counterpart of the JAX mesh-agnostic
    form, tests/test_mesh_elastic.py)."""
    if shard.group is None:
        full = t.new_empty((shard.ft, *t.shape[1:]))
        full[torch.as_tensor(shard.rows(), device=t.device)] = t
        return full
    counts = [len(shard.rows(m)) for m in range(shard.n_model)]
    width = max(counts)
    part = t.new_zeros((width, *t.shape[1:]))
    part[: t.shape[0]] = t
    parts = [torch.empty_like(part) for _ in counts]
    dist.all_gather(parts, part, group=shard.group)
    full = t.new_empty((shard.ft, *t.shape[1:]))
    for m, (p, c) in enumerate(zip(parts, counts)):
        full[torch.as_tensor(shard.rows(m), device=t.device)] = p[:c]
    return full


def _gather_sums(ctx, g):
    return all_reduce_sum(g.clone(), ctx.group)[..., ctx.lo : ctx.hi].contiguous(), None


def _input_not_summed(ctx, g):
    full = g.new_zeros((*g.shape[:-1], ctx.full))
    full[..., ctx.lo : ctx.hi] = g
    return full, None


SCALE_CONTROLS = {"gather_sums": (_GatherBins, _gather_sums),
                  "input_not_summed": (_EnterShard, _input_not_summed)}


@contextlib.contextmanager
def scale_control(name: str):
    """Within the block, in this process, the backward of ``gather_bins``
    sums over the model group (``"gather_sums"``) or that of
    ``enter_shard`` does not (``"input_not_summed"``): the controls of the
    checks (module docstring)."""
    cls, backward = SCALE_CONTROLS[name]
    right = cls.backward
    cls.backward = staticmethod(backward)
    try:
        yield
    finally:
        cls.backward = right
