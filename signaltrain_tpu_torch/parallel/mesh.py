"""The ``("data", "model")`` mesh: which rows of a global batch and which
rows of the front-end matrices this rank owns, and the collectives over its
two kinds of subgroup.

Counterpart of signaltrain_tpu/parallel/mesh.py (``make_mesh``, ``:28``;
``param_shardings``, ``:64-75``). The JAX mesh is ``("data", "model")`` over
every visible device; here each rank is one process on one device
(``parallel/distributed.py``), and the world of the process group is
``n_data x n_model`` ranks in JAX's layout: rank ``r`` holds data shard
``r // n_model`` and model shard ``r % n_model``.

* ``"data"``: each data index synthesizes its own rows of the global batch;
  the gradients and the loss are all-reduced over the data group (the ranks
  of one model index) and divided by ``n_data`` (the JAX ``pmean``).
* ``"model"`` (tensor parallelism): the ranks of one data index split the
  rows of the four (ft, ft) front-end matrices (``FrontendShard``) and run
  the same replicated autoencoders on the same rows; the front-end's
  collectives run over the model group (``parallel/tensor.py``). Everything
  else is replicated, as in JAX.

JAX's row split ``P("model", None)`` would leave the analysis unbalanced (at
``n_model = 2`` rank 0 holds 512 of the 513 used bins). The port balances it:
the 513 used bins are split into contiguous chunks of near-equal size, and a
rank holds, of every matrix, the rows of its bins and their conjugate mirrors
``ft - c``. So each rank holds about ``ft / n_model`` rows and folds its own
synthesis rows (row ``ft - c`` adds onto row ``c`` on the same rank); its
synthesis multiplies a near-equal share of the channels, while its analysis
product keeps the unsharded width for the single card's bits
(``ops/frontend.py``). Checkpoints hold the gathered full matrices
(``training/checkpoint.py``), so the split never reaches a file.

With ``n_model = 1`` the mesh is the data mesh alone: its data group
is the world and no model collective runs unless a model is built on the mesh.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed


def bin_range(half: int, n_model: int, index: int) -> tuple[int, int]:
    """The used bins [lo, hi) of model rank ``index``: ``half`` bins in
    contiguous chunks, the first ``half % n_model`` one bin longer."""
    base, extra = divmod(half, n_model)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def frontend_rows(ft: int, n_model: int, index: int) -> np.ndarray:
    """The rows of each (ft, ft) front-end matrix that model rank ``index``
    holds, ascending: its bins [lo, hi) (all below ``half``), then the
    mirrors ``ft - c`` of its bins 1 <= c <= half - 2 (all at or above
    ``half``). Over the ranks they partition range(ft)."""
    half = ft // 2 + 1
    lo, hi = bin_range(half, n_model, index)
    plo, phi = max(lo, 1), min(hi, half - 1)
    mirrors = np.arange(ft - phi + 1, ft - plo + 1) if phi > plo else np.arange(0)
    return np.concatenate([np.arange(lo, hi), mirrors]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class FrontendShard:
    """Model rank ``index`` of ``n_model`` over ``group`` (the model group;
    None: this rank alone, ``n_model`` 1, and the front-end's collectives
    are identities): what its part of the front-end is. The counterpart of
    JAX's ``param_shardings``."""

    ft: int
    n_model: int
    index: int
    group: object = None

    @property
    def half(self) -> int:
        return self.ft // 2 + 1

    def bins(self, index: int | None = None) -> tuple[int, int]:
        """[lo, hi) of the used bins of rank ``index`` (this one when None)."""
        return bin_range(self.half, self.n_model, self.index if index is None else index)

    def rows(self, index: int | None = None) -> np.ndarray:
        """The matrix rows of rank ``index`` (this one when None), ascending."""
        return frontend_rows(self.ft, self.n_model, self.index if index is None else index)

    def paired(self) -> tuple[int, int]:
        """[plo, phi): this rank's bins that have a mirror row (1 <= c <=
        half - 2); its mirror rows are ft - c for them, ascending from
        ft - phi + 1, i.e. in reverse bin order."""
        lo, hi = self.bins()
        return max(lo, 1), min(hi, self.half - 1)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data x n_model`` ranks, this one global ``rank`` on ``device``.
    ``data_group`` is the ranks of this rank's model index (None: the world,
    as ``torch.distributed`` reads it), ``model_group`` the ranks of its data
    index (None: this rank alone, with no collective: outside a process
    group, and at ``n_model = 1`` in a world of several ranks)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def local_batch(self, batch: int) -> int:
        """The rows of a global batch of ``batch`` that each data index takes."""
        if batch % self.n_data:
            raise ValueError(f"batch_size {batch} must divide over the mesh's {self.n_data} "
                             "'data' ranks; pass a batch size that the world divides")
        return batch // self.n_data

    def local_rows(self, batch: int) -> slice:
        """This data index's contiguous rows of a global batch of ``batch``."""
        n = self.local_batch(batch)
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def frontend_shard(self, ft: int) -> FrontendShard:
        """This rank's part of the four (ft, ft) front-end matrices."""
        return FrontendShard(ft, self.n_model, self.model_index, self.model_group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group, in place (nothing outside a process
        group); returns ``t``."""
        if distributed.is_initialized():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)
        return t

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group and divided by ``n_data``, in
        place (the JAX ``lax.pmean``: gloo has no average, and dividing by 1
        is exact)."""
        return self.all_reduce(t).div_(self.n_data)

    def captures_collectives(self) -> bool:
        """Whether a CUDA graph may hold the model group's collectives
        (``training/graphs.py``): with no model group there is none to
        capture; gloo's cannot be captured; NCCL's are captured on a group
        of one rank, and on a group of several the steps run op by op, as
        no captured step of such a group has been seen to finish on the
        cards (PERF.md, open questions)."""
        return self.model_group is None or (
            dist.get_backend(self.model_group) == dist.Backend.NCCL
            and dist.get_world_size(self.model_group) == 1)

    @torch.no_grad()
    def broadcast_model(self, model: torch.nn.Module) -> None:
        """Every rank starts from one model: the replicated parameters and
        buffers from global rank 0, each front-end shard over the data group
        from the rank of data index 0 that holds the same rows."""
        if not distributed.is_initialized():
            return
        shards = {id(p) for m in model.modules() if getattr(m, "shard", None) is not None
                  for p in m.parameters()}
        for t in [*model.parameters(), *model.buffers()]:
            if id(t) in shards:
                dist.broadcast(t, self.model_index, group=self.data_group)
            else:
                dist.broadcast(t, 0)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The ``n_data x n_model`` mesh over the process group's world (world 1
    when no group was initialized), this rank on ``device``. The world must
    be ``n_data x n_model`` (``n_data`` defaults to world // n_model). Every
    rank calls it at the same point: with ``n_model > 1`` the subgroups are
    made with ``dist.new_group`` in one order on every rank (the model
    groups, then the data groups), and one all-reduce on each of this rank's
    builds its communicator now, not in a step or a capture; each subgroup's
    collectives are bounded by ``distributed.TIMEOUT_S``, as the world's. With
    ``n_model = 1`` the data group is the world, and the model group is the
    world at world 1 (a model built on that mesh runs its collectives over a
    group of one) and none otherwise."""
    world = distributed.world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model {n_model}: the process group's {world} ranks are not "
                         f"n_data x {n_model}; run n_data x n_model ranks (--nproc)")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"n_data {n_data} x n_model {n_model}: the process group has {world} "
                         "ranks, one per shard")
    dev = resolve_device(device)
    rank = distributed.rank()
    if not distributed.is_initialized():
        return Mesh(n_data=n_data, n_model=n_model, rank=rank, device=dev)
    if n_model == 1:
        return Mesh(n_data=n_data, n_model=1, rank=rank, device=dev,
                    model_group=dist.group.WORLD if world == 1 else None)
    timeout = datetime.timedelta(seconds=distributed.TIMEOUT_S)
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
        if d == rank // n_model:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
        if m == rank % n_model:
            data_group = g
    for g in (model_group, data_group):
        dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, device=dev, data_group=data_group,
                model_group=model_group)
