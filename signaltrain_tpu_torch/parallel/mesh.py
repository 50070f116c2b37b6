"""The data mesh: which rows of a global batch this rank owns, and the
collectives over the ranks.

Counterpart of signaltrain_tpu/parallel/mesh.py (``make_mesh``, ``:28``).
The JAX mesh is ``("data", "model")`` over every visible device; here each
rank is one process on one device (``parallel/distributed.py``), and the
``"data"`` axis is the world of the process group. Each rank synthesizes its
own rows of the global batch, the gradients and the loss are all-reduced and
divided by ``n_data`` (the JAX ``pmean``), and the weights stay replicated.
The ``"model"`` axis (tensor parallelism of the front-end matrices) is not
ported: ``n_model`` must be 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_data`` ranks of data parallelism, this one ``rank`` on ``device``."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device

    def local_batch(self, batch: int) -> int:
        """The rows of a global batch of ``batch`` that each rank takes."""
        if batch % self.n_data:
            raise ValueError(f"batch_size {batch} must divide over the mesh's {self.n_data} "
                             "'data' ranks; pass a batch size that the world divides")
        return batch // self.n_data

    def local_rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a global batch of ``batch``."""
        n = self.local_batch(batch)
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (nothing outside a process
        group); returns ``t``."""
        if distributed.is_initialized():
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks and divided by ``n_data``, in place
        (the JAX ``lax.pmean``: gloo has no average, and dividing by 1 is
        exact)."""
        return self.all_reduce(t).div_(self.n_data)

    @torch.no_grad()
    def broadcast(self, tensors, src: int = 0) -> None:
        """Overwrite each tensor (parameters too) with rank ``src``'s, in place."""
        if distributed.is_initialized():
            for t in tensors:
                dist.broadcast(t, src)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh over the process group's world (world 1 when no group was
    initialized), this rank on ``device``. ``n_data``, when given, must be
    the world's size."""
    if n_model != 1:
        raise NotImplementedError("tensor parallelism (the 'model' axis) is not ported yet")
    world = distributed.world_size()
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data {n_data}: the process group has {world} ranks, one per shard")
    return Mesh(n_data=world, n_model=1, rank=distributed.rank(), device=resolve_device(device))
