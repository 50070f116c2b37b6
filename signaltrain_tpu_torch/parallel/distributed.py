"""The process group of a data-parallel run: one process a rank.

Counterpart of signaltrain_tpu/parallel/distributed.py. Where the JAX
package's ``initialize`` lets ``jax.distributed`` find the pod's coordinator,
this one takes every argument explicitly and reads no environment: the
launcher (``parallel/launch.py``, or ``cli.run_train`` under torchrun) says
where the store is, how many ranks there are, which one this is, the backend
and the device.

The backend is named, never guessed: ``"nccl"`` on CUDA devices is the
production path; ``"gloo"`` runs on the CPU (the tests) and on CUDA tensors
(the one-card check of two ranks). A CUDA rank asked for NCCL on a build
without it raises. Every collective is bounded by the group's timeout (60 s
unless given), so a rank that dies fails the run instead of hanging it.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 60.0


def initialize(init_method: str, world_size: int, rank: int, backend: str,
               device: str | torch.device, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group at ``init_method`` (``tcp://host:port`` or
    ``file://path``) as ``rank`` of ``world_size`` over ``backend``, bound to
    ``device``; returns the device. One all-reduce follows on the device, so
    that NCCL builds its communicator here and not inside a later step."""
    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL; pass backend='gloo'")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} is outside a world of {world_size}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != world_size:
        raise RuntimeError(f"the first all-reduce gave {probe.item()}, not the world {world_size}")
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of ranks; 1 outside a process group."""
    return dist.get_world_size() if is_initialized() else 1


def backend() -> str | None:
    """The world's backend ("nccl" or "gloo"), or None outside a process group."""
    return str(dist.get_backend()) if is_initialized() else None


def is_primary() -> bool:
    """True on the process that writes logs, plots and checkpoints."""
    return rank() == 0


def group():
    """The world's process group, or None outside one."""
    return dist.group.WORLD if is_initialized() else None


def shutdown() -> None:
    """Leave the process group (nothing outside one)."""
    if is_initialized():
        dist.destroy_process_group()
