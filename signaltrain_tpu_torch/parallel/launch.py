"""Start a data-parallel run: one spawned process a rank.

``spawn(fn, devices, backend, args, n_model=1)`` starts ``len(devices)``
processes (``multiprocessing``'s spawn method), rank r on ``devices[r]``;
each joins a process group through a ``file://`` store in a temporary
directory (``distributed.initialize``), calls ``fn(mesh, *args)`` with its
``mesh.make_mesh(n_model=n_model)``, leaves the group and sends back what ``fn`` returned,
tensors as numpy arrays. ``fn`` is pickled by name: a module-level function.
``fn`` and ``args`` go to the ranks through a file in that directory, not
through the start of each process: the parent writes a process's start-up
data into a pipe that the child reads as it unpickles, importing torch on
the way, so a large argument would make each start wait for the last
child's imports.
A rank on the CPU runs one intra-op thread, as torchrun sets it, so that the
ranks do not share out the cores many times over.
The parent builds the CUDA kernels once before it spawns, so that the ranks
load them from ``build/kernels/`` and none compiles. It returns the ranks'
results in rank order, or raises with the first failing rank's traceback,
after stopping every rank; a run that outlasts ``timeout_s`` (None: no
limit) is stopped and raises too.

``train_rank`` is ``cli.run_train --nproc``'s target: ``train_from_config``
on the rank's device (``train()`` builds its own mesh, of ``cfg.n_model``).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch

from . import distributed
from .mesh import make_mesh


def backend_for(device: str | torch.device) -> str:
    """The production backend of a device: NCCL on CUDA, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_devices(device: str | torch.device, nproc: int) -> list[str]:
    """One device a rank: the CPU for every rank, or CUDA cards index,
    index + 1, ... from ``device``'s index (0 when it names none)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [str(dev)] * nproc
    first = dev.index or 0
    if first + nproc > torch.cuda.device_count():
        raise RuntimeError(f"{nproc} ranks from cuda:{first} need {first + nproc} cards; "
                           f"this machine has {torch.cuda.device_count()}")
    return [f"cuda:{first + r}" for r in range(nproc)]


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _rank_main(rank: int, world: int, init_method: str, backend: str, device: str,
               n_model: int, payload: str, results) -> None:
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = distributed.initialize(init_method, world, rank, backend, device)
        try:
            value = _to_host(fn(make_mesh(n_model=n_model, device=dev), *args))
        finally:
            distributed.shutdown()
        results.put((rank, None, value))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise SystemExit(1)


def spawn(fn, devices: list, backend: str, args: tuple = (),
          timeout_s: float | None = 600.0, n_model: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on ranks 0 .. len(devices) - 1 of an
    ``n_data x n_model`` mesh (module docstring); their results in rank
    order."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops import _cuda

        _cuda.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    world = len(devices)
    out = {}
    with tempfile.TemporaryDirectory() as store:
        init_method = "file://" + os.path.join(store, "store")
        payload = os.path.join(store, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init_method, backend, str(devices[r]), n_model,
                                   payload, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s

        def left() -> float:
            return 1.0 if deadline is None else max(0.0, deadline - time.monotonic())

        try:
            while len(out) < world:
                if left() <= 0:
                    raise TimeoutError(f"spawn: {world - len(out)} of {world} ranks still running "
                                       f"after {timeout_s:.0f} s")
                try:
                    rank, error, value = results.get(timeout=min(left(), 1.0))
                except queue.Empty:
                    silent = [r for r, p in enumerate(procs) if r not in out
                              and p.exitcode not in (None, 0)]
                    if silent:  # killed before it could report
                        raise RuntimeError(f"spawn: rank {silent[0]} exited with code "
                                           f"{procs[silent[0]].exitcode} and no result")
                    continue
                if error is not None:
                    raise RuntimeError(f"spawn: rank {rank} of {world} failed:\n{error}")
                out[rank] = value
            for r, p in enumerate(procs):
                p.join(None if deadline is None else left())
                if p.exitcode != 0:
                    raise RuntimeError(f"spawn: rank {r} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world)]


def train_rank(mesh, cfg) -> None:
    """One rank of ``cli.run_train --nproc``: ``train_from_config`` on the
    rank's device."""
    from ..config import train_from_config

    train_from_config(cfg.replace(device=str(mesh.device)))
