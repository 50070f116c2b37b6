"""Check and time data-parallel training on several NVIDIA GPUs under NCCL.

Run from the root of a checkout on a machine with N CUDA cards and nvcc:

    python -m signaltrain_tpu_torch.cli.time_data_parallel --nproc 4

It builds the kernels, then spawns N ranks on cuda:0 .. N-1
(``parallel/launch.spawn``, NCCL), each running the train step as ``train()``
runs it inside a process group: ``graphs.TrainGraph`` with ``mesh=``, two
CUDA graphs around the all-reduce of the gradient bucket, comp_4c data
synthesized on the rank's card from its shard's stream, the flagship
geometry, seeded weights, ``BATCH`` rows a rank.

* The check, in float32: ``CHECK_STEPS`` steps of the ranks against
  ``training/oracle.oracle_steps`` run in this process on cuda:0 at the
  global batch, every weight within ``oracle.ATOL`` / ``oracle.RTOL``
  (``oracle.excess`` at most 1) and the losses within rtol 1e-5; with two
  ranks or more, the oracle's sum-not-mean control must land more than
  ``CONTROL_GAP`` times over that limit (at one rank the sum is the mean).
* The timing, in bfloat16 (train()'s default): ``BLOCKS`` blocks of 20
  replays with one fetch of the losses after each, ms a step by the host
  clock, at world N, beside one card alone at ``BATCH`` (the single graph of
  train() without a process group, in this process on cuda:0, after the
  ranks have ended): examples/s and the scaling efficiency, one card's ms a
  step over the N ranks'.

The cards' names and power limits head the output; the last line is one
JSON object. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..data import synth_data
from ..dsp import effects
from ..models.st_model import st_model
from ..parallel import launch
from ..training import graphs, oracle
from ..training import train as train_mod

SEED = 218
LR = (2e-4, 4000, 3)  # lr_max, n_data_points, epochs of chip_smoke.py's training runs
BATCH, CHECK_STEPS, BLOCKS, BLOCK = 200, 3, 3, 20
CONTROL_GAP = 10.0


def _setup(dev, dtype, global_batch: int):
    """Seeded model, capturable Adam and the comp_4c batch function on dev."""
    effect = effects.make_effect("comp_4c", device=dev)
    model = st_model(device=dev, generator=torch.Generator().manual_seed(SEED),
                     compute_dtype=dtype).train()
    opt, lr_fn = train_mod.make_optimizer(model, LR[0], LR[1], LR[2], global_batch)
    return model, opt, lr_fn, synth_data.make_synth_batch_fn(effect, 8192, 2048)


def _block_ms(graph) -> list[float]:
    """The graph's first step (its capture), then ms a step of each block."""
    graph(0, 1)
    out = []
    for b in range(BLOCKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph(1 + b * BLOCK, BLOCK).cpu()
        out.append((time.perf_counter() - t0) * 1e3 / BLOCK)
    return out


def _graph(mesh, dtype, global_batch: int):
    model, opt, lr_fn, batch_fn = _setup(mesh.device, dtype, global_batch)
    return model, graphs.TrainGraph(model, opt, lr_fn, batch_fn, global_batch,
                                    torch.Generator(device=mesh.device), SEED, BLOCK, mesh=mesh)


def _rank(mesh) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global_batch = mesh.n_data * BATCH
    model, g = _graph(mesh, torch.float32, global_batch)
    losses = g(0, CHECK_STEPS)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    _, g = _graph(mesh, torch.bfloat16, global_batch)
    return {"losses": losses, "weights": weights, "ms": _block_ms(g),
            "memory_gb": torch.cuda.max_memory_allocated(mesh.device) / 1e9}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=torch.cuda.device_count())
    n = parser.parse_args(argv).nproc
    if not torch.cuda.is_available():
        sys.exit("time_data_parallel: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ranks = launch.spawn(_rank, launch.rank_devices("cuda", n), "nccl", timeout_s=900)
    spawn_s = time.perf_counter() - t0

    dev = torch.device("cuda", 0)

    def run_oracle(reduce: str):
        model, opt, lr_fn, batch_fn = _setup(dev, torch.float32, n * BATCH)
        losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, n * BATCH, n,
                                     torch.Generator(device=dev), SEED, 0, CHECK_STEPS,
                                     reduce=reduce)
        return losses.cpu(), {k: v.detach() for k, v in model.state_dict().items()}

    o_losses, want = run_oracle("mean")
    control = oracle.excess(run_oracle("sum")[1], want)
    excess = [oracle.excess(r["weights"], want) for r in ranks]
    loss_err = max(float((torch.as_tensor(r["losses"]) / o_losses - 1).abs().max()) for r in ranks)

    single, sopt, s_lr_fn, s_batch_fn = _setup(dev, torch.bfloat16, BATCH)
    one = _block_ms(graphs.TrainGraph(single, sopt, s_lr_fn, s_batch_fn, BATCH,
                                      torch.Generator(device=dev), SEED, BLOCK))
    ms_n = [min(r["ms"]) for r in ranks]
    report = {
        "cards": smi.splitlines(), "nproc": n, "batch_a_rank": BATCH, "dtype": "bfloat16",
        "check": {"excess": excess, "max_param_delta": max(
            oracle.max_param_delta(r["weights"], want) for r in ranks),
            "loss_rel_err": loss_err, "control_excess": control},
        "ms_a_step": {"ranks": [r["ms"] for r in ranks], "one_card": one},
        "examples_per_s": {"ranks": n * BATCH / max(ms_n) * 1e3,
                           "one_card": BATCH / min(one) * 1e3},
        "scaling_efficiency": min(one) / max(ms_n),
        "memory_gb": [r["memory_gb"] for r in ranks], "spawn_s": spawn_s}
    print(json.dumps(report))
    ok = max(excess) <= 1.0 and loss_err <= 1e-5 and (n == 1 or control > CONTROL_GAP)
    if not ok:
        sys.exit(f"time_data_parallel: the check failed: {max(excess):.3f} x the limit, losses "
                 f"{loss_err:.3e}, control {control:.2f} x")


if __name__ == "__main__":
    main()
