"""Check and time data-parallel and tensor-parallel training on several
NVIDIA GPUs under NCCL.

Run from the root of a checkout on a machine with N CUDA cards and nvcc:

    python -m signaltrain_tpu_torch.cli.time_data_parallel --nproc 4 [--nmodel 2]

It builds the kernels, then spawns N ranks on cuda:0 .. N-1
(``parallel/launch.spawn``, NCCL) on an ``n_data x n_model`` mesh
(``n_data = N // nmodel``), each running the train step as ``train()`` runs
it inside a process group: ``graphs.TrainGraph`` with ``mesh=``, two CUDA
graphs around the all-reduce of the gradient bucket over the data group,
comp_4c data synthesized on the rank's card from its data index's stream,
the flagship geometry, seeded weights, ``BATCH`` rows a data index. With
``--nmodel`` above 1 the front-end's rows are split over the model group
(the gemm front-end), and the steps run op by op
(``Mesh.captures_collectives``), as ``train(n_model=)`` runs them under
NCCL.

* The check, in float32: ``CHECK_STEPS`` steps of the ranks against
  ``training/oracle.oracle_steps`` run in this process on cuda:0 at
  ``n_data`` shards of the global batch: the weights and Adam's moments
  (gathered whole) within ``oracle.ATOL`` / ``oracle.RTOL``
  (``oracle.state_excess`` at most 1) and the losses within rtol 1e-5; with
  two data ranks or more, the oracle's sum-not-mean control must land more
  than ``CONTROL_GAP`` times over that limit (at one the sum is the mean).
  With ``--nmodel`` above 1 the replicated weights must be bit-equal across
  the model ranks, and the two scale controls (``tensor.scale_control``)
  must fail the check.
* The timing, in bfloat16 (train()'s default): ``BLOCKS`` blocks of 20
  replays with one fetch of the losses after each, ms a step by the host
  clock, at world N, beside one card alone at ``BATCH`` (the single graph of
  train() without a process group, in this process on cuda:0, after the
  ranks have ended): examples/s and the scaling efficiency, one card's ms a
  step over the N ranks'. With ``--nmodel`` the bytes of the model group's
  collectives a step (each rank's payload, from the shapes) are reported,
  and the split analysis' full-width product is timed beside a product of
  one rank's bins alone (``analysis_product_ms``).

The ranks run with NCCL's flight recorder on (``flight_recorder``): each
keeps its last collectives, and a rank whose collective outlasts its group's
timeout (``distributed.TIMEOUT_S``) writes them to ``--flight-dir`` before
it fails; the tool then prints each dump's last collectives
(``flight_summary``). ``--timeout`` bounds the whole spawn (900 s by
default; 300 s is ample for four cards).

The cards' names and power limits head the output; the last line is one
JSON object. Exits non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import torch

from ..data import synth_data
from ..dsp import effects
from ..models.st_model import STModel, compute_spec
from ..parallel import launch
from ..parallel import tensor as tp
from ..training import checkpoint, graphs, oracle
from ..training import train as train_mod

SEED = 218
LR = (2e-4, 4000, 3)  # lr_max, n_data_points, epochs of chip_smoke.py's training runs
BATCH, CHECK_STEPS, BLOCKS, BLOCK = 200, 3, 3, 20
CONTROL_GAP = 10.0


def _setup(dev, dtype, global_batch: int, mesh=None, frontend: str = "auto"):
    """Seeded model (on ``mesh``'s model group when it splits the front-end),
    capturable Adam and the comp_4c batch function on dev."""
    effect = effects.make_effect("comp_4c", device=dev)
    model = STModel(compute_spec(), frontend=frontend, device=dev, compute_dtype=dtype,
                    generator=torch.Generator().manual_seed(SEED),
                    mesh=mesh if mesh is not None and mesh.n_model > 1 else None).train()
    opt, lr_fn = train_mod.make_optimizer(model, LR[0], LR[1], LR[2], global_batch)
    return model, opt, lr_fn, synth_data.make_synth_batch_fn(effect, 8192, 2048)


def _block_ms(graph) -> list[float]:
    """The first step (a graph's capture), then ms a step of each block."""
    graph(0, 1)
    out = []
    for b in range(BLOCKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph(1 + b * BLOCK, BLOCK).cpu()
        out.append((time.perf_counter() - t0) * 1e3 / BLOCK)
    return out


def _graph(mesh, dtype, global_batch: int):
    """(model, optimizer, steps): ``steps(step0, n)`` runs train()'s steps on
    the mesh, two CUDA graphs around the all-reduce where a graph may hold
    the model group's collectives (``Mesh.captures_collectives``), else op
    by op (``train.eager_steps``)."""
    model, opt, lr_fn, batch_fn = _setup(mesh.device, dtype, global_batch, mesh)
    gen = torch.Generator(device=mesh.device)
    if model.mpaec.mesh is None or mesh.captures_collectives():
        return model, opt, graphs.TrainGraph(model, opt, lr_fn, batch_fn, global_batch, gen,
                                             SEED, BLOCK, mesh=mesh)
    return model, opt, functools.partial(train_mod.eager_steps, model, opt, lr_fn, batch_fn,
                                         global_batch, gen, SEED, mesh=mesh)


def payload_bytes(model, local_batch: int) -> dict:
    """The bytes each collective of the model group takes a step on one rank
    (its tensor's size; 0 without a split front-end): the analysis' gather
    (its output, re and im), the partial waveforms' sum, the synthesis
    input's backward sum, the clip's total."""
    an = model.mpaec.dft_analysis
    if an.shard is None:
        return {}
    spec, shard = model.spec, an.shard
    width = max(hi - lo for lo, hi in (shard.bins(m) for m in range(shard.n_model)))
    return {"gather_bins": 2 * 4 * local_batch * spec.time_frames * shard.n_model * width,
            "sum_partials": 4 * local_batch * spec.out_chunk_size,
            "enter_shard_backward": 2 * 4 * local_batch * spec.output_time_frames * shard.half,
            "clip_total": 4}


def analysis_product_ms(model, n_model: int) -> dict:
    """What the split analysis' full-width product costs (``ops/frontend.py``):
    the product of a step's frames (BATCH rows) against the whole (ft, 2 *
    half) operand, against only one rank's bins' columns (its share of
    ``n_model``), in bfloat16 and float32, CUDA-event ms of one product."""
    from ..ops import framing
    from ..ops.frontend import gemm

    an = model.mpaec.dft_analysis
    dev = an.conv_analysis_real.weight.device
    x = torch.randn(BATCH, model.spec.in_chunk_size, device=dev)
    frames = framing.frame_signal(x, an.ft_size, an.hop_size, pad=an.ft_size)
    full = an.stacked_weights().detach()
    n = -(-an.half // n_model)
    own = torch.cat([full[:, :n], full[:, an.half : an.half + n]], dim=1).contiguous()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, w in (("full_width", full), ("own_bins", own)):
            for _ in range(3):
                gemm(frames, w, dtype)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                gemm(frames, w, dtype)
            end.record()
            end.synchronize()
            out[f"{str(dtype).removeprefix('torch.')}_{name}"] = start.elapsed_time(end) / 20
    return out


FLIGHT_ENTRIES = 2000


def flight_recorder(directory: str) -> str:
    """Turn NCCL's flight recorder on for ranks spawned from now on (their
    environment is this process's): ``FLIGHT_ENTRIES`` collectives kept a
    rank, dumped to ``directory/rank_<r>`` when a collective times out.
    Both of PyTorch's names for each setting are set. Returns the dump
    files' prefix."""
    os.makedirs(directory, exist_ok=True)
    prefix = os.path.join(os.path.abspath(directory), "rank_")
    for names, value in ((("TORCH_NCCL_TRACE_BUFFER_SIZE", "TORCH_FR_BUFFER_SIZE"),
                          str(FLIGHT_ENTRIES)),
                         (("TORCH_NCCL_DUMP_ON_TIMEOUT", "TORCH_FR_DUMP_ON_TIMEOUT"), "1"),
                         (("TORCH_NCCL_DEBUG_INFO_TEMP_FILE", "TORCH_FR_DUMP_TEMP_FILE"), prefix)):
        for name in names:
            os.environ[name] = value
    return prefix


def flight_summary(prefix: str, last: int = 8) -> str:
    """Each dump under ``prefix``: its rank's last ``last`` collectives, one
    line each (process group, sequence number, name, sizes, state), or a line
    saying that no rank wrote one."""
    lines = []
    for path in sorted(glob.glob(prefix + "*")):
        try:
            with open(path, "rb") as f:
                dump = pickle.load(f)
        except Exception as e:  # a dump cut short says so and the rest still print
            lines.append(f"{path}: unreadable ({e!r})")
            continue
        entries = dump.get("entries", [])
        lines.append(f"{os.path.basename(path)}: {len(entries)} collectives recorded")
        for e in entries[-last:]:
            lines.append("  pg {} seq {} {} in {} out {} {}".format(
                e.get("process_group", e.get("pg_id")), e.get("collective_seq_id"),
                e.get("profiling_name"), e.get("input_sizes"), e.get("output_sizes"),
                e.get("state")))
    return "\n".join(lines) or f"no flight recorder dump under {prefix}*"


def _checked(mesh, global_batch: int) -> dict:
    """CHECK_STEPS float32 steps: the losses, the replicated weights, and on
    rank 0 the whole state (every rank gathers the same)."""
    model, opt, g = _graph(mesh, torch.float32, global_batch)
    losses = g(0, CHECK_STEPS)
    state = checkpoint.training_tensors(model, opt)
    replicated = {k: v.detach().clone() for k, v in model.named_parameters() if "dft_" not in k}
    return {"losses": losses, "state": state if mesh.rank == 0 else None,
            "replicated": replicated}


def _rank(mesh) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global_batch = mesh.n_data * BATCH
    out = _checked(mesh, global_batch)
    out["controls"] = {}
    if mesh.n_model > 1:
        for name in tp.SCALE_CONTROLS:
            with tp.scale_control(name):
                out["controls"][name] = _checked(mesh, global_batch)["state"]
    torch.cuda.reset_peak_memory_stats(mesh.device)
    model, _, g = _graph(mesh, torch.bfloat16, global_batch)
    out.update(ms=_block_ms(g), memory_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9,
               payload_bytes=payload_bytes(model, BATCH))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=torch.cuda.device_count())
    parser.add_argument("--nmodel", type=int, default=1,
                        help="ranks of a data index that split the front-end's rows")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="seconds the ranks may run before they are stopped")
    parser.add_argument("--flight-dir", default=None,
                        help="where a rank whose collective times out dumps NCCL's flight "
                             "recorder (a new temporary directory when not given)")
    args = parser.parse_args(argv)
    n, n_model = args.nproc, args.nmodel
    if not torch.cuda.is_available():
        sys.exit("time_data_parallel: no CUDA card")
    if n_model < 1 or n % n_model:
        sys.exit(f"time_data_parallel: --nproc {n} is not n_data x --nmodel {n_model}")
    n_data = n // n_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix = flight_recorder(args.flight_dir or tempfile.mkdtemp(prefix="nccl_flight_"))
    t0 = time.perf_counter()
    try:
        ranks = launch.spawn(_rank, launch.rank_devices("cuda", n), "nccl",
                             timeout_s=args.timeout, n_model=n_model)
    except (RuntimeError, TimeoutError):
        print(f"time_data_parallel: the ranks failed after {time.perf_counter() - t0:.1f} s; "
              f"NCCL's flight recorder:\n{flight_summary(prefix)}", flush=True)
        raise
    spawn_s = time.perf_counter() - t0

    dev = torch.device("cuda", 0)

    def run_oracle(reduce: str):  # on the ranks' front-end: the gemm one when split
        model, opt, lr_fn, batch_fn = _setup(dev, torch.float32, n_data * BATCH,
                                             frontend="gemm" if n_model > 1 else "fused")
        losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, n_data * BATCH, n_data,
                                     torch.Generator(device=dev), SEED, 0, CHECK_STEPS,
                                     reduce=reduce)
        return losses.cpu(), checkpoint.training_tensors(model, opt)

    o_losses, want = run_oracle("mean")
    control = oracle.state_excess(run_oracle("sum")[1], want)
    excess = oracle.state_excess(ranks[0]["state"], want)
    loss_err = max(float((torch.as_tensor(r["losses"]) / o_losses - 1).abs().max()) for r in ranks)
    scale_controls = {name: oracle.state_excess(st, want)
                      for name, st in ranks[0]["controls"].items()}
    replicated_equal = all(
        all(torch.equal(torch.as_tensor(v), torch.as_tensor(ranks[0]["replicated"][k]))
            for k, v in r["replicated"].items()) for r in ranks)

    single, sopt, s_lr_fn, s_batch_fn = _setup(dev, torch.bfloat16, BATCH)
    one = _block_ms(graphs.TrainGraph(single, sopt, s_lr_fn, s_batch_fn, BATCH,
                                      torch.Generator(device=dev), SEED, BLOCK))
    analysis_ms = analysis_product_ms(single, n_model) if n_model > 1 else None
    ms_n = [min(r["ms"]) for r in ranks]
    report = {
        "cards": smi.splitlines(), "nproc": n, "n_data": n_data, "n_model": n_model,
        "batch_a_data_rank": BATCH, "dtype": "bfloat16",
        "check": {"excess": excess, "max_param_delta": oracle.max_param_delta(
            ranks[0]["state"]["state_dict"], want["state_dict"]),
            "loss_rel_err": loss_err, "control_excess": control,
            "scale_control_excess": scale_controls, "replicated_bit_equal": replicated_equal},
        "ms_a_step": {"ranks": [r["ms"] for r in ranks], "one_card": one},
        "examples_per_s": {"ranks": n_data * BATCH / max(ms_n) * 1e3,
                           "one_card": BATCH / min(one) * 1e3},
        "scaling_efficiency": min(one) / max(ms_n),
        "model_group_payload_bytes_a_step": ranks[0]["payload_bytes"],
        "analysis_product_ms": analysis_ms,
        "memory_gb": [r["memory_gb"] for r in ranks], "spawn_s": spawn_s}
    print(json.dumps(report))
    ok = (excess <= 1.0 and loss_err <= 1e-5 and (n_data == 1 or control > CONTROL_GAP)
          and replicated_equal and all(v > 1.0 for v in scale_controls.values()))
    if not ok:
        sys.exit(f"time_data_parallel: the check failed: {excess:.3f} x the limit, losses "
                 f"{loss_err:.3e}, control {control:.2f} x, scale controls {scale_controls}, "
                 f"replicated weights bit-equal: {replicated_equal}")


if __name__ == "__main__":
    main()
