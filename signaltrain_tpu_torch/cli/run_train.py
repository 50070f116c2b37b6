"""Training CLI: the flag surface of the JAX package's cli/run_train.py.

Examples:
    python -m signaltrain_tpu_torch.cli.run_train --epochs 10 -n 2000 -b 100 --effect comp_4c
    python -m signaltrain_tpu_torch.cli.run_train --path mydata -e files [-t chunk] [--compand]
    python -m signaltrain_tpu_torch.cli.run_train --model tcn -b 32 --epochs 10 -n 3200

``--model tcn`` trains TCN-300-C (``models/tcn.py``) in place of the spectral
model, at the sizes ``--n-blocks``, ``--kernel-size``, ``--dilation-growth``,
``--channels``, ``--causal`` / ``--no-causal`` and ``--out-chunk-size`` give
(TCN-300-C's by default; ``--scale`` and ``--shrink`` do not apply), in
float32, its only dtype, on one process.

Runs on the CUDA card unless ``--device cpu`` is given, the spectral model
in bfloat16 unless ``--dtype float32`` is given (the JAX CLI's default), through
``config.RunConfig`` and ``train_from_config``. ``--effect`` takes every
effect of the JAX package; ``files`` reads the knob metadata of the dataset
at ``--path``, which then holds ``Train/`` and ``Val/`` (any other effect
with ``--path`` trains on that dataset with the effect's knob ranges, and
with ``-t chunk`` re-runs it on each cropped input). The effect, the target
type and the dataset's input files are checked as the JAX CLI checks them,
and ``-t chunk`` with ``-e files`` is refused (a file effect has no signal
to re-run);
``--apex`` is accepted and ignored, as there. ``--profile DIR`` runs the
training inside ``utils/profiling.trace(DIR)`` (a ``torch.profiler`` trace
with the card's kernels, for TensorBoard or Perfetto).

Data parallelism: ``--nproc N`` spawns N ranks (``parallel/launch.py``), on
the cards ``cuda:0 .. N-1`` under NCCL, or N CPU processes under gloo with
``--device cpu``; each runs ``train_from_config`` on its shard of every
batch of ``-b`` examples, and only rank 0 prints and writes. Started by
torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set), this process joins that world as its rank instead, on
``cuda:LOCAL_RANK``. Without either it trains in this one process on
``--device``: unlike the JAX ``train()``, which takes every local device,
the port takes one card unless told otherwise.

Tensor parallelism: ``--nmodel M`` splits the front-end's matrices over M
ranks of each data index (the JAX ``"model"`` axis, ``parallel/mesh.py``):
the world (``--nproc``, or torchrun's) must be ``n_data x M`` ranks, e.g.
``--nproc 4 --nmodel 2`` for 2 x 2, on the cards under NCCL or on gloo
ranks (``--device cpu``). Its steps are dispatched op by op
(``cli.time_data_parallel --nmodel`` checks them against the single-process
oracle on the cards).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    from ..models.kinds import MODEL_KINDS
    from ..models.tcn import TCNSpec

    parser = argparse.ArgumentParser(
        description="Trains neural network to reproduce input-output transformations.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--apex", help="(compat) ignored; use --dtype", default="O0")
    parser.add_argument("-b", "--batch", type=int, help="batch size", default=200)
    parser.add_argument("--checkpoint", help="Name of model checkpoint .tar file",
                        default="modelcheckpoint.tar")
    parser.add_argument("-c", "--compand", action="store_true",
                        help="Turn on to use companded/decompanded audio")
    parser.add_argument("-e", "--effect", help='Name of effect to use. ("files" = search for '
                        '"target_" and effect_info.ini files in path)', default="comp_4c")
    parser.add_argument("--epochs", type=int, help="Number of epochs to run", default=1000)
    parser.add_argument("--lrmax", type=float, help="max learning rate", default=1e-4)
    parser.add_argument("-n", "--num", type=int,
                        help='Number of "data points" (audio clips) per epoch', default=200000)
    parser.add_argument("--path", default=None,
                        help="Directory to pull input (and maybe target) data from "
                        "(default: None, means only synthesized-on-the-fly data)")
    parser.add_argument("--sr", type=int, help="Sampling rate", default=44100)
    parser.add_argument("--scale", type=float,
                        help="Scale factor (of input size & whole model)", default=1.0)
    parser.add_argument("--shrink", type=int,
                        help="Shink output chunk relative to input by this divisor", default=4)
    parser.add_argument("-t", "--target", help="type of target: chunk or stream (with "
                        "--path)", default="stream")
    parser.add_argument("--dtype", default=None,
                        help="compute dtype: bfloat16 (bf16) or float32 (f32); default bfloat16, "
                        "float32 for --model tcn")
    parser.add_argument("--model", default="mpaec", choices=MODEL_KINDS,
                        help="mpaec: the spectral autoencoder; tcn: TCN-300-C")
    tcn = TCNSpec()
    parser.add_argument("--n-blocks", dest="n_blocks", type=int, default=tcn.n_blocks,
                        help="TCN: blocks")
    parser.add_argument("--kernel-size", dest="kernel_size", type=int, default=tcn.kernel_size,
                        help="TCN: taps of each dilated convolution")
    parser.add_argument("--dilation-growth", dest="dilation_growth", type=int,
                        default=tcn.dilation_growth, help="TCN: block i's dilation is this**i")
    parser.add_argument("--channels", type=int, default=tcn.channels, help="TCN: channels")
    parser.add_argument("--causal", action=argparse.BooleanOptionalAction, default=tcn.causal,
                        help="TCN: crop the residual to its last samples (else its centre)")
    parser.add_argument("--out-chunk-size", dest="out_chunk_size", type=int,
                        default=tcn.out_chunk_size,
                        help="TCN: output samples a training example (its input is longer by "
                        "the receptive field less one)")
    parser.add_argument("--nmodel", type=int, default=1,
                        help="model-axis size: ranks that split the front-end's matrices "
                        "(the world, --nproc or torchrun's, is n_data x nmodel)")
    parser.add_argument("--seed", type=int, default=218)
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the run into DIR")
    parser.add_argument("--out-checkpoint", default=None, metavar="FILE",
                        help="where to save checkpoints (default: same as --checkpoint)")
    parser.add_argument("--cp-every", type=int, default=25, help="epochs between checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    parser.add_argument("--nproc", type=int, default=1,
                        help="data-parallel ranks to spawn, one a card (CPU processes with "
                        "--device cpu)")
    return parser


TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def torchrun_rank(env) -> dict | None:
    """The world a torchrun launch put in ``env`` (``TORCHRUN_VARS``), as
    ``distributed.initialize``'s arguments but the backend and device; None
    when they are not all set. The store is ``env://``: torchrun's agent
    already serves it at MASTER_ADDR:MASTER_PORT, and ``env://`` joins it
    as a client where a ``tcp://`` rank 0 would try to serve it again."""
    if not all(k in env for k in TORCHRUN_VARS):
        return None
    return dict(init_method="env://", world_size=int(env["WORLD_SIZE"]), rank=int(env["RANK"]),
                local_rank=int(env["LOCAL_RANK"]))


def main(argv=None) -> None:
    from ..config import DTYPES

    args = build_parser().parse_args(argv)
    print("Command line: ", " ".join(sys.argv[:]))
    if args.dtype is not None and args.dtype not in DTYPES:
        print(f"Error: --dtype {args.dtype}: expected one of {', '.join(DTYPES)}")
        sys.exit(1)

    import torch

    from ..config import RunConfig, train_from_config
    from ..dsp import effects
    from ..models import kinds
    from ..parallel import distributed, launch
    from ..utils import profiling

    world = torchrun_rank(os.environ)
    if args.nproc > 1 and (world is not None or args.profile):
        print("Error: --nproc spawns its own ranks: not under torchrun, and not with "
              "--profile (which traces this process)")
        sys.exit(1)
    ranks = world["world_size"] if world is not None else args.nproc
    try:
        kinds.check_split(args.model, ranks=ranks)
    except ValueError as e:
        print(f"Error: --model {args.model}: {e}: no --nproc, no torchrun")
        sys.exit(1)
    if args.nmodel < 1 or ranks % args.nmodel:
        print(f"Error: --nmodel {args.nmodel}: a world of {ranks} ranks is not n_data x "
              f"{args.nmodel}; run n_data x nmodel ranks (--nproc, or torchrun's)")
        sys.exit(1)
    device = args.device
    if world is not None and torch.device(device).type == "cuda":
        device = f"cuda:{world['local_rank']}"
    try:  # with --nproc the ranks build their own; this one only checks the arguments
        effect = effects.make_effect(args.effect, path=args.path, sr=args.sr,
                                     device="cpu" if args.nproc > 1 else device)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(f"Error: {e}")
        sys.exit(1)
    if args.target not in ["chunk", "stream"]:
        print(f"Error, invalid target type: {args.target}")
        sys.exit(1)
    if args.effect == "files" and args.target == "chunk":
        print("Error: -t chunk re-runs the effect on each input chunk, and a file dataset's "
              "effect (-e files) has no signal path; name the effect (e.g. --effect comp_4c)")
        sys.exit(1)
    if args.effect == "files" and (
        not glob.glob(args.path + "/Train/input*") or not glob.glob(args.path + "/Val/input*")
    ):
        print(f"Error: no input files under {args.path}/Train and {args.path}/Val")
        sys.exit(1)
    print("Running with args =", args)
    cfg = RunConfig.from_args(args).replace(device=device)
    if cfg.nproc > 1:
        devices = launch.rank_devices(cfg.device, cfg.nproc)
        launch.spawn(launch.train_rank, devices, launch.backend_for(cfg.device), args=(cfg,),
                     timeout_s=None, n_model=cfg.n_model)
        print("run_train: Execution completed.")
        return
    if world is not None:
        distributed.initialize(world["init_method"], world["world_size"], world["rank"],
                               launch.backend_for(device), device)
    cuda = torch.device(cfg.device).type == "cuda"
    ctx = profiling.trace(args.profile, cuda=cuda) if args.profile else contextlib.nullcontext()
    primary = distributed.is_primary()
    try:
        with ctx:
            train_from_config(cfg, effect=effect)
    finally:
        distributed.shutdown()
    if primary:
        print("run_train: Execution completed.")


if __name__ == "__main__":
    main()
