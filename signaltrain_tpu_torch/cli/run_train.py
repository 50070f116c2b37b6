"""Training CLI: the flag surface of the JAX package's cli/run_train.py, as
far as the port reaches.

Example:
    python -m signaltrain_tpu_torch.cli.run_train --epochs 10 -n 2000 -b 100 --effect comp_4c

Runs on the CUDA card unless ``--device cpu`` is given. Options that belong
to parts not ported yet (file datasets, companding, bf16, model parallelism,
profiling) exit with a message that says so.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Trains neural network to reproduce input-output transformations.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-b", "--batch", type=int, help="batch size", default=200)
    parser.add_argument("--checkpoint", help="Name of model checkpoint .tar file",
                        default="modelcheckpoint.tar")
    parser.add_argument("-c", "--compand", action="store_true",
                        help="companded audio (file datasets; not ported yet)")
    parser.add_argument("--effect", help="Name of effect to use", default="comp_4c")
    parser.add_argument("--epochs", type=int, help="Number of epochs to run", default=1000)
    parser.add_argument("--lrmax", type=float, help="max learning rate", default=1e-4)
    parser.add_argument("-n", "--num", type=int,
                        help='Number of "data points" (audio clips) per epoch', default=200000)
    parser.add_argument("--path", default=None,
                        help="directory of a file dataset (not ported yet: only "
                        "synthesized-on-the-fly data)")
    parser.add_argument("--sr", type=int, help="Sampling rate", default=44100)
    parser.add_argument("--scale", type=float,
                        help="Scale factor (of input size & whole model)", default=1.0)
    parser.add_argument("--shrink", type=int,
                        help="Shink output chunk relative to input by this divisor", default=4)
    parser.add_argument("--dtype", default="float32",
                        help="compute dtype: float32 (bfloat16 is not ported yet)")
    parser.add_argument("--nmodel", type=int, default=1,
                        help="model-axis size (model parallelism is not ported yet)")
    parser.add_argument("--seed", type=int, default=218)
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="profiler trace directory (not ported yet)")
    parser.add_argument("--out-checkpoint", default=None, metavar="FILE",
                        help="where to save checkpoints (default: same as --checkpoint)")
    parser.add_argument("--cp-every", type=int, default=25, help="epochs between checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    return parser


def unported(args) -> list[str]:
    """The options on this command line that need a part not ported yet."""
    found = []
    if args.path is not None:
        found.append("--path (file datasets)")
    if args.compand:
        found.append("--compand (file datasets)")
    if args.dtype not in ("float32", "f32"):
        found.append(f"--dtype {args.dtype} (the bf16 operand policy)")
    if args.nmodel != 1:
        found.append("--nmodel (model parallelism)")
    if args.profile is not None:
        found.append("--profile")
    return found


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    print("Command line: ", " ".join(sys.argv[:]))
    missing = unported(args)
    if missing:
        print("Error: not yet ported: " + ", ".join(missing))
        sys.exit(1)

    from ..dsp import effects
    from ..training.train import train

    try:
        effect = effects.make_effect(args.effect, sr=args.sr, device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"Error: {e}")
        sys.exit(1)
    print("Running with args =", args)
    train(
        effect,
        epochs=args.epochs,
        n_data_points=args.num,
        batch_size=args.batch,
        cp_every=args.cp_every,
        sr=args.sr,
        scale_factor=args.scale,
        shrink_factor=args.shrink,
        lr_max=args.lrmax,
        in_checkpointname=args.checkpoint,
        out_checkpointname=args.out_checkpoint or args.checkpoint,
        seed=args.seed,
        device=args.device,
    )
    print("run_train: Execution completed.")


if __name__ == "__main__":
    main()
