"""Learning-rate finder: the JAX package's cli/lr_finder.py on the port.

    python -m signaltrain_tpu_torch.cli.lr_finder [--effect comp_4c] [-b 200]
        [--npoints 150] [--trials 3] [--lr-min 1e-6] [--lr-max 4e-3]
        [--dtype bfloat16] [--device cuda]

Sweeps log-spaced learning rates from ``--lr-min`` to ``--lr-max``
(``--npoints`` points, ``--trials`` steps each) through the port's train
step (data synthesized on the device, the front-end clip, Adam), from a
fresh model seeded with 0 on the batches of seed 1, and writes the loss of
each point's last step against its rate to ``lrfind.dat`` and
``lrfind.png`` in the working directory; it stops at the first loss that is
not finite. Pick lr_max around the steepest descent.

On the card the steps are replays of one ``training.graphs.TrainGraph``
(its learning rate read from the sweep for each step), and a point's loss
is read from the host after the next point has been dispatched, so no
trial waits on the card. ``--device cpu`` runs the steps eagerly.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Learning rate finder",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--effect", default="comp_4c")
    parser.add_argument("-b", "--batch", type=int, default=200)
    parser.add_argument("--path", default=None)
    parser.add_argument("--sr", type=int, default=44100)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--shrink", type=int, default=4)
    parser.add_argument("--npoints", type=int, default=150)
    parser.add_argument("--trials", type=int, default=3, help="batches per LR point")
    parser.add_argument("--lr-min", type=float, default=1e-6)
    parser.add_argument("--lr-max", type=float, default=4e-3)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    return parser


def sweep(effect, lrs: np.ndarray, trials: int, batch: int, scale: float, shrink: float,
          sr: int, compute_dtype: torch.dtype, device: torch.device) -> list[float]:
    """The losses of each point's last step, in order, up to and with the
    first that is not finite."""
    from ..data import synth_data
    from ..models.st_model import st_model
    from ..training import train as train_mod

    model = st_model(scale_factor=scale, shrink_factor=shrink, num_knobs=effect.num_knobs, sr=sr,
                     device=device, generator=torch.Generator().manual_seed(0),
                     compute_dtype=compute_dtype).train()
    spec = model.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size,
                                              sr=sr)
    opt = train_mod.adam(model, float(lrs[0]))
    lr_fn = lambda step: float(lrs[step // trials])  # noqa: E731
    generator = torch.Generator(device=device)
    if device.type == "cuda":
        from ..training import graphs

        run = graphs.TrainGraph(model, opt, lr_fn, batch_fn, batch, generator, 1, trials)
    else:
        run = functools.partial(train_mod.eager_steps, model, opt, lr_fn, batch_fn, batch,
                                generator, 1)
    losses: list[float] = []
    pending = None
    for n in range(len(lrs) + 1):
        point = None
        if n < len(lrs):  # dispatch point n, then read point n - 1
            point = train_mod.HostCopy(run(n * trials, trials)[-1:])
        if pending is not None:
            losses.append(float(pending.get()[0]))
            print(f"\r{len(losses)}/{len(lrs)}: lr={lrs[len(losses) - 1]:.2e} "
                  f"loss={losses[-1]:.3e}   ", end="")
            if not np.isfinite(losses[-1]):
                print("\nLoss diverged; stopping sweep")
                break
        pending = point
    return losses


def main(argv=None) -> None:
    from ..config import DTYPES
    from ..dsp import effects as fx
    from ..utils import plots
    from ..utils.device import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    effect = fx.make_effect(args.effect, path=args.path, sr=args.sr, device=device)
    lrs = np.logspace(np.log10(args.lr_min), np.log10(args.lr_max), args.npoints)
    losses = sweep(effect, lrs, args.trials, args.batch, args.scale, args.shrink, args.sr,
                   DTYPES[args.dtype], device)
    lrs = lrs[: len(losses)]
    np.savetxt("lrfind.dat", np.column_stack([lrs, losses]))
    plots.plot_curve(lrs, losses, "lrfind.png", "LR finder", "learning rate", "loss", xlog=True)
    print("\nSaved lrfind.png / lrfind.dat")


if __name__ == "__main__":
    main()
