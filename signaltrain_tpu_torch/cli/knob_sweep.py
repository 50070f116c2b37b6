"""Headless knob sweep (the port of demo/knob_sweep.py): one knob swept
across its range, the effect's target against the model's prediction.

    python -m signaltrain_tpu_torch.cli.knob_sweep CHECKPOINT [--effect comp_4c]
        [--knob 0] [--frames 24] [--signal box] [--movie] [--outdir knob_sweep]
        [--device cuda]

The input is one synthesized chunk (``--signal``, onset at 0.35 of the chunk,
from a generator seeded 0). Frame f sets knob ``--knob`` to the f-th of
``--frames`` values evenly spaced over [-0.5, 0.5] (the others at 0, the
middle of their ranges), runs the effect on the input (for comp_4c kernel C
on the card) and the model on the effect's input (kernels A and B), and
draws input, target and prediction to ``OUTDIR/sweep_%04d.png`` with
``utils/plots``. ``--movie`` assembles ``knob_sweep.mp4`` with ffmpeg when
it is on the PATH (the reference's makemovie, io_methods.py:399-421).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

import numpy as np
import torch

SIGNALS = {"sine": 0, "pluck": 2, "triangle": 3, "box": 4, "amp steps": 8}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Render a knob sweep of target vs prediction",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint")
    parser.add_argument("--effect", default="comp_4c")
    parser.add_argument("--knob", type=int, default=0, help="index of knob to sweep")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--signal", default="box", choices=list(SIGNALS))
    parser.add_argument("--movie", action="store_true", help="assemble knob_sweep.mp4 with ffmpeg")
    parser.add_argument("--outdir", default="knob_sweep")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    args = parser.parse_args(argv)

    from ..dsp import effects as fx
    from ..dsp import synths
    from ..utils.load_model import load_model
    from ..utils.plots import plot_sweep_frame

    model, _ = load_model(args.checkpoint, device=args.device)
    dev, spec = model.device, model.spec
    effect = fx.make_effect(args.effect, sr=spec.sr, device=dev)
    os.makedirs(args.outdir, exist_ok=True)

    g = torch.Generator(device=dev).manual_seed(0)
    t = torch.arange(spec.in_chunk_size, dtype=torch.float32, device=dev) / spec.sr
    x = synths.synth_input_sample(g, t, SIGNALS[args.signal], 1, t0_fac=0.35)[0]
    kr = np.asarray(effect.knob_ranges, np.float32)
    frames = []
    seconds = 0.0
    for f, v in enumerate(np.linspace(-0.5, 0.5, args.frames)):
        knobs_nn = np.zeros(len(kr), np.float32)
        knobs_nn[args.knob] = v
        t0 = time.perf_counter()
        with torch.no_grad():
            y_t, x_in = effect.go(x, torch.from_numpy(knobs_nn).to(dev), generator=g)
            y_p = model(x_in[None], torch.from_numpy(knobs_nn).to(dev)[None])[0][0]
        frame = {"knobs_nn": knobs_nn, "x_in": x_in.cpu().numpy(), "target": y_t.cpu().numpy(),
                 "pred": y_p.cpu().numpy()}
        seconds += time.perf_counter() - t0
        knobs_wc = kr[:, 0] + (knobs_nn + 0.5) * (kr[:, 1] - kr[:, 0])
        title = ", ".join(f"{nm}={wv:.3g}" for nm, wv in zip(effect.knob_names, knobs_wc))
        fname = os.path.join(args.outdir, f"sweep_{f:04d}.png")
        plot_sweep_frame(frame["x_in"], frame["target"], frame["pred"],
                         f"{effect.name}: {title}", fname)
        frames.append(frame)
        print(f"\rframe {f + 1}/{args.frames} -> {fname}   ", end="")
    print()
    out = {"frames": frames, "ms_a_frame": 1e3 * seconds / max(1, args.frames), "movie": None}
    if args.movie:
        if shutil.which("ffmpeg") is None:
            print("ffmpeg not found; skipping movie assembly")
            return out
        subprocess.run(["ffmpeg", "-y", "-framerate", "10", "-i",
                        os.path.join(args.outdir, "sweep_%04d.png"), "-c:v", "libx264",
                        "-vf", "format=yuv420p", "knob_sweep.mp4"], check=False)
        print("wrote knob_sweep.mp4")
        out["movie"] = "knob_sweep.mp4"
    return out


if __name__ == "__main__":
    main()
