"""Model internals visualization (the port of cli/viz.py; reference: utils/viz.py).

    python -m signaltrain_tpu_torch.cli.viz CHECKPOINT [--audiofile WAV]
        [--knobs k1,k2,...] [--out viz.png] [--interactive] [--device cuda]

Runs the model on one input chunk with ``return_acts=True`` and tiles every
activation (the input, the model's 30 activations, the output), each drawn
in viridis over its 1st to 99th percentile, then the four front-end weight
matrices in magma, into one image of ``width`` pixels, with a 2-pixel white
rule under each tile. The input is the chunk at the head of ``--audiofile``
(zero-padded), or a synthesized box (branch 4, onset at 0.3 of the chunk,
from a generator seeded 0). The knobs are normalized, in [-0.5, 0.5]
(default 0). ``return_acts`` takes the model's batch-major gemm front-end,
as in the JAX package, so no front-end kernel runs here.

The image is drawn with Pillow (the card's machine has neither matplotlib
nor, for certain, OpenCV) and written as a PNG. ``--interactive`` shows it
in an OpenCV window with a trackbar a knob; it imports cv2 only then, and
fails with a clear error without cv2 or without a display.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

TILE_MIN, TILE_MAX, WEIGHT_TILE, RULE = 24, 160, 160, 2
WEIGHTS = ("mpaec.dft_analysis.conv_analysis_real.weight",
           "mpaec.dft_analysis.conv_analysis_imag.weight",
           "mpaec.dft_synthesis.conv_synthesis_real.weight",
           "mpaec.dft_synthesis.conv_synthesis_imag.weight")


def _norm_img(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    lo, hi = np.percentile(a, 1), np.percentile(a, 99)
    return np.clip((a - lo) / max(hi - lo, 1e-9), 0, 1)


def _tile(a: np.ndarray, lut: np.ndarray, width: int, height: int) -> np.ndarray:
    from PIL import Image

    img = lut[(_norm_img(a) * 255).astype(np.uint8)]
    return np.asarray(Image.fromarray(img).resize((width, height), Image.BILINEAR))


def tile_heights(acts) -> list[int]:
    """The pixel height of each activation's tile (the weights' are WEIGHT_TILE)."""
    heights = []
    for a in acts:
        shape = tuple(a.shape)
        shape = shape[1:] if len(shape) == 3 else ((1,) + shape if len(shape) == 1 else shape)
        heights.append(max(TILE_MIN, min(TILE_MAX, min(shape))))  # the longer axis runs across
    return heights


def render_acts(acts, state_dict, width: int = 1600) -> np.ndarray:
    """(H, width, 3) uint8: the activations (numpy or tensors; the first
    example of a batch) then the four front-end matrices of ``state_dict``."""
    from ..utils.plots import _MAGMA, _lut

    viridis, magma = _lut(), _lut(_MAGMA)
    rule = np.full((RULE, width, 3), 255, np.uint8)
    tiles = []
    for a, h in zip(acts, tile_heights(acts)):
        a = a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        a = a[0] if a.ndim == 3 else (a[None, :] if a.ndim == 1 else a)
        tiles += [_tile(a.T if a.shape[0] > a.shape[1] else a, viridis, width, h), rule]
    for key in WEIGHTS:
        w = state_dict[key].detach().float().cpu().numpy()[:, 0, :]
        tiles += [_tile(w, magma, width, WEIGHT_TILE), rule]
    return np.concatenate(tiles, axis=0)


def viz_input(model, audiofile: str | None, device) -> torch.Tensor:
    """The (chunk,) input on ``device``: the head of the file, or a box."""
    from ..data import audio_io
    from ..dsp import synths

    chunk, sr = model.spec.in_chunk_size, model.spec.sr
    if audiofile:
        sig, _ = audio_io.read_audio_file(audiofile, sr=sr)
        x = np.zeros(chunk, np.float32)
        x[: min(chunk, len(sig))] = sig[:chunk]
        return torch.from_numpy(x).to(device)
    t = torch.arange(chunk, dtype=torch.float32, device=device) / sr
    g = torch.Generator(device=device).manual_seed(0)
    return synths.synth_input_sample(g, t, 4, 1, t0_fac=0.3)[0]


def forward_acts(model, x: torch.Tensor, knobs_nn) -> list[torch.Tensor]:
    """[x, *the model's 30 activations, y] for one input and its knobs."""
    k = torch.as_tensor(np.asarray(knobs_nn, np.float32), device=x.device)[None]
    with torch.no_grad():
        y, _, _, acts = model(x[None], k, return_acts=True)
    return [x, *acts, y]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Visualize model activations & weights",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("checkpoint", help="model checkpoint .tar")
    parser.add_argument("--audiofile", default=None, help="input wav (default: synth box signal)")
    parser.add_argument("--knobs", default="",
                        help="comma-separated normalized knobs in [-0.5, 0.5]")
    parser.add_argument("--out", default="viz.png")
    parser.add_argument("--interactive", action="store_true",
                        help="OpenCV window with trackbar knobs (needs cv2 and a display)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    args = parser.parse_args(argv)

    from ..utils.load_model import load_model

    model, rv = load_model(args.checkpoint, device=args.device)
    names = list(rv["knob_names"])
    x = viz_input(model, args.audiofile, model.device)
    knobs = (np.zeros(len(names), np.float32) if args.knobs == ""
             else np.array([float(v) for v in args.knobs.split(",")], np.float32))
    state_dict = model.state_dict()

    if args.interactive:
        _interactive(lambda kn: render_acts(forward_acts(model, x, kn), state_dict), names)
        return {}
    from PIL import Image

    acts = forward_acts(model, x, knobs)
    img = render_acts(acts, state_dict)
    Image.fromarray(img).save(args.out)
    print(f"wrote {args.out} ({img.shape[1]}x{img.shape[0]})")
    return {"out": args.out, "image": img, "acts": acts, "x": x, "knobs": knobs,
            "tiles": len(acts) + len(WEIGHTS)}


def _interactive(frame, knob_names) -> None:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("--interactive needs OpenCV (cv2), which is not installed") from e
    if os.name == "posix" and not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        raise RuntimeError("--interactive needs a display (DISPLAY is not set)")
    win = "signaltrain-tpu-torch viz"
    cv2.namedWindow(win, cv2.WINDOW_NORMAL)
    for name in knob_names:
        cv2.createTrackbar(name, win, 50, 100, lambda v: None)
    while True:
        kn = np.array([cv2.getTrackbarPos(n, win) / 100.0 - 0.5 for n in knob_names], np.float32)
        cv2.imshow(win, frame(kn)[:, :, ::-1])  # OpenCV wants BGR
        if cv2.waitKey(50) & 0xFF in (27, ord("q")):
            break
    cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
