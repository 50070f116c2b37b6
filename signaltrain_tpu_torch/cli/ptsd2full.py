"""Rebuild a model from a checkpoint and re-save it as a standalone bundle:
the JAX package's cli/ptsd2full.py on the port.

    python -m signaltrain_tpu_torch.cli.ptsd2full model.tar [out.tar] [--device cpu]

Rebuilds the model from the checkpoint's metadata (``utils/load_model``,
``strict=True``), prints the run values' keys, the geometry and the
parameter count, and writes weights, geometry and the effect's knob
metadata to ``out.tar`` (by default ``<infile>_full.tar``) in the
reference's schema, without optimizer state.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Rebuild a full model from a checkpoint and re-save it",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("infile", help="checkpoint .tar file")
    parser.add_argument("outfile", nargs="?", default=None,
                        help="output file (default: <infile>_full.tar)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    args = parser.parse_args(argv)

    from ..training import checkpoint
    from ..utils.load_model import load_model

    model, rv = load_model(args.infile, device=args.device)
    print("checkpoint keys -> run values:", sorted(rv.keys()))
    print("model spec:", model.spec)
    print("parameters:", sum(p.numel() for p in model.parameters()))

    class _Eff:  # the checkpoint's effect metadata
        name = rv.get("effect_name", "unknown")
        knob_names = rv["knob_names"]
        knob_ranges = rv["knob_ranges"]

    out = args.outfile or args.infile.replace(".tar", "_full.tar")
    checkpoint.save_checkpoint(out, model.spec, _Eff, rv.get("epoch", 0) - 1,
                               checkpoint.training_tensors(model))
    print(f"\nSaved full model to {out}")


if __name__ == "__main__":
    main()
