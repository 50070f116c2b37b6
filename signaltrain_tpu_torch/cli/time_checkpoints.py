"""Time what checkpoints cost train() on one NVIDIA GPU.

    python -m signaltrain_tpu_torch.cli.time_checkpoints [--epochs 6] [--turns 2]

Runs ``train()`` on comp_4c at the flagship geometry (8192 -> 2048 samples),
bf16, batch 200, 60 steps and 15 validation batches an epoch, seed 218 and
lr_max 2e-4 (``chip_smoke.py``'s phase 7c), in turns: with a checkpoint every
epoch (``cp_every=1``) and with the last epoch's only (``cp_every`` = the
epochs), each run in a fresh directory after one untimed run of one epoch. A
run's wall time counts from the call to its return, so the background
writer's drain is in it. One checkpoint's cost to the loop is (the run with a
checkpoint every epoch - the run without) / (epochs - 1), for each turn. The
card's name and power limit head the output; the last line is a JSON object
of the readings.

The script imports the package by its name, so that with another checkout's
root on PYTHONPATH, ``python signaltrain_tpu_torch/cli/time_checkpoints.py``
times that checkout's ``train()`` in the same way: two versions of the loop
compared in one sitting, in turns.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import tempfile
import time

import torch

POINTS, BATCH = 12_000, 200  # 60 steps an epoch, 15 validation batches
KW = dict(n_data_points=POINTS, batch_size=BATCH, sr=44100, lr_max=2e-4, seed=218,
          compute_dtype=torch.bfloat16)


def run_seconds(effect, dev, epochs: int, cp_every: int) -> float:
    """Wall seconds of one ``train()`` call in a fresh directory, its
    printing discarded."""
    from signaltrain_tpu_torch.training import train as train_mod

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, open(os.devnull, "w") as null:
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(null):
                t0 = time.perf_counter()
                train_mod.train(effect, epochs=epochs, cp_every=cp_every, device=dev, **KW)
                return time.perf_counter() - t0
        finally:
            os.chdir(cwd)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_checkpoints needs a CUDA card")
    import signaltrain_tpu_torch
    from signaltrain_tpu_torch.dsp import effects

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"package: {os.path.dirname(signaltrain_tpu_torch.__file__)}")
    dev = torch.device("cuda")
    effect = effects.make_effect("comp_4c", device=dev)
    run_seconds(effect, dev, 1, 1)  # builds and loads the kernels, warms the libraries
    ways = {"every_epoch": 1, "last_only": args.epochs}
    runs = {way: [] for way in ways}
    for turn in range(args.turns):
        for way in (ways if turn % 2 == 0 else reversed(list(ways))):
            runs[way].append(run_seconds(effect, dev, args.epochs, ways[way]))
            print(f"turn {turn}: {way} (cp_every {ways[way]}): {runs[way][-1]:.4f} s")
    per_cp = [(a - b) / (args.epochs - 1) for a, b in zip(runs["every_epoch"], runs["last_only"])]
    print(f"one checkpoint costs the loop {min(per_cp) * 1e3:.1f}-{max(per_cp) * 1e3:.1f} ms "
          f"(epochs of {POINTS // BATCH} steps at batch {BATCH}, bf16) on {smi}")
    print(json.dumps({"card": smi, "epochs": args.epochs, "seconds": runs,
                      "ms_a_checkpoint": [v * 1e3 for v in per_cp]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
