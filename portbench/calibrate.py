"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... [--control-seeds <k>]

For each seed, in one process: the program's numbers as a run compares them
(a training cell's first three steps; a serving cell's sample of songs,
the longest among them, served one after another at the cell's load), then
for the first ``--control-seeds`` seeds the control's (the reference in the
precision below the configuration's, in the program's place: fp8 products
for bfloat16, TF32 products for float32) and, for a training cell, the
faults' (the reference with half of each batch, and with the compressor
bypassed, in the program's place). Prints one JSON line a reading and a
summary: for each number the largest program reading and the smallest of
the control and of each fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import run as prun
from .drivers import serve, train

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def train_readings(r, with_control: bool) -> list[tuple[str, dict]]:
    model, opt, steps, state, _ = train.build(r)
    got = train.first_three(model, opt, steps)
    del model, opt, steps
    r.free()
    ref = train.reference(r, state)
    out = [("program", train.numbers(got, ref, leaves=True))]
    if with_control:
        ctrl = train.reference(r, state, CONTROL[r.workload["compute_dtype"]])
        out.append(("control", train.numbers(ctrl, ref)))
        half = train.reference(r, state, rows=r.workload["batch"] // 2)
        out.append(("fault_half_batch", train.numbers(half, ref)))
        bypass = train.reference(r, state, bypass=True)
        out.append(("fault_target_altered", train.numbers(bypass, ref)))
    return out


QUANTILES = (0.5, 0.9, 0.99)


def serve_readings(r, with_control: bool) -> list[tuple[str, dict]]:
    from signaltrain_tpu_torch.inference.predict_long import predict_long

    model, state = serve.build(r)
    traffic = serve.songs.Traffic(r.workload, r.config, np.random.default_rng([r.data_seed, 3]))
    n = r.workload["sample_requests"]
    lengths = [max(traffic.lengths)] + list(traffic.rng.choice(traffic.lengths, n - 1))
    requests = [(traffic.song(int(k)), traffic.knobs()) for k in lengths]
    served = [(s, k, predict_long(s, k, model)) for s, k in requests]
    del model
    r.free()
    out = [("program", serve.gaps(r, state, served, quantiles=QUANTILES)[0])]
    if with_control:
        prec = CONTROL[r.workload["compute_dtype"]]
        ctrl = [(s, k, serve.ref_model.predict_long(
            state, torch.from_numpy(s).to(r.device), torch.from_numpy(k).to(r.device),
            r.config, prec).cpu().numpy()) for s, k in requests]
        out.append(("control", serve.gaps(r, state, ctrl, quantiles=QUANTILES)[0]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    readings = {}
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        r = prun.Run(a.workload, seed, 0.0, False, a.device)
        fn = train_readings if r.workload["driver"] == "train" else serve_readings
        for kind, nums in fn(r, i < a.control_seeds):
            leaves = {k: nums.pop(k) for k in list(nums) if k.endswith("_leaves")}
            worst = {k: sorted(v.items(), key=lambda kv: -kv[1])[:3] for k, v in leaves.items()}
            readings.setdefault(kind, []).append(nums)
            print(json.dumps({"seed": seed, "kind": kind, **nums, **worst,
                              "s": round(time.perf_counter() - t, 2)}), flush=True)
    summary = {}
    for kind, rows in readings.items():
        agg = max if kind == "program" else min
        summary[kind] = {k: agg(row[k] for row in rows) for k in rows[0]}
    print(json.dumps({"summary": summary, "seeds": len(a.seeds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
