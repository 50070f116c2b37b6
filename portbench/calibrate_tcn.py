"""The readings that the limits of ``train-tcn300c-f32``'s ``correct`` are
set from, on the card.

    python3 -m portbench.calibrate_tcn --seeds <n> ... [--control-seeds <k>]

For each seed, in one process: the program's numbers as a run compares them
(its first three steps against the float64 reference), then for the first
``--control-seeds`` seeds the control's (``reference/tcn.py`` in ``"tf32"``
in the program's place) and the faults' (the reference with FiLM dropped,
with BatchNorm on its running statistics in training, and with comp_4c's
compressor bypassed at the cell's rows of 78,868 samples, in the program's
place). Prints one JSON line a reading, with the seconds the float64
reference took, and a summary: for each number the largest program reading
and the smallest of the control and of each fault.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as prun
from .drivers import train, train_tcn

CELL = "train-tcn300c-f32"


def readings(r, with_control: bool) -> list[tuple[str, dict]]:
    model, opt, steps, state, _ = train_tcn.build(r)
    got = train.first_three(model, opt, steps)
    del model, opt, steps
    r.free()
    t = time.perf_counter()
    ref = train_tcn.reference(r, state)
    r.synchronize()
    out = [("program", dict(train.numbers(got, ref, leaves=True),
                            reference_s=time.perf_counter() - t))]
    if with_control:
        out.append(("control", train.numbers(train_tcn.reference(r, state, "tf32"), ref)))
        for fault in ("film_dropped", "bn_running"):
            out.append((f"fault_{fault}",
                        train.numbers(train_tcn.reference(r, state, fault=fault), ref)))
        out.append(("fault_target_altered",
                    train.numbers(train_tcn.reference(r, state, bypass=True), ref)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    rows = {}
    for i, seed in enumerate(a.seeds):
        t = time.perf_counter()
        r = prun.Run(CELL, seed, 0.0, False, a.device)
        for kind, nums in readings(r, i < a.control_seeds):
            leaves = {k: nums.pop(k) for k in list(nums) if k.endswith("_leaves")}
            worst = {k: sorted(v.items(), key=lambda kv: -kv[1])[:3] for k, v in leaves.items()}
            rows.setdefault(kind, []).append(nums)
            print(json.dumps({"seed": seed, "kind": kind, **nums, **worst,
                              "s": round(time.perf_counter() - t, 2)}), flush=True)
    summary = {kind: {k: (max if kind == "program" else min)(row[k] for row in got)
                      for k in got[0]} for kind, got in rows.items()}
    print(json.dumps({"summary": summary, "seeds": len(a.seeds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
