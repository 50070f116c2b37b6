"""Apply a sox effect, with parameters drawn from ranges, to a list of input
files (the port of cli/soxeffect.py; reference: utils/soxeffect.py).

    python -m signaltrain_tpu_torch.cli.soxeffect chorus \
        '0.7,0.9 0.5,0.9 40.0,60.0 0.2,0.5 0.1,.4 1.0,3.0 -s' input*.wav

A comma-separated pair of numbers in the settings string is a min,max
range: each file gets a uniform draw from numpy's global generator, to 3
decimals, burned into the target's name (``target_<i>__p1__p2.wav``). The
tool prints an effect_info.ini stanza. The draws are made in this process,
one file after another in the order given, and the ``sox`` commands then run
in parallel, one thread a CPU core, so the values do not depend on how the
files are shared out. Pure numpy and sox: no device is used.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def is_number(string: str) -> bool:
    try:
        float(string)
        return True
    except ValueError:
        return False


def ranges_to_vals(s: str):
    """Replace each 'min,max' pair with a uniform draw (soxeffect.py:46-62).
    Returns (settings_string, value_strings, ranges)."""
    out_str = ""
    pvals, pranges = [], []
    for p in s.split(" "):
        mm = p.split(",")
        valstr = mm[0]
        if is_number(valstr) and len(mm) > 1:
            minval, maxval = float(valstr), float(mm[1])
            pranges.append([minval, maxval])
            val = minval + np.random.rand() * (maxval - minval)
            valstr = f"{val:.3f}"
            pvals.append(valstr)
        out_str += f"{valstr} "
    return out_str, pvals, pranges


def command(in_file: str, effect: str, params: str):
    """(the sox command for one input file, its parameter ranges)."""
    paramstr, pvals, pranges = ranges_to_vals(params)
    out_file = "target" + in_file.replace("input", "")
    pvalstr = "".join(f"__{p}" for p in pvals) if pvals else "_1"
    out_file = out_file.replace("_.wav", f"{pvalstr}.wav")
    return f"sox --multi-threaded {in_file} {out_file} {effect} {paramstr}", pranges


def _run(cmd: str) -> None:
    print("  execstr = ", cmd)
    subprocess.run(cmd, shell=True, check=False)


def info_stanza(effect: str, params: str, pranges) -> str:
    n_ranges = params.count(",")
    if n_ranges > 1:
        knob_names, knob_ranges = [f"p{n}" for n in range(n_ranges)], pranges
    else:
        knob_names, knob_ranges = "['p1']", "[[.999, 1.001]]"
    return (f"[effect]\nname = sox_{effect}\nknob_names = {knob_names}\n"
            f"knob_ranges = {knob_ranges}")


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description="Applies a sox audio effect to lots of files",
                                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("effect", help="Name of effect class for generating target")
    parser.add_argument("params", help="String of control settings")
    parser.add_argument("inputs", nargs="+", help="List of input files")
    args = parser.parse_args(argv)
    print("args =", args)

    planned = [command(f, args.effect, args.params) for f in args.inputs]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(_run, [cmd for cmd, _ in planned]))
    pranges = planned[-1][1] if planned else []
    print("\n\nCopy & paste the following to use as effect_info.ini file:\n")
    print(info_stanza(args.effect, args.params, pranges))
    return [cmd for cmd, _ in planned]


if __name__ == "__main__":
    main()
