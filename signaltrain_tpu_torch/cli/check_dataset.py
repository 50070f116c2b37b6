"""Dataset consistency checker / fixer: the JAX package's cli/check_dataset.py,
on the port's audio_io (host-side numpy and scipy, no device work).

    python -m signaltrain_tpu_torch.cli.check_dataset DIR [--fix]

Checks input/target pairing, numbering, sample rates, shapes, and timing skew
(FFT cross-correlation); optional in-place fixes mirror the reference flags:
  -a align via cross-correlation, -d delete extras, -l truncate to equal
  length, -m force mono, -s enforce the first input's sample rate,
  --fix = all of the above, -f skip the slow timing checks.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np
from scipy import signal as ssig
from scipy.io import wavfile

from ..data import audio_io


class colors:
    RED = "\033[31m"
    GREEN = "\033[32m"
    RESET = "\033[0m"


def estimate_time_shift(x, y):
    """argmax of the FFT cross-correlation -> sample offset between x and y."""
    corr = ssig.correlate(y, x, mode="same", method="fft")
    nx = len(x)
    ct_samples = np.arange(nx) - nx // 2
    return int(ct_samples[np.argmax(corr)])


def is_acceptable(filename: str) -> bool:
    return filename.lower().endswith((".wav", ".mp3", ".aif", ".aiff")) and (
        ("input_" in filename) or ("target_" in filename)
    )


def _file_num(name: str):
    m = re.search("_[0-9]+_", os.path.basename(name))
    return m.group() if m else None


def gather(input_or_dir, more):
    if not more:
        d = input_or_dir
        if not os.path.isdir(d):
            raise SystemExit(f"{d} is not a directory")
        print(f"Operating on directory {d}")
        input_list, target_list = [], []
        for dirpath, _, files in os.walk(d):
            for f in files:
                if f.lower().endswith((".wav", ".mp3", ".aif", ".aiff")):
                    if "input" in f:
                        input_list.append(os.path.join(dirpath, f))
                    elif "target" in f:
                        target_list.append(os.path.join(dirpath, f))
    else:
        file_list = [input_or_dir] + more
        print(f"Operating on a list of {len(file_list)} files")
        input_list = [x for x in file_list if "input" in x]
        target_list = [x for x in file_list if "target" in x]
    return sorted(input_list), sorted(target_list)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Check dataset for mismatches",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("input_or_dir", help="input file 1, or directory")
    parser.add_argument(
        "target_or_more_files", nargs="*",
        help="target file 1, or optional more files (for non-directory usage)",
    )
    parser.add_argument("-a", "--align", action="store_true",
                        help="Fix: Align time (overwrites)")
    parser.add_argument("-d", "--delete", action="store_true",
                        help="Fix: Delete extra/unmatching files (overwrites)")
    parser.add_argument("-f", "--fast", action="store_true",
                        help="Fast: skip timing checks")
    parser.add_argument("-l", "--length", action="store_true",
                        help="Fix: Make lengths the same, by truncating (overwrites)")
    parser.add_argument("-m", "--mono", action="store_true",
                        help="Fix: Force mono (overwrites)")
    parser.add_argument("-s", "--sr", action="store_true",
                        help="Fix: Enforce sample rate of first input (overwrites)")
    parser.add_argument("--fix", action="store_true",
                        help="Fix: Apply all fixes (overwrites)")
    args = parser.parse_args(argv)
    if args.fix:
        args.align = args.length = args.delete = args.sr = args.mono = True

    input_list, target_list = gather(args.input_or_dir, args.target_or_more_files)

    print("\n#### SIMPLE SANITY CHECKS based on filenames. Fast")
    ni, nt = len(input_list), len(target_list)
    if ni != nt:
        print(f"{colors.RED}**PROBLEM**:{colors.RESET} {ni} inputs but {nt} targets")
        input_nums = {_file_num(i) for i in input_list}
        target_nums = {_file_num(i) for i in target_list}
        extra_i = [i for i in input_list if _file_num(i) not in target_nums]
        extra_t = [t for t in target_list if _file_num(t) not in input_nums]
        for f in extra_i:
            print(f"  {_file_num(f)} is in inputs but not targets")
        for f in extra_t:
            print(f"  {_file_num(f)} is in targets but not inputs")
        if args.delete:
            for f in extra_i + extra_t:
                print(f"  Deleting {f}")
                os.remove(f)
            input_list = [i for i in input_list if i not in extra_i]
            target_list = [t for t in target_list if t not in extra_t]
            ni = len(input_list)
        else:
            sys.exit(1)

    basenames = [os.path.basename(p) for p in input_list + target_list]
    if len(basenames) != len(set(basenames)):
        raise SystemExit("You've got duplicates")

    for i in range(ni):
        ibase = os.path.basename(input_list[i])
        tbase = os.path.basename(target_list[i])
        if "input_" not in ibase or "target_" not in tbase:
            raise SystemExit(f"not an input/target pair: {ibase}, {tbase}")
        if _file_num(ibase) != _file_num(tbase):
            print(
                f"{colors.RED}    **PROBLEM**:{colors.RESET} For input = "
                f"{input_list[i]},  target = {target_list[i]}: numbering mismatch"
            )
            sys.exit(1)
        if os.path.dirname(input_list[i]) != os.path.dirname(target_list[i]):
            raise SystemExit(f"{input_list[i]} and {target_list[i]} are in different directories")

    print("#### CHECKING THE AUDIO.  Slower.")
    sr_enforce = None
    any_problem = False
    for i in range(ni):
        problem, repaired = False, False
        input_filename, target_filename = input_list[i], target_list[i]
        print(f"input = {input_filename},    target = {target_filename}")

        sr_x, x = wavfile.read(input_filename)
        sr_y, y = wavfile.read(target_filename)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        if sr_enforce is None:
            sr_enforce = sr_x

        if sr_x != sr_y:
            print(f"{colors.RED}    **PROBLEM**: sr_x ({sr_x}) != sr_y ({sr_y}){colors.RESET}")
            if args.sr:
                y = audio_io.resample(y, sr_y, sr_enforce)
                x = audio_io.resample(x, sr_x, sr_enforce) if sr_x != sr_enforce else x
                sr_x = sr_y = sr_enforce
                repaired = True
                print("     Fixing: resampling to", sr_enforce)
            else:
                problem = True

        if x.shape != y.shape:
            print(
                f"{colors.RED}    **PROBLEM**: x.shape ({x.shape}) != "
                f"y.shape ({y.shape}){colors.RESET}"
            )
            if args.length:
                newlen = min(x.shape[0], y.shape[0])
                x, y = x[:newlen], y[:newlen]
                repaired = True
                print(f"     Fixing: truncated both to {newlen}")
            else:
                problem = True

        if args.mono:
            if x.ndim > 1:
                x, repaired = x[:, 0], True
            if y.ndim > 1:
                y, repaired = y[:, 0], True

        if not args.fast:
            xm = x if x.ndim == 1 else x[:, 0]
            ym = y if y.ndim == 1 else y[:, 0]
            short_len = max(len(xm) // 10, min(len(xm), 4096))
            dt = estimate_time_shift(xm[:short_len], ym[:short_len])
            if dt != 0:
                print(
                    f"{colors.RED}    **PROBLEM**: Estimated time shift of {dt} "
                    f"samples from input to target.{colors.RESET}"
                )
                problem = True
                if args.align:
                    print("        Trying to fix alignment...")
                    if dt < 0:
                        x = x[-dt:]
                    else:
                        y = y[dt:]
                    newlen = min(x.shape[0], y.shape[0])
                    x, y = x[:newlen], y[:newlen]
                    dt = estimate_time_shift(x[:short_len], y[:short_len])
                    print(f"        New estimated time shift = {dt} samples")
                    if dt == 0:
                        problem, repaired = False, True
                    else:
                        raise RuntimeError("Can't figure out what to do with this.")

        if not problem:
            print(f" {colors.GREEN}  Looks good! :-) {colors.RESET}")
        any_problem |= problem

        if repaired:
            print("       Overwriting new version of input and target...")
            wavfile.write(input_filename, int(sr_x), x)
            wavfile.write(target_filename, int(sr_y), y)

    sys.exit(1 if any_problem else 0)


if __name__ == "__main__":
    main()
