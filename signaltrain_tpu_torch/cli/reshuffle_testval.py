"""Randomly re-split the input_* / target_* pairs of a directory into Train/
and Val/ with P(Train) = 0.8: the JAX package's cli/reshuffle_testval.py
(host-side, no device work).

    python -m signaltrain_tpu_torch.cli.reshuffle_testval [--path .] [--split 0.8] [--seed S]
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Randomly re-split pairs into Train/ and Val/",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--path", default=".", help="directory holding the pairs")
    parser.add_argument("--split", type=float, default=0.8, help="P(Train)")
    parser.add_argument("--seed", type=int, default=None,
                        help="set for a reproducible split")
    args = parser.parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)

    input_filenames = sorted(glob.glob(os.path.join(args.path, "input_*")))
    target_filenames = sorted(glob.glob(os.path.join(args.path, "target_*")))
    if len(input_filenames) != len(target_filenames):
        raise SystemExit(f"{len(input_filenames)} input_* files but {len(target_filenames)} "
                         "target_* files")

    for d in ("Train", "Val"):
        os.makedirs(os.path.join(args.path, d), exist_ok=True)

    for i in range(len(input_filenames)):
        print(i)
        dstdir = os.path.join(
            args.path, "Train" if random.random() < args.split else "Val"
        )
        shutil.move(input_filenames[i], dstdir)
        shutil.move(target_filenames[i], dstdir)


if __name__ == "__main__":
    main()
