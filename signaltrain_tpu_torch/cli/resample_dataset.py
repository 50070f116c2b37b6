"""Resample a whole dataset tree to a new sample rate, keeping the directory
structure and copying the files that are not audio: the JAX package's
cli/resample_dataset.py on the port's audio_io (host-side, no device work).

    python -m signaltrain_tpu_torch.cli.resample_dataset DIR [--sr 44100] [--suffix _44100]
"""

from __future__ import annotations

import argparse
import os
import shutil

from ..data import audio_io


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Resample all audio in a directory tree",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("dir", help="directory to resample")
    parser.add_argument("--sr", type=int, default=44100, help="target sample rate")
    parser.add_argument(
        "--suffix", default=None,
        help="suffix for the new top-level dir (default: _<sr>)",
    )
    args = parser.parse_args(argv)

    main_dir = args.dir.rstrip("/")
    new_main_dir = main_dir + (args.suffix or f"_{args.sr}")

    for dirname, _, files in os.walk(main_dir):
        new_dirname = dirname.replace(main_dir, new_main_dir)
        print(f"\n{dirname} -> {new_dirname}")
        os.makedirs(new_dirname, exist_ok=True)
        for filename in files:
            in_path = os.path.join(dirname, filename)
            out_path = os.path.join(new_dirname, filename)
            print(f"         {in_path} -> {out_path}")
            if filename.lower().endswith((".wav", ".mp3")):
                signal, _ = audio_io.read_audio_file(in_path, sr=args.sr, warn=False)
                audio_io.write_audio_file(out_path, signal, args.sr)
            else:
                shutil.copy(in_path, out_path)


if __name__ == "__main__":
    main()
