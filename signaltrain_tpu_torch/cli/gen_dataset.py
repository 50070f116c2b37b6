"""Dataset generator CLI: the flag surface of the JAX package's
cli/gen_dataset.py.

    python -m signaltrain_tpu_torch.cli.gen_dataset NAME [--dur 5] [-n 20000 | --sp S]
        [-e comp_4c] [--inpath DIR] [--device-batch 64] [--seed 1] [--pcm16] [--device cuda]

Writes ``NAME/Train`` and ``NAME/Val`` pairs ``input_<i>_.wav`` /
``target_<i>_<Effect>__k1__k2....wav`` (the knob values in world coordinates,
4 significant figures, in the name), an 80/20 split, grid-spaced Train knobs
with ``--sp`` (``dsp.knobs.int2knobs``), random knobs otherwise from
``np.random.seed(seed)``, and ``NAME/effect_info.ini``; numbering continues
after the pairs already there. For the same arguments the names and the
``.ini`` are the JAX tool's.

Runs on the CUDA card unless ``--device cpu`` is given. A batch of
``--device-batch`` whole files is synthesized there from a
``torch.Generator`` seeded from (seed, first file): each clip of 4,096
samples from a synth branch drawn uniformly from (0, 1, 2, 4, 6, 7, 8, 9),
normalized where its peak exceeds 1, then the effect's ``go_batch`` over the
whole files (kernel C for the comp_4c family, L for comp) and, with
``--pcm16``, the rounding to int16, on the card. Batch i + 1 is dispatched
(its copy to pinned host memory included) before batch i is written.
``--inpath`` crops real audio on the host and applies the effect on the
device. ``--backend host`` and ``--workers`` (the JAX package's pool of host
processes) are not ported yet; ``auto`` and ``device`` both run on
``--device``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from ..data import audio_io

CLIP_LENGTH = 4096
CHOOSERS = (0, 1, 2, 4, 6, 7, 8, 9)  # the reference dataset tool's synth branches
GEN_EFFECTS = ("comp_4c", "comp", "comp_t", "comp_4c_large", "comp_one")
LOG_EVERY = 100


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate synthetic data. Train will have knob-values equally spaced, "
        "Val will be random",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("name", help="Name of the dataset (creates new subdirectory)")
    parser.add_argument("-d", "--dur", type=float, default=5,
                        help="Duration of generated input (& ouput) files, in seconds "
                        "(approximate)")
    parser.add_argument("--sp", type=int, help="Settings per knob (in Train set)", default=None)
    parser.add_argument("-n", "--num", type=int, default=20000,
                        help="Number of audio files to generate (turned off if --sp option "
                        "enabled)")
    parser.add_argument("-e", "--effect", help="Name of effect to use", default="comp_4c")
    parser.add_argument("--inpath", help="Can read audio input files from here", default=None)
    parser.add_argument("--sr", type=int, help="Sampling rate", default=44100)
    parser.add_argument("--device-batch", type=int, default=64,
                        help="files synthesized per device call")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--pcm16", action="store_true",
                        help="write 16-bit PCM wavs (half the bytes; default float32)")
    parser.add_argument("--backend", choices=("auto", "device", "host"), default="auto",
                        help="'auto' and 'device' run on --device; 'host' (a pool of host "
                        "processes) is not ported yet")
    parser.add_argument("--workers", type=int, default=0,
                        help="host-backend worker processes (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.backend == "host" or args.workers:
        print("Error: not yet ported: --backend host / --workers (the host process pool)")
        sys.exit(1)
    from ..utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)
    if args.sp is None:
        print("Warning: Defaults will generate approximately",
              33.7 * args.num / 20000 * args.dur / 5,
              "GB of audio in Train/ and Val/ directories")
    stats = gen_synth_data(args)
    print(f"gen_dataset: {stats['files']} file pairs in {stats['seconds']:.2f} s "
          f"({stats['files_per_s']:.1f} files/s"
          + (f"; {stats['steady_files_per_s']:.1f} after the first batch"
             if stats["steady_files_per_s"] is not None else "") + ")"
          + (f", {stats['card_ms_per_batch']:.3f} ms of card time a device batch"
             if stats["card_ms_per_batch"] is not None else ""))
    return stats


def synth_files(g: torch.Generator, files: int, num_clips: int, t: torch.Tensor) -> torch.Tensor:
    """(files, num_clips * CLIP_LENGTH) inputs on the generator's device: each
    clip from a branch of CHOOSERS drawn uniformly (every branch computed for
    the batch, each row taking its own), finished (polarity, noise floor) and
    divided by its peak where that exceeds 1."""
    from ..dsp import synths

    total, n = files * num_clips, t.shape[0]
    ids = synths.choose_from(g, CHOOSERS, total)
    y = torch.zeros((total, n), dtype=torch.float32, device=t.device)
    for c in CHOOSERS:
        branch = synths.branch(c, t, synths.draw_branch(c, g, total, n))
        y = torch.where((ids == c)[:, None], branch, y)
    y = synths._finish(y, synths._sign(g, total), synths._u(g, total, n))
    m = torch.amax(torch.abs(y), dim=1, keepdim=True)
    y = torch.where(m > 1.0, y / m, y)
    return y.reshape(files, num_clips * n)


def gen_synth_data(args) -> dict:
    """Write the dataset that ``args`` describes; returns the run's counts and
    times (files, seconds, files_per_s; steady_files_per_s, the files after
    the first device batch over the time from its write to the last one's,
    None for one batch; batch_done_s, when each batch was written;
    card_ms_per_batch: the mean card time of a device batch's synthesis and
    effect, None on the CPU or with --inpath)."""
    from ..data import synth_data
    from ..dsp import effects as fx
    from ..dsp import knobs as knobs_mod
    from ..utils.device import resolve_device

    np.random.seed(args.seed)
    dev = resolve_device(args.device)
    name, sr, settings_per, inpath = args.name, args.sr, args.sp, args.inpath
    num_outfiles = args.num

    if args.effect not in GEN_EFFECTS:
        print("Sorry, not set up to work for other effects")
        sys.exit(1)
    effect = fx.make_effect(args.effect, sr=sr, device=dev)
    effect.info()
    nk = len(effect.knob_ranges)

    train_val_split = 0.8
    if settings_per is not None:
        num_train_files = int(settings_per**nk)
        if (inpath is None) or (("Train" not in inpath) and ("Val" not in inpath)):
            num_outfiles = int(num_train_files / train_val_split)
        else:
            num_outfiles = num_train_files
        print(f"Evenly spacing {settings_per} settings across {nk} knob(s), for "
              f"{num_train_files} files in Train and {num_outfiles} total files")

    for d in [name, name + "/Train", name + "/Val"]:
        os.makedirs(d, exist_ok=True)

    with open(name + "/effect_info.ini", "w") as f:
        print("[effect]", file=f)
        print(f"name = {effect.name}", file=f)
        print(f"knob_names = {effect.knob_names}", file=f)
        print(f"knob_ranges = {np.asarray(effect.knob_ranges).tolist()}", file=f)

    num_clips = int(np.ceil(args.dur * sr / CLIP_LENGTH))
    signal_length = CLIP_LENGTH * num_clips

    infile_list = None
    if inpath is not None:
        infile_list = glob.glob(inpath + "/*.wav") + glob.glob(inpath + "/*/*.wav")
        infile_list = [x for x in infile_list if "target" not in x]
        print("\ninfile_list =", infile_list)
    else:
        print(f"Number of {CLIP_LENGTH}-length clips per synthesized input file: {num_clips}")

    start_output_i = len(glob.glob(name + "/*/input*"))  # numbering continues

    # knob settings per file, on the host: the grid for Train (int2knobs),
    # random for Val and beyond the grid; 4 significant figures
    all_knobs_wc, all_outpaths, all_inputs_from_file = [], [], []
    for i in range(num_outfiles):
        if infile_list is not None:
            infilename = infile_list[i % len(infile_list)]
            sub = "Train/" if "Train" in infilename else (
                "Val/" if "Val" in infilename else "Test/")
            os.makedirs(os.path.join(name, sub), exist_ok=True)
            all_outpaths.append(sub)
            all_inputs_from_file.append(infilename)
        else:
            all_outpaths.append("Val/" if i / num_outfiles > 0.8 else "Train/")
            all_inputs_from_file.append(None)
        in_train = all_outpaths[-1] in ("Train/", "Val/")
        if (not in_train) or settings_per is None or i >= settings_per**nk:
            knobs_nn = np.random.rand(nk) - 0.5
            # in float32 on the host, as the JAX tool computes it
            kw = effect.knobs_wc(torch.as_tensor(knobs_nn, dtype=torch.float32)).numpy()
        else:
            kw = np.asarray(knobs_mod.int2knobs(i, np.asarray(effect.knob_ranges), settings_per))
        all_knobs_wc.append([float("%s" % float("%.4g" % v)) for v in kw])

    db = args.device_batch
    batch_starts = list(range(0, num_outfiles, db))
    on_card = dev.type == "cuda"
    out_dtype = torch.int16 if args.pcm16 else torch.float32
    card_ms, done_s = [], []  # card ms a batch; seconds from t0 to each batch written
    t0 = time.perf_counter()

    def knobs_nn_of(b0, bend):
        return knobs_mod.knobs_nn_from_wc(np.asarray(all_knobs_wc[b0:bend], np.float32),
                                          effect.knob_ranges)

    def apply(x, b0, bend, g):
        y, x = effect.go_batch(x, torch.from_numpy(knobs_nn_of(b0, bend)).to(dev), generator=g)
        if args.pcm16:
            return audio_io.to_pcm16(x), audio_io.to_pcm16(y)
        return x, y

    g = torch.Generator(device=dev)
    if infile_list is None:
        t = torch.arange(CLIP_LENGTH, dtype=torch.float32, device=dev) / sr
        # two sets of host buffers (pinned on the card): batch i + 1 is copied
        # into one while batch i is written from the other
        host = [tuple(torch.empty((db, signal_length), dtype=out_dtype, pin_memory=on_card)
                      for _ in range(2)) for _ in range(2)]
        pending = None  # (host x, host y, done event, b0, bend)
        for bi in range(len(batch_starts) + 1):
            new_pending = None
            if bi < len(batch_starts):
                b0 = batch_starts[bi]
                bend = min(b0 + db, num_outfiles)
                if on_card:
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                    ev[0].record()
                synth_data.step_generator(g, args.seed, b0)
                xd, yd = apply(synth_files(g, bend - b0, num_clips, t), b0, bend, g)
                hx, hy = host[bi % 2]
                hx, hy = hx[: bend - b0], hy[: bend - b0]
                if on_card:
                    ev[1].record()
                hx.copy_(xd, non_blocking=on_card)
                hy.copy_(yd, non_blocking=on_card)
                if on_card:
                    ev[2].record()
                new_pending = (hx, hy, ev if on_card else None, b0, bend)
            if pending is not None:
                hx, hy, ev, pb0, pbend = pending
                if ev is not None:
                    ev[2].synchronize()
                    card_ms.append(ev[0].elapsed_time(ev[1]))
                _write_pairs(effect, name, all_outpaths, all_knobs_wc, start_output_i,
                             hx.numpy(), hy.numpy(), pb0, pbend, num_outfiles, LOG_EVERY, sr)
                done_s.append(time.perf_counter() - t0)
            pending = new_pending
    else:
        for b0 in batch_starts:
            bend = min(b0 + db, num_outfiles)
            # crop real audio on the host, run the effect on the device
            xs = np.zeros((bend - b0, signal_length), np.float32)
            for j, i in enumerate(range(b0, bend)):
                sig, _ = audio_io.read_audio_file(all_inputs_from_file[i], sr=sr, warn=False)
                if signal_length >= len(sig):
                    xs[j, : len(sig)] = sig
                else:
                    ri = np.random.randint(0, len(sig) - signal_length - 1 + 1)
                    xs[j] = sig[ri : ri + signal_length]
            synth_data.step_generator(g, args.seed, b0)
            x, y = apply(torch.from_numpy(xs).to(dev), b0, bend, g)
            _write_pairs(effect, name, all_outpaths, all_knobs_wc, start_output_i,
                         x.cpu().numpy(), y.cpu().numpy(), b0, bend, num_outfiles, LOG_EVERY, sr)
            done_s.append(time.perf_counter() - t0)
    seconds = time.perf_counter() - t0
    # the rate after the first batch (its dispatch includes the effect's
    # first call): None for a run of one batch
    steady = (num_outfiles - min(db, num_outfiles)) / (done_s[-1] - done_s[0]) \
        if len(done_s) > 1 else None
    return {"files": num_outfiles, "seconds": seconds,
            "files_per_s": num_outfiles / max(seconds, 1e-9), "steady_files_per_s": steady,
            "batch_done_s": done_s,
            "card_ms_per_batch": float(np.mean(card_ms)) if card_ms else None,
            "card_ms_batches": card_ms, "signal_length": signal_length}


def _write_pairs(effect, name, all_outpaths, all_knobs_wc, start_output_i, x, y, b0, bend,
                 num_outfiles, log_every, sr):
    """Write the pairs b0 .. bend - 1 from x, y (their rows 0 .. bend - b0 - 1)."""
    for j, i in enumerate(range(b0, bend)):
        out_idx = start_output_i + i
        outpath = os.path.join(name, all_outpaths[i])
        knobs_str = "".join("__%s" % v for v in all_knobs_wc[i])
        fin = os.path.join(outpath, f"input_{out_idx}_.wav")
        ftg = os.path.join(outpath, f"target_{out_idx}_{effect.name}{knobs_str}.wav")
        if i % log_every == 0:
            print(f"outfile_i = {i}/{num_outfiles}, outpath = {outpath}, "
                  f"outfilename_input = {fin}, target = {ftg}")
        if x.dtype == np.int16:
            audio_io.write_audio_file(fin, x[j], sr)
            audio_io.write_audio_file(ftg, y[j], sr)
        else:
            audio_io.write_audio_file(fin, x[j].astype(np.float32), sr)
            audio_io.write_audio_file(ftg, y[j].astype(np.float32), sr)


if __name__ == "__main__":
    main()
