"""Dataset generator CLI: the flag surface of the JAX package's
cli/gen_dataset.py.

    python -m signaltrain_tpu_torch.cli.gen_dataset NAME [--dur 5] [-n 20000 | --sp S]
        [-e comp_4c] [--inpath DIR] [--device-batch 64] [--seed 1] [--pcm16]
        [--backend auto|device|host] [--workers N] [--device cuda]

Writes ``NAME/Train`` and ``NAME/Val`` pairs ``input_<i>_.wav`` /
``target_<i>_<Effect>__k1__k2....wav`` (the knob values in world coordinates,
4 significant figures, in the name), an 80/20 split, grid-spaced Train knobs
with ``--sp`` (``dsp.knobs.int2knobs``), random knobs otherwise from
``np.random.seed(seed)``, and ``NAME/effect_info.ini``; numbering continues
after the pairs already there. For the same arguments the names and the
``.ini`` are the JAX tool's, whatever the backend: the knobs are drawn before
it is chosen.

``--backend device`` runs on the CUDA card unless ``--device cpu`` is given.
A batch of ``--device-batch`` whole files is synthesized there from a
``torch.Generator`` seeded from (seed, first file): each clip of 4,096
samples from a synth branch drawn uniformly from (0, 1, 2, 4, 6, 7, 8, 9),
normalized where its peak exceeds 1, then the effect's ``go_batch`` over the
whole files (kernel C for the comp_4c family, L for comp) and, with
``--pcm16``, the rounding to int16, on the card. Batch i + 1 is dispatched
(its copy to pinned host memory included) before batch i is written.
``--inpath`` crops real audio on the host and applies the effect on the
device.

``--backend host`` never touches the card: batches of ``--device-batch``
files go to ``--workers`` spawned host processes (0: one a CPU core; 1: this
process, no pool), each with one intra-op thread. A worker synthesizes a
batch on the CPU from a generator seeded from (seed, first file), with
exactly even chooser coverage over the batch's clips and a random
permutation (``synths.stratified_synth_batch``, as the JAX host path), and
applies the C++ compressor (``utils/native.py``) to each file; ``--inpath``
crops with ``numpy.random.default_rng(seed + first file)``. The output does
not depend on the number of workers. ``--backend auto`` picks ``device``
when ``--device`` is the CPU; on the card it times a fresh 4 MB pull to the
host and picks ``host`` below 100 MB/s, printing the rate and the choice.
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
                        help="'device' synthesizes and applies the effect in batches on "
                        "--device; 'host' runs the synthesis and the C++ compressors in a pool "
                        "of host processes; 'auto' times a pull from the device and picks")
    parser.add_argument("--workers", type=int, default=0,
                        help="host-backend worker processes (0 = cpu count)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch path (the host "
                        "backend uses none)")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..utils.device import resolve_device

    if args.backend != "host":
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
    dev = torch.device("cpu") if args.backend == "host" else resolve_device(args.device)
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
    if resolve_backend(args.backend, dev) == "host":
        return gen_host_data(args, name, all_outpaths, all_knobs_wc, all_inputs_from_file,
                             start_output_i, num_clips, signal_length, num_outfiles)
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
            "card_ms_batches": card_ms, "signal_length": signal_length, "backend": "device"}


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


# ---- the host backend: synthesis and the C++ compressors in host processes

def resolve_backend(backend: str, dev: torch.device) -> str:
    """``auto``: ``device`` on the CPU; on the card ``host`` when a fresh
    4 MB pull to the host runs below 100 MB/s, else ``device``."""
    if backend != "auto":
        return backend
    if dev.type == "cpu":
        return "device"
    a = torch.zeros(1 << 20, dtype=torch.float32, device=dev)  # 4 MB
    (a + 0.0).cpu()  # warm
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    (a + 1.0).cpu()  # a fresh buffer: a real pull
    rate = a.numel() * 4 / max(1e-9, time.perf_counter() - t0)
    picked = "host" if rate < 100e6 else "device"
    print(f"gen_dataset auto backend: device->host pull {rate / 1e6:.0f} MB/s -> {picked}")
    return picked


def host_effect_fn(effect, sr: int):
    """fn(x, knobs_wc) -> y, the C++ compressor of ``effect`` on one file
    (None for an effect without one)."""
    from ..utils import native

    name = effect.name
    if name == "Compressor":
        return lambda x, kw: native.compressor_3knob(x, float(kw[0]), float(kw[1]), float(kw[2]),
                                                     sr=sr)
    if name in ("Compressor_4c", "Compressor_4c_Large", "Compressor_4c_OneSetting"):
        return lambda x, kw: native.compressor_4controls(
            x, float(kw[0]), float(kw[1]), float(kw[2]), float(kw[3]), sr=sr)
    if name == "Comp_Just_Thresh":
        return lambda x, kw: native.compressor_4controls(
            x, float(kw[0]), effect.ratio, effect.attack, effect.release, sr=sr)
    return None


class HostGen:
    """One process's generator: CPU synthesis and the C++ effect, writing
    the pairs of a range of files (``run_range``)."""

    def __init__(self, payload: dict):
        from ..dsp import effects as fx

        self.p = payload
        self.effect = fx.make_effect(payload["effect_cli"], sr=payload["sr"], device="cpu")
        self.effect_fn = host_effect_fn(self.effect, payload["sr"])
        if self.effect_fn is None:
            raise ValueError(f"{self.effect.name} has no host compressor")
        self.t = torch.arange(CLIP_LENGTH, dtype=torch.float32) / payload["sr"]
        self.g = torch.Generator()

    def synth(self, b0: int) -> np.ndarray:
        """(device_batch, signal_length) inputs of the batch that starts at
        file b0: the clips of the whole batch with exactly even chooser
        coverage and a random permutation, each divided by its peak where
        that exceeds 1."""
        from ..data import synth_data
        from ..dsp import synths

        p = self.p
        synth_data.step_generator(self.g, p["seed"], b0)
        x = synths.stratified_synth_batch(self.g, self.t, CHOOSERS, p["db"] * p["num_clips"])
        m = torch.amax(torch.abs(x), dim=1, keepdim=True)
        x = torch.where(m > 1.0, x / m, x)
        return x.reshape(p["db"], p["signal_length"]).numpy()

    def crop(self, b0: int, bend: int) -> np.ndarray:
        """The input files of b0 .. bend - 1, each cropped at a start drawn
        from ``default_rng(seed + b0)`` (zero-padded where shorter)."""
        p = self.p
        rng = np.random.default_rng(p["seed"] + b0)
        x = np.zeros((bend - b0, p["signal_length"]), np.float32)
        for j, i in enumerate(range(b0, bend)):
            sig, _ = audio_io.read_audio_file(p["infiles"][i], sr=p["sr"], warn=False)
            if p["signal_length"] >= len(sig):
                x[j, : len(sig)] = sig
            else:
                ri = int(rng.integers(0, len(sig) - p["signal_length"]))
                x[j] = sig[ri : ri + p["signal_length"]]
        return x

    def run_range(self, task: tuple[int, int]) -> int:
        b0, bend = task
        p = self.p
        x = self.synth(b0)[: bend - b0] if p["synth"] else self.crop(b0, bend)
        y = np.stack([self.effect_fn(x[j], p["knobs_wc"][b0 + j]) for j in range(bend - b0)])
        if p["pcm16"]:
            x, y = audio_io.to_pcm16(x), audio_io.to_pcm16(y)
        _write_pairs(self.effect, p["name"], p["outpaths"], p["knobs_wc"], p["start_output_i"],
                     x, y, b0, bend, p["num_outfiles"], LOG_EVERY, p["sr"])
        return bend - b0


_HOST_GEN: HostGen | None = None


def _worker_init(payload: dict) -> None:
    # one intra-op thread a worker: N workers with every core's threads each
    # would oversubscribe the host
    global _HOST_GEN
    torch.set_num_threads(1)
    _HOST_GEN = HostGen(payload)


def _worker_run(task: tuple[int, int]) -> int:
    return _HOST_GEN.run_range(task)


def gen_host_data(args, name, all_outpaths, all_knobs_wc, all_inputs_from_file, start_output_i,
                  num_clips, signal_length, num_outfiles) -> dict:
    """Write the pairs with the host backend; returns the run's counts and
    times, as ``gen_synth_data`` does (no card times)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from ..utils import native

    native.build()  # once, here: the workers then only load it
    payload = dict(effect_cli=args.effect, sr=args.sr, seed=args.seed, pcm16=args.pcm16,
                   num_clips=num_clips, signal_length=signal_length, db=args.device_batch,
                   synth=all_inputs_from_file[0] is None if all_inputs_from_file else True,
                   name=name, outpaths=all_outpaths, knobs_wc=all_knobs_wc,
                   infiles=all_inputs_from_file, start_output_i=start_output_i,
                   num_outfiles=num_outfiles)
    tasks = [(b0, min(b0 + args.device_batch, num_outfiles))
             for b0 in range(0, num_outfiles, args.device_batch)]
    workers = args.workers or os.cpu_count() or 1
    t0 = time.perf_counter()
    if workers <= 1:
        gen = HostGen(payload)
        done = sum(gen.run_range(task) for task in tasks)
    else:
        # a worker that fails, or dies, fails the run (BrokenProcessPool
        # where it dies before its first task) instead of being replaced
        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                                 initializer=_worker_init, initargs=(payload,)) as pool:
            done = sum(pool.map(_worker_run, tasks))
    seconds = time.perf_counter() - t0
    print(f"host backend: {done} file pairs in {seconds:.1f} s "
          f"({done / max(seconds, 1e-9):.1f} files/s, {workers} worker(s))")
    return {"files": done, "seconds": seconds, "files_per_s": done / max(seconds, 1e-9),
            "steady_files_per_s": None, "batch_done_s": [], "card_ms_per_batch": None,
            "card_ms_batches": [], "signal_length": signal_length, "backend": "host",
            "workers": workers}


if __name__ == "__main__":
    main()
