"""Long-audio inference CLI (the port of cli/predict_long.py).

Loads a .tar checkpoint, runs windowed inference on a wav file on the chosen
device, builds the streamed and chunked effect targets for comparison when
the effect's name contains "comp" (the JAX CLI's rule: the compressors and
decomp_4c; the random effects need a generator) or reads it from a file
dataset with ``-e files`` (the ``target_<i>_*`` file beside an
``input_<i>_`` file, its knob values from its name), and writes pl_input /
pl_pred / pl_st / pl_ct wavs tagged with the knob values into the working
directory, the prediction zero-padded at the head so it aligns with the
input.

    python -m signaltrain_tpu_torch.cli.predict_long ckpt.tar clip.wav \
        -e comp_4c --knobs=-25,4,0.005,0.02 [--device cuda]
"""

from __future__ import annotations

import argparse
import glob

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Runs NN inference on long audio clip",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("checkpoint", help="Name of model checkpoint .tar file")
    parser.add_argument("audiofile", help="Name of audio file to read")
    parser.add_argument("-e", "--effect", help="Name of effect class for generating target",
                        default="")
    parser.add_argument("--knobs", help="String of knob/control settings", default="")
    parser.add_argument("-c", "--compand", help="Turn on to use companded/decompanded audio",
                        action="store_true")
    parser.add_argument("--pcm16", help="write 16-bit PCM output wavs; the prediction is "
                        "converted on the device", action="store_true")
    parser.add_argument("--device", help="torch device to run on ('cpu' runs the plain "
                        "PyTorch versions of the kernels)", default="cuda")
    args = parser.parse_args(argv)
    print("args =", args)

    from ..data import audio_io
    from ..data.file_data import parse_knob_string
    from ..dsp import effects as fx
    from ..dsp.knobs import knobs_nn_from_wc
    from ..dsp.compressors import mu_decompand
    from ..inference import predict_long as pl
    from ..utils.load_model import load_model

    print("Looking for checkpoint at", args.checkpoint)
    model, rv = load_model(args.checkpoint, device=args.device)
    knob_names, knob_ranges = rv["knob_names"], np.asarray(rv["knob_ranges"])
    num_knobs = len(knob_names)
    sr = rv["sr"]
    print(f"Effect name = {rv.get('effect_name', '?')}")
    print(f"knob_names = {knob_names}")
    print(f"knob_ranges = {knob_ranges}")
    chunk_size = model.spec.in_chunk_size
    out_chunk_size = model.spec.out_chunk_size
    print("out_chunk_size = ", out_chunk_size)

    infile = args.audiofile
    print("reading input file ", infile)
    signal, sr = audio_io.read_audio_file(infile, sr=sr)
    print("signal.shape = ", signal.shape)

    kr = knob_ranges
    if args.knobs == "":
        knobs_nn = np.zeros(num_knobs, np.float32)
        knobs_wc = np.array([(kr[i, 0] + kr[i, 1]) / 2 for i in range(num_knobs)])
    else:
        knobs_wc = np.array([float(v) for v in args.knobs.split(",")], np.float32)
        knobs_nn = knobs_nn_from_wc(knobs_wc, kr)
    print("knobs_wc  =", knobs_wc)
    print("knobs_nn  =", knobs_nn)

    y_st = y_ct = None
    if args.effect == "files":
        # the target beside the input (input_<i>_.wav -> target_<i>_*), its
        # knobs read from its name; they only tag the output files, as in
        # the JAX CLI (the prediction runs at --knobs)
        target_file = infile.replace("input", "target").replace(".wav", "")
        target_file = glob.glob(target_file + "*")[0]
        print(" Reading target_file = ", target_file)
        y_st, _ = audio_io.read_audio_file(target_file)
        knobs_wc = parse_knob_string(target_file)
        print("inferred knobs_wc = ", knobs_wc)
    elif args.effect != "":
        try:
            effect = fx.make_effect(args.effect, sr=sr, device=model.device)
        except ValueError:
            print("WARNING: That effect not implemented yet. Skipping target generation.")
        else:
            if "comp" in args.effect:
                y_st, _ = effect.go_wc(signal, knobs_wc)
                y_st = y_st.cpu().numpy()
                y_ct = pl.calc_ct(signal, effect, knobs_wc, out_chunk_size, chunk_size)

    pull_int16 = args.pcm16 and not args.compand
    print("\nCalling predict_long()...")
    y_pred = pl.predict_long(
        signal, knobs_nn, model, chunk_size, out_chunk_size, compand=args.compand,
        out_dtype="int16" if pull_int16 else None,
    )
    print("\n...Back. Output: y_pred.shape = ", y_pred.shape)
    if y_st is not None:
        print("y_st.shape = ", y_st.shape)
        print("diff in lengths = ", len(y_st) - len(y_pred))

    def maybe_pcm16(a):
        if not args.pcm16 or a.dtype == np.int16:
            return a
        return audio_io.to_pcm16(a)

    # zero-pad the head to align with the input and the targets
    y_out = np.zeros(len(signal), dtype=y_pred.dtype)
    y_out[-len(y_pred):] = y_pred
    if args.compand:
        print("De-companding outputs")
        import torch

        signal = mu_decompand(torch.from_numpy(signal)).numpy()
        y_out = mu_decompand(torch.from_numpy(y_out)).numpy()

    tagstr = "".join("__" + str(k) for k in knobs_wc)
    audio_io.write_audio_file("pl_input" + tagstr + ".wav", maybe_pcm16(signal), sr=44100)
    if y_st is not None:
        audio_io.write_audio_file("pl_st" + tagstr + ".wav", maybe_pcm16(y_st), sr=44100)
    if y_ct is not None:
        audio_io.write_audio_file("pl_ct" + tagstr + ".wav", maybe_pcm16(y_ct), sr=44100)
    audio_io.write_audio_file("pl_pred" + tagstr + ".wav", maybe_pcm16(y_out), sr=44100)
    print("Finished.")


if __name__ == "__main__":
    main()
