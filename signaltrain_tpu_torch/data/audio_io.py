"""Audio file I/O.

Counterpart of signaltrain_tpu/data/audio_io.py, host-side numpy throughout:

1. .wav through scipy's wavfile reader and writer, integer PCM scaled to
   float in [-1, 1];
2. .aif/.aiff/.aifc through a native AIFF/AIFC parser (IFF chunks,
   big-endian PCM, the little-endian 'sowt' AIFC variant, the 80-bit
   extended-float sample rate);
3. anything else through an ffmpeg subprocess when an ffmpeg binary is on
   PATH (float32 PCM over a pipe, the channel count from ffprobe);
4. otherwise a ``ValueError`` naming what this install can read.

Mono takes the first channel; a file at another rate is resampled by
polyphase Kaiser-windowed resampling. ``to_pcm16`` quantizes numpy arrays
and tensors on any device the same way.
"""

from __future__ import annotations

import glob
import math
import os
import shutil
import struct
import subprocess
import warnings

import numpy as np
import torch

# scipy is imported in the functions that use it: it takes seconds to import,
# and every spawned data-parallel rank imports this module


def _float80(b: bytes) -> float:
    """IEEE 754 extended 80-bit float (the AIFF COMM sample rate)."""
    (se,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:10])
    sign = -1.0 if se & 0x8000 else 1.0
    exp = se & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _read_aiff(filename: str):
    """Native AIFF / AIFF-C reader -> (float32 samples (frames, ch), rate).
    Handles 8/16/24/32-bit PCM, big-endian ('NONE') and the little-endian
    AIFC variant ('sowt')."""
    with open(filename, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{filename}: not an AIFF/AIFC file")
    pos, end = 12, 4 + 4 + struct.unpack(">I", data[4:8])[0]
    comm = ssnd = None
    while pos + 8 <= min(end, len(data)):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if comm is None or ssnd is None:
        raise ValueError(f"{filename}: missing COMM/SSND chunk")

    n_ch, n_frames, bits = struct.unpack(">hIh", comm[:8])
    rate = _float80(comm[8:18])
    compression = comm[18:22] if len(comm) >= 22 else b"NONE"
    if compression not in (b"NONE", b"sowt"):
        raise ValueError(
            f"{filename}: unsupported AIFC compression {compression!r} "
            "(only uncompressed PCM is supported)"
        )
    offset, _blocksize = struct.unpack(">II", ssnd[:8])
    raw = ssnd[8 + offset :]

    nbytes = (bits + 7) // 8
    raw = raw[: n_frames * n_ch * nbytes]
    order = "<" if compression == b"sowt" else ">"
    if nbytes == 3:  # 24-bit: widen to int32 keeping the sign
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        if order == ">":
            a = a[:, ::-1]
        samples = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        samples = (samples << 8) >> 8  # sign-extend
        peak = float(2**23 - 1)
    else:
        dtype = {1: "i1", 2: f"{order}i2", 4: f"{order}i4"}[nbytes]
        samples = np.frombuffer(raw, dtype=np.dtype(dtype)).astype(np.int32)
        peak = float(2 ** (8 * nbytes - 1) - 1)
    signal = samples.astype(np.float32) / peak
    return signal.reshape(-1, n_ch), int(round(rate))


def _ffprobe_channels(filename: str) -> int | None:
    """Channel count of the first audio stream, via ffprobe; None if ffprobe
    is missing or the probe fails."""
    if not shutil.which("ffprobe"):
        return None
    proc = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0", "-show_entries",
         "stream=channels", "-of", "csv=p=0", filename],
        capture_output=True,
    )
    try:
        return int(proc.stdout.decode().strip()) if proc.returncode == 0 else None
    except ValueError:
        return None


def _read_via_ffmpeg(filename: str, sr: int, mono: bool):
    """Decode any format ffmpeg knows to float32 PCM over a pipe. Mono output
    stays 1-D; more channels are de-interleaved to (frames, ch), the count
    from ffprobe, or forced to 2 (``-ac 2``) when ffprobe is missing."""
    n_ch = 1 if mono else _ffprobe_channels(filename)
    cmd = ["ffmpeg", "-v", "error", "-i", filename, "-f", "f32le", "-acodec", "pcm_f32le",
           "-ar", str(int(sr))]
    if mono:
        cmd += ["-ac", "1"]
    elif n_ch is None:
        n_ch = 2
        cmd += ["-ac", "2"]
    cmd += ["-"]
    proc = subprocess.run(cmd, capture_output=True)
    if proc.returncode != 0:
        raise ValueError(
            f"ffmpeg failed to decode {filename}: {proc.stderr.decode(errors='replace')}"
        )
    signal = np.frombuffer(proc.stdout, dtype=np.float32)
    if n_ch > 1:
        signal = signal[: (len(signal) // n_ch) * n_ch].reshape(-1, n_ch)
    return signal, int(sr)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase Kaiser-windowed resampling."""
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = int(target_sr) // g, int(orig_sr) // g
    from scipy import signal as ssig

    return ssig.resample_poly(signal, up, down, window=("kaiser", 5.0))


def to_pcm16(a):
    """float [-1, 1] -> int16 by rounding (half to even), for numpy arrays and
    for tensors on any device."""
    if isinstance(a, torch.Tensor):
        return torch.round(torch.clamp(a, -1.0, 1.0) * 32767.0).to(torch.int16)
    return np.round(np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)


def read_audio_file(filename: str, sr: int = 44100, mono: bool = True, norm: bool = False,
                    dtype=np.float32, warn: bool = True, fix_and_overwrite: bool = False):
    """Read an audio file as float in [-1, 1] of ``dtype``, the first channel
    when ``mono``, resampled to ``sr`` if needed (printing so when ``warn``;
    with ``fix_and_overwrite`` a resampled file is written back at ``sr``),
    peak-normalized when ``norm``. Returns (signal, sr)."""
    might_overwrite = False
    ext = os.path.splitext(filename)[1].lower()
    if ext in (".wav", ".wave", ""):
        from scipy.io import wavfile

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            read_sr, signal = wavfile.read(filename)
    elif ext in (".aif", ".aiff", ".aifc"):
        signal, read_sr = _read_aiff(filename)
    elif shutil.which("ffmpeg"):
        signal, read_sr = _read_via_ffmpeg(filename, sr=sr, mono=mono)
    else:
        raise ValueError(
            f"Cannot read {filename}: this install decodes .wav and .aif/.aiff natively; "
            f"for {ext!r} put an ffmpeg binary on PATH"
        )

    if mono and signal.ndim > 1:
        signal = signal[:, 0]

    if signal.dtype == np.int16:
        signal = np.array(signal / 32767.0, dtype=dtype)
    elif signal.dtype == np.int32:
        signal = np.array(signal / 2147483647.0, dtype=dtype)
    elif signal.dtype == np.uint8:
        signal = np.array((signal.astype(np.float32) - 128.0) / 127.0, dtype=dtype)

    if read_sr != int(sr):
        if warn:
            print(f"read_audio_file: Got sample rate of {read_sr} Hz instead of {sr} Hz "
                  "requested. Resampling.")
        signal = resample(signal, read_sr, sr)
        might_overwrite = True

    if fix_and_overwrite and might_overwrite:
        print(f"    Overwriting {filename} (so we don't have to process as much again)")
        write_audio_file(filename, signal.astype(dtype, copy=False), sr)

    if signal.dtype != dtype:
        signal = signal.astype(dtype, copy=False)

    if norm:
        absmax = np.max(np.abs(signal))
        signal = signal / absmax if absmax > 0 else signal

    return signal, sr


def write_audio_file(filename: str, data, sr: int = 44100):
    """scipy wavfile write."""
    from scipy.io import wavfile

    wavfile.write(filename, sr, np.asarray(data))


def readaudio_generator(seq_size: int, path: str | None = None, sr: int = 44100,
                        random_every: bool = True, mono: bool = True, norm: bool = False):
    """Windows of ``seq_size`` samples from the wav files matching
    ``path + "*.wav"`` (default ``~/datasets/signaltrain/Val``), a random
    file and start from numpy's global generator: a random start every
    window, or consecutive windows with ``random_every=False``.
    ``send(True)`` switches to a new random file."""
    if path is None:
        path = os.path.expanduser("~") + "/datasets/signaltrain/Val"
    files = glob.glob(path + "*.wav")
    read_new_file = True
    start = -seq_size
    data = None
    while True:
        if read_new_file or data is None:
            filename = np.random.choice(files)
            data, sr = read_audio_file(filename, sr=sr, mono=mono, norm=norm)
            read_new_file = False
        if random_every:
            start = np.random.randint(0, data.shape[0] - seq_size)
        else:
            start += seq_size
        rc = yield data[start : start + seq_size]
        if isinstance(rc, bool):
            read_new_file = rc
