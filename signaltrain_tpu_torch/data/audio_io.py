"""Audio file I/O for the serving path.

Counterpart of the wav path of signaltrain_tpu/data/audio_io.py: scipy's
wavfile reader and writer, integer PCM scaled to float in [-1, 1], mono by
taking the first channel, and polyphase Kaiser resampling when the file's
rate differs. The JAX package's AIFF parser and ffmpeg decoding are not
ported yet; other extensions raise ``ValueError``.
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
from scipy import signal as ssig
from scipy.io import wavfile


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase Kaiser-windowed resampling."""
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = int(target_sr) // g, int(orig_sr) // g
    return ssig.resample_poly(signal, up, down, window=("kaiser", 5.0))


def to_pcm16(a):
    """float [-1, 1] -> int16 by rounding (half to even), for numpy arrays and
    for tensors on any device."""
    if isinstance(a, torch.Tensor):
        return torch.round(torch.clamp(a, -1.0, 1.0) * 32767.0).to(torch.int16)
    return np.round(np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)


def read_audio_file(filename: str, sr: int = 44100):
    """Read a wav file; convert to mono (the first channel) float32 in
    [-1, 1]; resample to sr if needed. Returns (signal, sr)."""
    ext = os.path.splitext(filename)[1].lower()
    if ext not in (".wav", ".wave", ""):
        raise ValueError(
            f"Cannot read {filename}: the port reads .wav only so far ({ext!r} "
            "needs the AIFF/ffmpeg readers, not ported yet)"
        )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        read_sr, signal = wavfile.read(filename)

    if signal.ndim > 1:
        signal = signal[:, 0]

    if signal.dtype == np.int16:
        signal = np.array(signal / 32767.0, dtype=np.float32)
    elif signal.dtype == np.int32:
        signal = np.array(signal / 2147483647.0, dtype=np.float32)
    elif signal.dtype == np.uint8:
        signal = np.array((signal.astype(np.float32) - 128.0) / 127.0, dtype=np.float32)

    if read_sr != int(sr):
        print(
            f"read_audio_file: Got sample rate of {read_sr} Hz instead of "
            f"{sr} Hz requested. Resampling."
        )
        signal = resample(signal, read_sr, sr)

    return signal.astype(np.float32, copy=False), sr


def write_audio_file(filename: str, data: np.ndarray, sr: int = 44100):
    """scipy wavfile write."""
    wavfile.write(filename, sr, np.asarray(data))
