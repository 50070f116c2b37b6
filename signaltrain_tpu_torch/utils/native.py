"""ctypes bindings to the host compressors (``csrc/host/compressor_oracle.cpp``).

Counterpart of signaltrain_tpu/utils/native.py, over the port's own copy of
the C++ source. The library is built with ``g++ -O3 -shared -fPIC`` at first
use into ``build/host/`` at the repository root, and rebuilt when the source
is newer than it. The build writes a temporary file and renames it into
place, so processes that build at once never load a half-written library;
a caller that starts a pool of processes calls ``build()`` once before it.

These run on the host, in float64 with float32 outputs: the dataset tool's
host backend applies them to whole files, and the tests hold the plain
compressors and kernel C against them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "compressor_oracle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
LIBRARY = BUILD_DIR / "libcompressor_oracle.so"
_LIB = None


def build() -> Path:
    """Compile the library if it is missing or older than its source; its path."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{out.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIBRARY


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    d = ctypes.c_double
    lib.compressor_4controls.argtypes = [f32p, f32p, ctypes.c_int64, d, d, d, d, d]
    lib.compressor_3knob.argtypes = [f32p, f32p, ctypes.c_int64, d, d, d, d]
    lib.switched_one_pole.argtypes = [f32p, f32p, ctypes.c_int64, d, d]
    for f in (lib.compressor_4controls, lib.compressor_3knob, lib.switched_one_pole):
        f.restype = None
    _LIB = lib
    return lib


def compressor_4controls(x, thresh=-24.0, ratio=2.0, attack_time=0.01, release_time=0.01,
                         sr=44100.0) -> np.ndarray:
    """The 4-knob compressor on one 1-D float32 signal."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.compressor_4controls(x, y, x.size, thresh, ratio, attack_time, release_time, sr)
    return y


def compressor_3knob(x, thresh=-24.0, ratio=2.0, attackrel=0.045, sr=44100.0) -> np.ndarray:
    """The 3-knob compressor (butterworth dB envelope) on one 1-D signal."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.compressor_3knob(x, y, x.size, thresh, ratio, attackrel, sr)
    return y


def switched_one_pole(g, alpha_a, alpha_r) -> np.ndarray:
    """Kernel C's recursion alone, in float64, on one 1-D gain curve."""
    lib = _load()
    g = np.ascontiguousarray(g, np.float32)
    s = np.empty_like(g)
    lib.switched_one_pole(g, s, g.size, alpha_a, alpha_r)
    return s
