"""Reference-API facade: ``import signaltrain_tpu_torch as st; st.audio.<name>``
mirrors the reference's ``signaltrain.audio`` surface (audio.py), with the
public names of the JAX package's facade, so user code ports with an import
swap.

Key-less random functions (the reference draws from numpy's global state)
draw from a module-level ``torch.Generator`` a device, which ``seed(s)``
reseeds; for reproducible pipelines pass a generator to the ``dsp`` functions
instead. Like every entry point of the port they run on the card unless
given ``device="cpu"``, and they take and return numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.audio_io import read_audio_file, readaudio_generator, write_audio_file  # noqa: F401
from .dsp import synths as _synths
from .dsp.compressors import (  # noqa: F401
    compressor, compressor_4controls, echo, mu_compand, mu_decompand,
)
from .dsp.effects import (  # noqa: F401
    EFFECTS, Comp_Just_Thresh, Compressor, Compressor_4c, Compressor_4c_Large,
    Compressor_4c_OneSetting, DeCompressor_4c, Denoise, Echo, Effect, FileEffect, LowPass,
    PitchShifter, TimeAlign, make_effect,
)
from .dsp.knobs import int2knobs  # noqa: F401
from .ops import framing as _framing
from .utils.device import resolve_device as _resolve_device

_GENERATORS: dict[torch.device, torch.Generator] = {}


def seed(s: int, device: str | torch.device = "cuda") -> None:
    """Seed the facade's generator on ``device`` (np.random.seed's counterpart)."""
    dev = _resolve_device(device)
    _GENERATORS[dev] = torch.Generator(device=dev).manual_seed(int(s))


def _generator(device) -> torch.Generator:
    dev = _resolve_device(device)
    if dev not in _GENERATORS:
        seed(np.random.randint(0, 2**31 - 1), dev)
    return _GENERATORS[dev]


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=_resolve_device(device))


def random_ends(size=1, device: str | torch.device = "cuda") -> np.ndarray:
    """Beta(0.8, 0.8) draws (audio.py:20-21)."""
    return _synths.random_ends(_generator(device), int(size)).cpu().numpy()


def sliding_window(x, size, overlap=0, device: str | torch.device = "cuda") -> np.ndarray:
    """Strided windowing with a zero-padded tail (audio.py:23-49)."""
    return _framing.sliding_window(_tensor(x, device), size, overlap).cpu().numpy()


def undo_sliding_window(x, overlap, flatsize=None,
                        device: str | torch.device = "cuda") -> np.ndarray:
    """The inverse of ``sliding_window`` (audio.py:61-73)."""
    return _framing.undo_sliding_window(_tensor(x, device), overlap, flatsize).cpu().numpy()


def synth_input_sample(t, chooser=None, t0_fac=None,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """One signal of the 12-way synthetic chooser (audio.py:296-334); t may
    be numpy. Without ``chooser`` one of 0..10 is drawn, as the reference
    draws it."""
    g = _generator(device)
    if chooser is None:
        chooser = int(torch.randint(0, 11, (), generator=g, device=g.device))
    t = _tensor(t, device).to(torch.float32)
    return _synths.synth_input_sample(g, t, int(chooser), 1, t0_fac=t0_fac)[0].cpu().numpy()


def pinknoise(n, device: str | torch.device = "cuda") -> np.ndarray:
    """1/f noise of n (even) samples, peak-normalized (audio.py:85-94)."""
    g = _generator(device)
    return _synths.pinknoise(int(n), _synths.draw_pinknoise(g, 1, int(n)))[0].cpu().numpy()


def normish(y, amp_range=None, device: str | torch.device = "cuda") -> np.ndarray:
    """y normalized, then rescaled to a random amplitude in amp_range
    ((0.6, 0.9) by default; audio.py:75-81)."""
    amp_range = (0.6, 0.9) if amp_range is None else tuple(amp_range)
    g = _generator(device)
    y = _tensor(y, device).to(torch.float32)[None]
    u = torch.rand(1, generator=g, device=g.device)
    return _synths.normish(y, u, amp_range)[0].cpu().numpy()


def my_clip_min(x, clip_min):
    """np.clip(min) stand-in (audio.py:373-378)."""
    return np.maximum(x, clip_min)
