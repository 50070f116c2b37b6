"""Audio effect "plugins": knob-conditioned signal transforms.

Counterparts of signaltrain_tpu/dsp/effects.py, every synthesized effect of
the JAX package. Each effect declares knob_names / knob_ranges
(world-coordinate min/max) / is_inverse and computes ``(y, x)``: the target
and the network's input (swapped for the inverse effects, whose target is
the clean signal). Every effect runs natively batched in ``_apply(x (B, N),
knobs_wc (B, K), generator)``, one call over the whole batch (the training
step, captured in a CUDA graph, would otherwise hold one set of kernels a
row):

* ``go_batch(x, knobs_nn, generator)``: x (B, N), normalized knobs (B, K);
* ``go_wc(x, knobs_wc, generator)``: x (N,) or (B, N), world knobs (K,)
  shared by every row or (B, K); on one row it is ``go_batch`` on a batch
  of one;
* ``go(x, knobs_nn, generator)``: ``go_wc`` after the knob scaling.

``generator`` (a ``torch.Generator`` on x's device) is the counterpart of
the JAX ``key``: Denoise and TimeAlign draw their noise, chooser, shift and
re-synthesis from it and raise without one, as the JAX effects raise without
a key; the other effects draw nothing. Two JAX quirks are kept:
``DeCompressor_4c`` computes its alphas at 44,100 Hz whatever its ``sr``
(the JAX effect does not pass ``sr`` on), and ``Echo`` rounds its delay and
masks its echoes against ``max_echoes = ceil(knob_ranges[2, 1])``.

Tensors are processed on their own device; numpy input goes to the effect's
``device`` (default ``"cuda"``). ``make_effect`` builds every name the JAX
package registers; ``files`` is ``FileEffect``, the knob metadata of a
dataset directory (``effect_info.ini``), whose audio comes from its files.
"""

from __future__ import annotations

import ast
import configparser
import glob
import math
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from . import compressors, iir, pitch, synths


class Effect:
    """Generic effect super-class. ``draws``: whether ``_apply`` draws from
    its generator."""

    draws = False

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        self.name = "Generic Effect"
        self.knob_names = ["knob"]
        self.knob_ranges = np.array([[0.0, 1.0]], dtype=np.float32)
        self.sr = sr
        self.is_inverse = False
        self.device = resolve_device(device)
        self._ranges_on: dict = {}  # knob_ranges on each device (fixed after __init__)

    @property
    def num_knobs(self) -> int:
        return len(self.knob_names)

    def info(self) -> None:
        assert len(self.knob_names) == len(self.knob_ranges)
        print(f"Effect: {self.name}.  Knobs:")
        for i, kn in enumerate(self.knob_names):
            print(f"    {kn}: {self.knob_ranges[i][0]} to {self.knob_ranges[i][1]}")
        if self.is_inverse:
            print("    <<<< INVERSE EFFECT <<<<")

    def _tensor(self, a, device=None) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(dtype=torch.float32, device=device or a.device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device or self.device)

    def knob_ranges_on(self, device: torch.device) -> torch.Tensor:
        """``knob_ranges`` as a float32 (K, 2) tensor on ``device``, copied
        there once: the training step, captured in a CUDA graph, scales its
        knobs with no copy from the host."""
        device = torch.device(device)
        if device not in self._ranges_on:
            self._ranges_on[device] = torch.as_tensor(np.asarray(self.knob_ranges, np.float32),
                                                      device=device)
        return self._ranges_on[device]

    def knobs_wc(self, knobs_nn) -> torch.Tensor:
        """Normalized [-0.5, 0.5] -> world coordinates; (K,) or (B, K)."""
        knobs_nn = self._tensor(knobs_nn)
        kr = self.knob_ranges_on(knobs_nn.device)
        return kr[:, 0] + (knobs_nn + 0.5) * (kr[:, 1] - kr[:, 0])

    def _apply(self, x: torch.Tensor, wc: torch.Tensor, generator: torch.Generator | None):
        """(y, x) for x (B, N) and world knobs wc (B, K)."""
        raise NotImplementedError("This effect's _apply() is undefined")

    def go_wc(self, x, knobs_wc, generator: torch.Generator | None = None):
        """x (N,) or (B, N); knobs_wc (K,), shared by every row, or (B, K)."""
        x = self._tensor(x)
        rows = x[None] if x.dim() == 1 else x
        wc = self._tensor(knobs_wc, device=x.device)
        y, xo = self._apply(rows, wc.expand(rows.shape[0], -1) if wc.dim() == 1 else wc, generator)
        return (y[0], xo[0]) if x.dim() == 1 else (y, xo)

    def go(self, x, knobs_nn, generator: torch.Generator | None = None):
        """Main interface: normalized knobs."""
        return self.go_wc(x, self.knobs_wc(knobs_nn), generator)

    def go_batch(self, x, knobs_nn, generator: torch.Generator | None = None):
        """x (B, N), knobs_nn (B, K): one call over the whole batch."""
        x = self._tensor(x)
        return self._apply(x, self.knobs_wc(self._tensor(knobs_nn, device=x.device)), generator)


def _needs(generator, name: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{name} needs a torch.Generator (the JAX effect's PRNG key)")
    return generator


class Compressor(Effect):
    """3-knob compressor with a Butterworth envelope (kernel L on the card)."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Compressor"
        self.knob_names = ["threshold", "ratio", "attackreleaseTime"]
        self.knob_ranges = np.array([[-30, 0], [1, 5], [1e-3, 4e-2]], dtype=np.float32)

    def _apply(self, x, wc, generator):
        y = compressors.compressor(x, thresh=wc[:, 0], ratio=wc[:, 1], attackrel=wc[:, 2],
                                   sr=self.sr)
        return y, x


class Compressor_4c(Effect):
    """The flagship 4-knob compressor (kernel C on the card)."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Compressor_4c"
        self.knob_names = ["threshold", "ratio", "attackTime", "releaseTime"]
        self.knob_ranges = np.array(
            [[-30, 0], [1, 5], [1e-3, 4e-2], [1e-3, 4e-2]], dtype=np.float32
        )

    def _apply(self, x, wc, generator):
        y = compressors.compressor_4controls(
            x, thresh=wc[:, 0], ratio=wc[:, 1], attack_time=wc[:, 2], release_time=wc[:, 3],
            sr=self.sr,
        )
        return y, x


class Compressor_4c_Large(Compressor_4c):
    """Wider knob ranges: attack and release up to 1 s, so alpha near 1."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Compressor_4c_Large"
        self.knob_ranges = np.array(
            [[-50, 0], [1.5, 10], [1e-3, 1], [1e-3, 1]], dtype=np.float32
        )


class Comp_Just_Thresh(Effect):
    """1-knob compressor (ratio 3, attack 0.05 s, release 1 s)."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Comp_Just_Thresh"
        self.knob_names = ["threshold"]
        self.knob_ranges = np.array([[-50, -10]], dtype=np.float32)
        self.ratio = 3.0
        self.attack = 0.05
        self.release = 1.0

    def _apply(self, x, wc, generator):
        y = compressors.compressor_4controls(
            x, thresh=wc[:, 0], ratio=self.ratio, attack_time=self.attack,
            release_time=self.release, sr=self.sr,
        )
        return y, x


class Compressor_4c_OneSetting(Compressor_4c):
    """The 4-knob compressor locked to one setting."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Compressor_4c_OneSetting"
        self.knob_ranges = np.array(
            [[-25.001, -25.0], [4, 4.001], [5e-3, 5.001e-3], [2e-2, 2.001e-2]],
            dtype=np.float32,
        )


class Echo(Effect):
    """Delay/echo: the delay rounded to whole samples, at most
    ceil(knob_ranges[2, 1]) echoes."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Echo"
        self.knob_names = ["delay_samples", "ratio", "echoes"]
        self.knob_ranges = np.array([[400, 400], [0.4, 1.0], [2, 2]], dtype=np.float32)

    def _apply(self, x, wc, generator):
        y = compressors.echo(x, delay_samples=torch.round(wc[:, 0]), ratio=wc[:, 1],
                             echoes=wc[:, 2],
                             max_echoes=int(math.ceil(float(self.knob_ranges[2, 1]))))
        return y, x


class PitchShifter(Effect):
    """Semitone pitch shift by resampling and a phase vocoder."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "PitchShifter"
        self.knob_names = ["n_steps"]
        self.knob_ranges = np.array([[-12, 12]], dtype=np.float32)

    def _apply(self, x, wc, generator):
        return pitch.pitch_shift(x, self.sr, wc[:, 0]), x


def denoise_pair(x: torch.Tensor, strength: torch.Tensor, u: torch.Tensor):
    """Denoise's deterministic part: (x, x + strength * (2u - 1)) for
    uniforms u of x's shape and a (B,) strength."""
    return x, x + strength[:, None] * (2.0 * u - 1.0)


class Denoise(Effect):
    """Adds uniform noise of the knob's strength to the input; the target is
    the clean signal."""

    draws = True

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Denoise"
        self.knob_names = ["strength"]
        self.knob_ranges = np.array([[0.0, 0.5]], dtype=np.float32)
        self.is_inverse = True

    def _apply(self, x, wc, generator):
        g = _needs(generator, "Denoise")
        return denoise_pair(x, wc[:, 0], torch.rand(x.shape, generator=g, device=g.device))


class DeCompressor_4c(Effect):
    """Inverse compressor: the input is compressed, the target the original.
    Its alphas use 44,100 Hz whatever ``sr`` is (the JAX effect's)."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        sub = Compressor_4c(sr, device)
        self.name = "DeCompressor_4c"
        self.knob_names = sub.knob_names
        self.knob_ranges = sub.knob_ranges
        self.is_inverse = True

    def _apply(self, x, wc, generator):
        y = compressors.compressor_4controls(
            x, thresh=wc[:, 0], ratio=wc[:, 1], attack_time=wc[:, 2], release_time=wc[:, 3],
        )
        return x, y  # swapped


TIMEALIGN_CHOOSERS = (2, 4, 6, 7)


def timealign_pair(t: torch.Tensor, choosers: torch.Tensor, draws: dict, sign: torch.Tensor,
                   eps_u: torch.Tensor, strength: torch.Tensor, u_shift: torch.Tensor):
    """TimeAlign's deterministic part for a batch: each row re-synthesized
    by its chooser's branch (one of TIMEALIGN_CHOOSERS, all four computed for
    the batch and selected by row) with its onset at the clip's middle, then
    finished; the input is that row shifted by int(N * strength * (2u - 1))
    samples (truncated toward zero), zero-filled. draws: each chooser's
    draws for the whole batch. Returns (y, x_shift)."""
    n = t.shape[0]
    y = torch.zeros((choosers.shape[0], n), dtype=t.dtype, device=t.device)
    for c in TIMEALIGN_CHOOSERS:
        y = torch.where((choosers == c)[:, None], synths.branch(c, t, draws[c], t0_fac=0.5), y)
    y = synths._finish(y, sign, eps_u)
    shift = (n * strength * (2.0 * u_shift - 1.0)).to(torch.int64)
    idx = torch.arange(n, device=t.device) - shift[:, None]
    inside = (idx >= 0) & (idx < n)
    zero = torch.zeros((), device=t.device)
    x_shift = torch.where(inside, torch.gather(y, 1, idx.clamp(0, n - 1)), zero)
    return y, x_shift


class TimeAlign(Effect):
    """Ignores x: re-synthesizes a signal with its onset at the middle and
    gives a randomly shifted copy as the input."""

    draws = True

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "TimeAlign"
        self.knob_names = ["strength"]
        self.knob_ranges = np.array([[0.001, 0.5]], dtype=np.float32)
        self.is_inverse = True

    def _apply(self, x, wc, generator):
        g = _needs(generator, "TimeAlign")
        bsz, n = x.shape
        t = torch.arange(n, dtype=torch.float32, device=x.device) / self.sr
        choosers = synths.choose_from(g, TIMEALIGN_CHOOSERS, bsz)
        draws = {c: synths.draw_branch(c, g, bsz, n) for c in TIMEALIGN_CHOOSERS}
        sign = synths._sign(g, bsz)
        eps_u = synths._u(g, bsz, n)
        u_shift = synths._u(g, bsz)
        return timealign_pair(t, choosers, draws, sign, eps_u, wc[:, 0], u_shift)


class LowPass(Effect):
    """3rd-order Butterworth low-pass (kernel L on the card)."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "LowPass"
        self.knob_names = ["cutoff"]
        self.knob_ranges = np.array([[10, 2000]], dtype=np.float32)

    def _apply(self, x, wc, generator):
        b, a = iir.butter_lowpass(3, wc[:, 0] / (0.5 * self.sr))
        return iir.lfilter(b, a, x), x


class FileEffect(Effect):
    """The metadata of a pre-recorded file dataset: ``<path>/effect_info.ini``
    (the effect's name, ``knob_names`` and ``knob_ranges`` as Python
    literals, an optional ``inverse`` flag) beside ``Train/`` and ``Val/``
    directories of ``target_*`` files. Its name is the ini's plus
    "(files)", "De-" before it when ``inverse`` is set to any non-empty
    value. It has no signal path: the targets are the files."""

    def __init__(self, path: str, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        print("  FileEffect: path = ", path)
        if (
            (path is None)
            or (not glob.glob(os.path.join(path, "Train", "target*")))
            or (not glob.glob(os.path.join(path, "Val", "target*")))
            or (not glob.glob(os.path.join(path, "effect_info.ini")))
        ):
            raise FileNotFoundError(
                f"can't find target output files or effect_info.ini in path = {path}"
            )
        config = configparser.ConfigParser()
        config.read(os.path.join(path, "effect_info.ini"))
        self.name = config["effect"]["name"] + "(files)"
        self.knob_names = ast.literal_eval(config.get("effect", "knob_names"))
        self.knob_ranges = np.array(ast.literal_eval(config.get("effect", "knob_ranges")),
                                    dtype=np.float32)
        try:
            if bool(config["effect"]["inverse"]):
                self.is_inverse = True
                self.name = "De-" + self.name
        except KeyError:
            pass

    def _apply(self, x, wc, generator):
        raise NotImplementedError(
            f"{self.name} has no signal path: a file dataset's targets are its files")


# The effect names the CLIs accept ("files" is FileEffect, built from a path)
EFFECTS = {
    "comp": Compressor,
    "comp_4c": Compressor_4c,
    "comp_4c_large": Compressor_4c_Large,
    "comp_large": Compressor_4c_Large,
    "comp_t": Comp_Just_Thresh,
    "comp_one": Compressor_4c_OneSetting,
    "echo": Echo,
    "pitch": PitchShifter,
    "denoise": Denoise,
    "decomp_4c": DeCompressor_4c,
    "timealign": TimeAlign,
    "lowpass": LowPass,
}


def make_effect(name: str, path: str | None = None, sr: float = 44100.0,
                device: str | torch.device = "cuda") -> Effect:
    """Construct an effect by CLI name; ``files`` reads ``path``'s
    ``effect_info.ini`` (``FileEffect``)."""
    if name == "files":
        return FileEffect(path, sr=sr, device=device)
    if name not in EFFECTS:
        raise ValueError(f"Effect option '{name}' is not yet added")
    return EFFECTS[name](sr=sr, device=device)
