"""Audio effect "plugins": knob-conditioned signal transforms.

Counterparts of signaltrain_tpu/dsp/effects.py. Each effect declares
knob_names / knob_ranges (world-coordinate min/max) and implements
``go_wc(x, knobs_wc) -> (y, x)``; ``go()`` converts normalized [-0.5, 0.5]
knobs to world coordinates first; ``Compressor_4c.go_batch()`` runs a (B, N)
batch with per-example knobs in one call. The JAX effects' ``key`` argument
(for random effects) has no counterpart yet.

Tensors are processed on their own device; numpy input goes to the effect's
``device`` (default ``"cuda"``). Only ``comp_4c`` is ported so far: any other
name given to ``make_effect`` raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from . import compressors


class Effect:
    """Generic effect super-class."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        self.name = "Generic Effect"
        self.knob_names = ["knob"]
        self.knob_ranges = np.array([[0.0, 1.0]], dtype=np.float32)
        self.sr = sr
        self.device = resolve_device(device)

    @property
    def num_knobs(self) -> int:
        return len(self.knob_names)

    def info(self) -> None:
        assert len(self.knob_names) == len(self.knob_ranges)
        print(f"Effect: {self.name}.  Knobs:")
        for i, kn in enumerate(self.knob_names):
            print(f"    {kn}: {self.knob_ranges[i][0]} to {self.knob_ranges[i][1]}")

    def _tensor(self, a, device=None) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(dtype=torch.float32, device=device or a.device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device or self.device)

    def knobs_wc(self, knobs_nn) -> torch.Tensor:
        """Normalized [-0.5, 0.5] -> world coordinates; (K,) or (B, K)."""
        knobs_nn = self._tensor(knobs_nn)
        kr = torch.as_tensor(self.knob_ranges, dtype=torch.float32, device=knobs_nn.device)
        return kr[:, 0] + (knobs_nn + 0.5) * (kr[:, 1] - kr[:, 0])

    def go_wc(self, x, knobs_wc):
        raise NotImplementedError("This effect's go_wc() is undefined")

    def go(self, x, knobs_nn):
        """Main interface: normalized knobs."""
        return self.go_wc(x, self.knobs_wc(knobs_nn))


class Compressor_4c(Effect):
    """The flagship 4-knob compressor."""

    def __init__(self, sr: float = 44100.0, device: str | torch.device = "cuda"):
        super().__init__(sr, device)
        self.name = "Compressor_4c"
        self.knob_names = ["threshold", "ratio", "attackTime", "releaseTime"]
        self.knob_ranges = np.array(
            [[-30, 0], [1, 5], [1e-3, 4e-2], [1e-3, 4e-2]], dtype=np.float32
        )

    def go_wc(self, x, knobs_wc):
        """x (N,) or (B, N); knobs_wc (4,), shared by every row."""
        x = self._tensor(x)
        k = self._tensor(knobs_wc, device=x.device)
        y = compressors.compressor_4controls(
            x, thresh=k[0], ratio=k[1], attack_time=k[2], release_time=k[3], sr=self.sr
        )
        return y, x

    def go_batch(self, x, knobs_nn):
        """x (B, N), knobs_nn (B, K): one call over the whole batch."""
        x = self._tensor(x)
        wc = self.knobs_wc(self._tensor(knobs_nn, device=x.device))
        y = compressors.compressor_4controls(
            x, thresh=wc[:, 0], ratio=wc[:, 1], attack_time=wc[:, 2],
            release_time=wc[:, 3], sr=self.sr,
        )
        return y, x


# The effect names the CLIs accept; the others of the JAX package are not
# ported yet.
EFFECTS = {
    "comp_4c": Compressor_4c,
}


def make_effect(name: str, sr: float = 44100.0, device: str | torch.device = "cuda") -> Effect:
    """Construct an effect by CLI name."""
    if name not in EFFECTS:
        raise ValueError(f"Effect option '{name}' is not yet added")
    return EFFECTS[name](sr=sr, device=device)
