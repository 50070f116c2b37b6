"""Model geometry and the model-construction call.

Counterpart of signaltrain_tpu/models/st_model.py (the reference's st_model,
nn_proc.py:344-385):

    chunk_size      = int(8192 * scale_factor)
    out_chunk_size  = int(chunk_size / shrink_factor)
    ft, hop         = 1024, 384        ('lean' scheme: fixed; the legacy
                                        scheme scales both by scale_factor)
    T   = ceil(chunk/hop) + ceil(ft/hop)
    OT  = ceil(out_chunk/hop) + ceil(ft/hop)
    out_chunk_size  = (OT-1)*hop - ft   (re-derived; warns when it differs)

At defaults: 8192 -> 2048 samples, T=25, OT=9, 513 bins, ~4.2M params. The
port serves and trains in float32 only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .mpaec import AsymMPAEC


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static geometry and metadata of one model; the run values bundled
    into reference checkpoints."""

    scale_factor: float = 1.0
    shrink_factor: float = 4.0
    num_knobs: int = 4
    sr: int = 44100
    scale_scheme: str = "lean"
    in_chunk_size: int = 8192
    out_chunk_size: int = 2048
    ft_size: int = 1024
    hop_size: int = 384
    time_frames: int = 25
    output_time_frames: int = 9


def compute_spec(scale_factor: float = 1.0, shrink_factor: float = 4.0, num_knobs: int = 4,
                 sr: int = 44100, scale_scheme: str = "lean") -> ModelSpec:
    chunk_size = int(8192 * scale_factor)
    out_chunk_size = int(chunk_size / shrink_factor)

    ft_size, hop_size = 1024, 384
    if scale_scheme != "lean":  # legacy O(N^2) scaling
        ft_size = int(ft_size * scale_factor)
        hop_size = int(hop_size * scale_factor)

    t = int(math.ceil(chunk_size / float(hop_size)) + math.ceil(ft_size / float(hop_size)))
    ot = int(math.ceil(out_chunk_size / float(hop_size)) + math.ceil(ft_size / float(hop_size)))
    y_size = (ot - 1) * hop_size - ft_size
    if y_size != out_chunk_size:
        print(
            f"Warning: y_size ({y_size}) should equal out_chunk_size ({out_chunk_size})\n"
            f"    Setting out_chunk_size = y_size = {y_size}"
        )
    return ModelSpec(
        scale_factor=scale_factor,
        shrink_factor=shrink_factor,
        num_knobs=num_knobs,
        sr=sr,
        scale_scheme=scale_scheme,
        in_chunk_size=chunk_size,
        out_chunk_size=y_size,
        ft_size=ft_size,
        hop_size=hop_size,
        time_frames=t,
        output_time_frames=ot,
    )


class STModel(nn.Module):
    """The model with its geometry. Its parameters sit under ``mpaec.``, the
    prefix of the reference's checkpoint keys."""

    def __init__(self, spec: ModelSpec, frontend: str = "fused",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.mpaec = AsymMPAEC(
            expected_time_frames=spec.time_frames,
            ft_size=spec.ft_size,
            hop_size=spec.hop_size,
            n_knobs=spec.num_knobs,
            output_tf=spec.output_time_frames,
            frontend=frontend,
            device=resolve_device(device),
            generator=generator,
        )

    @property
    def device(self) -> torch.device:
        return self.mpaec.dft_analysis.conv_analysis_real.weight.device

    def forward(self, x: torch.Tensor, knobs: torch.Tensor):
        return self.mpaec(x, knobs)


def st_model(scale_factor: float = 1.0, shrink_factor: float = 4.0, num_knobs: int = 4,
             sr: int = 44100, scale_scheme: str = "lean", device: str | torch.device = "cuda",
             generator: torch.Generator | None = None) -> STModel:
    """The model with the geometry ``compute_spec`` derives, fused front-end."""
    spec = compute_spec(scale_factor, shrink_factor, num_knobs, sr, scale_scheme)
    return STModel(spec, device=device, generator=generator)
