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
model computes in ``compute_dtype`` (float32 or bfloat16; parameters are
float32 either way); ``dropout_rate`` goes to both autoencoders. With
``mesh`` (``parallel/mesh.Mesh``) the front-end is split over the mesh's
model group (``models/mpaec.py``), on the gemm path.
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

    def __init__(self, spec: ModelSpec, frontend: str = "auto",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 mesh=None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.mpaec = AsymMPAEC(
            expected_time_frames=spec.time_frames,
            ft_size=spec.ft_size,
            hop_size=spec.hop_size,
            n_knobs=spec.num_knobs,
            output_tf=spec.output_time_frames,
            frontend=frontend,
            device=resolve_device(device),
            generator=generator,
            compute_dtype=compute_dtype,
            dropout_rate=dropout_rate,
            mesh=mesh,
        )

    @property
    def device(self) -> torch.device:
        return self.mpaec.dft_analysis.conv_analysis_real.weight.device

    def forward(self, x: torch.Tensor, knobs: torch.Tensor, deterministic: bool = True,
                return_acts: bool = False, generator: torch.Generator | None = None):
        """``AsymMPAEC.forward``: (y_hat, mag, mag_hat[, acts])."""
        return self.mpaec(x, knobs, deterministic=deterministic, return_acts=return_acts,
                          generator=generator)


def st_model(scale_factor: float = 1.0, shrink_factor: float = 4.0, num_knobs: int = 4,
             sr: int = 44100, scale_scheme: str = "lean", device: str | torch.device = "cuda",
             generator: torch.Generator | None = None,
             compute_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
             mesh=None) -> STModel:
    """The model with the geometry ``compute_spec`` derives: the fused
    front-end, or with a tensor-parallel ``mesh`` the gemm one, split."""
    spec = compute_spec(scale_factor, shrink_factor, num_knobs, sr, scale_scheme)
    return STModel(spec, device=device, generator=generator, compute_dtype=compute_dtype,
                   dropout_rate=dropout_rate, mesh=mesh)
