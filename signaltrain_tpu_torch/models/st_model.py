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

The model's own training rules: ``STModel.loss`` (``loss.calc_loss``, the
log-cosh plus the frequency-weighted spectral L1) and ``STModel.clip_grads``
(``clip_frontend_grads``, the L1 clip of the front-end's gradients).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn as nn

from ..parallel import tensor as tp
from ..training import loss as loss_mod
from ..utils.device import resolve_device
from .mpaec import AsymMPAEC

FRONTEND_PARAMS = (
    "mpaec.dft_analysis.conv_analysis_real.weight",
    "mpaec.dft_analysis.conv_analysis_imag.weight",
    "mpaec.dft_synthesis.conv_synthesis_real.weight",
    "mpaec.dft_synthesis.conv_synthesis_imag.weight",
)


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

    kind = "mpaec"
    default_dtype = torch.bfloat16  # the JAX package's
    batch_statistics = False  # its rows are independent: split over ranks and slices
    optimizer_form = "optax"  # a checkpoint's moments in the JAX package's tree

    def run_values(self) -> dict:
        """What a reference checkpoint keeps of the geometry."""
        return {"scale_factor": self.scale_factor, "shrink_factor": self.shrink_factor,
                "in_chunk_size": self.in_chunk_size, "out_chunk_size": self.out_chunk_size,
                "sr": self.sr}


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


def clip_frontend_grads(model: nn.Module, max_norm: float = 1.0) -> torch.Tensor:
    """L1-norm clip of the front-end gradients only, in place: the joint norm
    over the four (ft, ft) matrices, coef = min(1, max_norm / (total + 1e-6)).
    On a tensor-parallel model the total is the sum of each rank's shard
    sums, all-reduced (summed) over the model group. Returns the norm (a
    device scalar; nothing is fetched)."""
    params = dict(model.named_parameters())
    grads = [params[name].grad for name in FRONTEND_PARAMS]
    total = torch.stack([g.abs().sum() for g in grads]).sum()
    shard = model.mpaec.dft_analysis.shard
    if shard is not None:
        total = tp.all_reduce_sum(total, shard.group)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)
    return total


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

    has_spectra = True  # mag / mag_hat, drawn with the front-end's weights
    windows_per_forward = 1024  # predict_long's windows a forward, to bound memory

    @property
    def mesh(self):
        return self.mpaec.mesh

    @property
    def frame_major(self) -> bool:
        """mag / mag_hat come (T, B, F), from the fused front-end."""
        return self.mpaec.frontend == "fused"

    def numerics(self):
        """The context the model's training step runs in: the kernels and the
        compute dtype set their own precision, so none."""
        return contextlib.nullcontext()

    def loss(self, y_hat: torch.Tensor, y: torch.Tensor, mag_hat: torch.Tensor) -> torch.Tensor:
        """``loss.calc_loss`` with the spectral L1 weighted by frequency."""
        scale = loss_mod.freq_scale(self.spec.ft_size // 2 + 1, str(y_hat.device))
        return loss_mod.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale)

    def clip_grads(self, max_norm: float = 1.0) -> torch.Tensor:
        """``clip_frontend_grads``: the L1 clip of the front-end's gradients."""
        return clip_frontend_grads(self, max_norm)

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
