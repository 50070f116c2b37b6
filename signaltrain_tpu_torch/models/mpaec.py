"""Asymmetric Magnitude-Phase AutoEncoder with knob conditioning (AsymMPAEC).

Counterpart of signaltrain_tpu/models/mpaec.py; the forward math is the
reference's:

    re, im  = Analysis(x/2)                    # /2 ~ unit-variance trick
    mag     = sqrt(max(re^2 + im^2, 1e-36))
    phs     = atan2(im, re + 1e-7)
    mag_hat = aenc(mag, knobs; skip='sf')      # multiplicative skip-filter
    phs_hat = phs_aenc(phs, knobs; skip='') + phs[:, -OT:, :]
    wave    = Synthesis(mag_hat*cos(phs_hat), mag_hat*sin(phs_hat))
    y_hat   = 2 * (wave + x[:, -out:]/2)
    returns (y_hat, mag, mag_hat)

Two paths over the same parameters, chosen by ``frontend``:

* ``"gemm"``  -- the formulation above, batch-major (B, T, F) tensors, with
  the front-end as plain matrix products (JAX ``frontend="xla"``).
* ``"fused"`` -- kernel A (framing + GEMM + x/2 + magnitude/phase), the
  autoencoders frame-major, kernel B (trig + GEMM + overlap-add + trim)
  (JAX ``frontend="pallas"``). mag / mag_hat come back frame-major,
  (T, B, F) / (OT, B, F); 2*(wave + x_tail/2) is expanded to
  2*wave + x_tail, and the x/2 happens inside kernel A only.

``frontend="auto"`` takes the fused path, or the gemm path on a
tensor-parallel ``mesh`` (the JAX ``_pick_train_module``,
signaltrain_tpu/training/train.py:118-138). With ``mesh`` (a
``parallel/mesh.Mesh``) the front-end holds only this rank's rows
(``mesh.frontend_shard``) and runs the gemm path with the model group's
collectives; ``frontend="fused"`` is refused there, as the JAX arrays-fed
step refuses ``frontend='pallas'`` on a multi-device mesh
(signaltrain_tpu/training/train.py:416-426).

As in the JAX package, ``return_acts`` or an active dropout
(``dropout_rate`` > 0 and ``deterministic=False``) takes the batch-major
gemm path whatever ``frontend`` says; ``return_acts`` adds the 30
activations: the analysis' re and im, mag, phs (batch-major), the ten of
each autoencoder (``autoencoder.AsymAutoEncoder.forward``), then mag_hat,
phs_hat (after its residual), the synthesis' two inputs, its wave and y_hat
before the final doubling.

``compute_dtype`` (float32 or bfloat16, JAX's mixed precision): the
front-end products and the autoencoders run in it; the parameters, the
magnitude / phase, the trig and the outputs stay float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.cuda_frontend import mag_phs
from ..ops.frontend import Analysis, Synthesis
from ..utils.device import resolve_device
from .autoencoder import AsymAutoEncoder

FRONTENDS = ("gemm", "fused")


def pick_frontend(frontend: str, mesh=None) -> str:
    """``frontend`` ("gemm", "fused" or "auto") for a model on ``mesh``:
    "auto" is the fused path, or the gemm path on a tensor-parallel mesh,
    which refuses "fused"."""
    if frontend not in (*FRONTENDS, "auto"):
        raise ValueError(f"frontend must be one of {FRONTENDS} or 'auto', got {frontend!r}")
    if mesh is None:
        return "fused" if frontend == "auto" else frontend
    if frontend == "fused":
        raise ValueError("frontend='fused' is unsupported on a tensor-parallel mesh: kernels A "
                         "and B take whole front-end matrices; use frontend='auto' or 'gemm'")
    return "gemm"


class AsymMPAEC(nn.Module):
    def __init__(self, expected_time_frames: int, ft_size: int = 1024, hop_size: int = 384,
                 decomposition_rank: int = 64, n_knobs: int = 4, output_tf: int | None = None,
                 frontend: str = "auto", device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 mesh=None):
        super().__init__()
        frontend = pick_frontend(frontend, mesh)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        out_tf = output_tf if output_tf is not None else expected_time_frames
        self.frontend = frontend
        self.mesh = mesh
        shard = None if mesh is None else mesh.frontend_shard(ft_size)
        self.dft_analysis = Analysis(ft_size, hop_size, device=dev, compute_dtype=compute_dtype,
                                     shard=shard)
        self.dft_synthesis = Synthesis(ft_size, hop_size, device=dev, compute_dtype=compute_dtype,
                                       shard=shard)
        self.aenc = AsymAutoEncoder(expected_time_frames, decomposition_rank, n_knobs,
                                    out_tf, device=dev, generator=gen, compute_dtype=compute_dtype,
                                    dropout_rate=dropout_rate)
        self.phs_aenc = AsymAutoEncoder(expected_time_frames, decomposition_rank, n_knobs,
                                        out_tf, device=dev, generator=gen,
                                        compute_dtype=compute_dtype, dropout_rate=dropout_rate)

    def forward(self, x: torch.Tensor, knobs: torch.Tensor, deterministic: bool = True,
                return_acts: bool = False, generator: torch.Generator | None = None):
        """x: (B, in_chunk) waveform; knobs: (B, K) normalized to [-0.5, 0.5].
        Returns (y_hat, mag, mag_hat), and with ``return_acts`` the list of
        activations fourth; ``generator`` feeds an active dropout."""
        dropping = self.aenc.dropout_rate > 0.0 and not deterministic
        if self.frontend == "fused" and not return_acts and not dropping:
            return self._fused(x, knobs)
        kw = dict(deterministic=deterministic, return_acts=return_acts, generator=generator)
        re, im = self.dft_analysis(x / 2)
        mag, phs = mag_phs(re, im)
        mag_hat = self.aenc(mag, knobs, skip_connections="sf", **kw)
        phs_hat = self.phs_aenc(phs, knobs, skip_connections="", **kw)
        if return_acts:
            (mag_hat, m_acts), (phs_hat, p_acts) = mag_hat, phs_hat
        phs_hat = phs_hat + phs[:, -phs_hat.shape[1] :, :]  # residual phase skip
        an_real, an_imag = mag_hat * torch.cos(phs_hat), mag_hat * torch.sin(phs_hat)
        wave = self.dft_synthesis(an_real, an_imag)
        y_hat = wave + x[:, -wave.shape[-1] :] / 2
        if return_acts:
            acts = [re, im, mag, phs, *m_acts, *p_acts, mag_hat, phs_hat, an_real, an_imag, wave,
                    y_hat]
            return 2 * y_hat, mag, mag_hat, acts
        return 2 * y_hat, mag, mag_hat

    def _fused(self, x: torch.Tensor, knobs: torch.Tensor):
        mag, phs = self.dft_analysis.mag_phs(x)  # (T, B, half) each
        mag_hat = self.aenc.frame_major(mag, knobs, skip_connections="sf")
        phs_hat = self.phs_aenc.frame_major(phs, knobs, skip_connections="")
        phs_hat = phs_hat + phs[-phs_hat.shape[0] :]  # residual phase skip
        wave = self.dft_synthesis.from_mag_phs(mag_hat, phs_hat)
        y_hat = 2.0 * wave + x[:, -wave.shape[-1] :]
        return y_hat, mag, mag_hat
