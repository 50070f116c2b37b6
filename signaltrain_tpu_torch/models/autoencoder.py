"""Knob-conditioned asymmetric autoencoder over STFT time frames.

Counterpart of signaltrain_tpu/models/autoencoder.py: nine affine layers
applied along the time-frame axis of a spectrogram (frames are the feature
dimension), ELU activations, the knob vector concatenated at the bottleneck,
Xavier-normal / zero-bias init, and a selectable output skip mode:

    'res'  : ELU(dec(z) + x[..., -OT:])          residual
    'sf'   : ELU(dec(z)) * x[..., -OT:]          multiplicative skip-filter
    ''     : ELU(dec(z))                         none

Parameters carry the reference's names and layouts (``fnn_enc.weight`` of
shape (out, in), ``fnn_enc.bias``). Two layouts over the same parameters:
``forward`` is batch-major (B, T, F); ``frame_major`` is (T, B, F), the
layout kernel A emits and kernel B takes.

``dropout_rate`` (0 by default, the JAX package's and the reference's
default; the reference's layer is ``Dropout2d(0.2)``) drops whole rows, the
JAX package's ``nn.Dropout(broadcast_dims=(2,))`` on the (B, F, width)
activations: one keep / drop a (example, bin) row, shared across the width,
the kept rows divided by 1 - p in the activations' dtype. It applies after
``fnn_enc``, ``fnn_enc2``, ``fnn_dec3`` and the output skip, where the JAX
package applies it, and only in ``forward`` with ``deterministic=False``;
the masks are drawn from the ``generator`` passed in (a step's generator),
never from torch's global one, so a step captured in a CUDA graph draws
what the eager step draws. ``forward(..., return_acts=True)`` also returns
the JAX package's ten activations, in its order. ``frame_major`` (the fused
path) has neither.

``compute_dtype`` is the JAX package's (its ``_Dense``): the layers run in
it, the parameters stay float32. In bfloat16 the input and the weight are
cast to bf16, the product's result is bf16, the bias is cast to bf16 and
added after it (two roundings, as in JAX), ELU runs in bf16 and the knobs are
cast to the activations' dtype; the skip ``tail`` stays float32, so
``elu(dec) * tail`` (and the caller's ``phs_hat + phs``) come out float32.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda_frontend import COMPUTE_DTYPES
from ..utils.device import resolve_device

SKIP_MODES = ("res", "sf", "")


class Dense(nn.Module):
    """Affine layer over the last axis: ``weight`` (out, in), ``bias`` (out,).
    Initialised on the host from an explicit generator: truncated normal
    with the Xavier (fan-average) variance, zero bias."""

    def __init__(self, in_features: int, out_features: int, device: torch.device,
                 generator: torch.Generator, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        std = math.sqrt(2.0 / (in_features + out_features)) / 0.87962566103423978
        w = torch.empty(out_features, in_features)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return F.linear(x, self.weight, self.bias)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def dropout_rows(z: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Dropout of whole rows of z (B, F, width): each (example, bin) row is
    kept with probability 1 - rate, drawn from ``generator`` (on z's device),
    and the kept rows are divided by 1 - rate rounded to z's dtype (the JAX
    package's ``inputs / keep_prob``)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(z.shape[:-1] + (1,), generator=generator, device=z.device) < keep_prob
    scale = torch.tensor(keep_prob, dtype=z.dtype).item()
    return torch.where(keep, z / scale, torch.zeros((), dtype=z.dtype, device=z.device))


class AsymAutoEncoder(nn.Module):
    def __init__(self, time_frames: int = 25, rank: int = 64, n_knobs: int = 4,
                 output_frames: int = 9, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise TypeError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {compute_dtype}")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        r = rank
        self.output_frames = output_frames
        self.dropout_rate = dropout_rate

        def mk(i, o):
            return Dense(i, o, dev, gen, compute_dtype)

        self.fnn_enc = mk(time_frames, r)
        self.fnn_enc2 = mk(r, r // 2)
        self.fnn_enc3 = mk(r // 2, r // 4)
        self.fnn_enc4 = mk(r // 4, r // 4)
        self.fnn_addknobs = mk(r // 4 + n_knobs, r // 4)
        self.fnn_dec4 = mk(r // 4, r // 4)
        self.fnn_dec3 = mk(r // 4, r // 2)
        self.fnn_dec2 = mk(r // 2, r)
        self.fnn_dec = mk(r, output_frames)

    def _core(self, z: torch.Tensor, knobs: torch.Tensor, drop=None, acts=None) -> torch.Tensor:
        """From the first layer's activation (B, F, R) to the decoder's (B, F, OT).
        ``drop`` (or None) is the dropout of the batch-major path; ``acts``
        (or None) collects the JAX package's activations."""
        elu = F.elu

        def keep(z):
            if acts is not None:
                acts.append(z)
            return z

        def dropped(z):
            return drop(z) if drop is not None else z

        z = dropped(keep(z))
        z = dropped(keep(elu(self.fnn_enc2(z))))
        z = keep(elu(self.fnn_enc3(z)))
        z = keep(elu(self.fnn_enc4(z)))
        knobs_r = knobs[:, None, :].to(z.dtype).expand(z.shape[0], z.shape[1], knobs.shape[-1])
        z = keep(torch.cat((z, knobs_r), dim=2))
        z = keep(elu(self.fnn_addknobs(z)))
        z = keep(elu(self.fnn_dec4(z)))
        z = dropped(keep(elu(self.fnn_dec3(z))))
        z = keep(elu(self.fnn_dec2(z)))
        return self.fnn_dec(z)

    @staticmethod
    def _skip(dec: torch.Tensor, tail: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "res":
            return F.elu(dec + tail)
        if mode == "sf":
            return F.elu(dec) * tail
        return F.elu(dec)

    def forward(self, x: torch.Tensor, knobs: torch.Tensor, skip_connections: str = "res",
                deterministic: bool = True, return_acts: bool = False,
                generator: torch.Generator | None = None):
        """x: (B, T, F) spectrogram; knobs: (B, K) in [-0.5, 0.5] -> (B, OT, F),
        or (out, acts) with ``return_acts``: the ten activations, (B, F, width)
        each, in the JAX package's order (fnn_enc .. fnn_enc4, the knobs
        concatenated, fnn_addknobs, fnn_dec4 .. fnn_dec2, the output after the
        skip and its dropout). Dropout runs when ``dropout_rate`` > 0 and not
        ``deterministic``, and then needs ``generator``."""
        if skip_connections not in SKIP_MODES:
            raise ValueError(f"unsupported skip mode {skip_connections!r}")
        drop = None
        if self.dropout_rate > 0.0 and not deterministic:
            if generator is None:
                raise ValueError("dropout needs a torch.Generator (the step's generator)")
            drop = functools.partial(dropout_rows, rate=self.dropout_rate, generator=generator)
        acts = [] if return_acts else None
        x_input = x.transpose(1, 2)  # (B, F, T): frames are features
        dec = self._core(F.elu(self.fnn_enc(x_input)), knobs, drop, acts)
        out = self._skip(dec, x_input[:, :, -self.output_frames :], skip_connections)
        if drop is not None:
            out = drop(out)
        if acts is None:
            return out.transpose(1, 2)
        acts.append(out)
        return out.transpose(1, 2), acts

    def frame_major(self, xf: torch.Tensor, knobs: torch.Tensor,
                    skip_connections: str = "res") -> torch.Tensor:
        """xf: (T, B, F) -> (OT, B, F), contiguous. The first layer contracts
        the leading frame axis; the same math as ``forward``."""
        if skip_connections not in SKIP_MODES:
            raise ValueError(f"unsupported skip mode {skip_connections!r}")
        x_input = xf.permute(1, 2, 0)  # (B, F, T) view
        dec = self._core(F.elu(self.fnn_enc(x_input)), knobs)
        out = self._skip(dec, x_input[:, :, -self.output_frames :], skip_connections)
        return out.permute(2, 0, 1).contiguous()
