"""Model-FLOP accounting and MFU on the H100.

Counterpart of signaltrain_tpu/utils/flops.py: the GEMM FLOPs of the
forward pass as the model executes them (``ops/frontend.py``,
``models/autoencoder.py``), per example. At the flagship geometry (ft 1024,
513 bins, T 25, OT 9, rank 64):

  analysis   2 * T  * ft     * 2*half   = 52.5 MFLOP  (one stacked product)
  synthesis  2 * OT * 2*half * ft       = 18.9 MFLOP  (mirror folded into W)
  2 x aenc   2 * half * sum(i*o)         = 16.7 MFLOP  (nine affine layers, x2)
  forward                               ~ 88.1 MFLOP

The backward runs every product twice (input and weight gradients), so a
train step counts 3x the forward, the usual model-FLOP convention. Not
counted: the elementwise work, the overlap-add, the optimizer and the data
synthesis.

``peak_flops`` reads the card's peak rate for the compute dtype from
``utils/card.py`` by the device's name: bf16 on the tensor cores, float32 as
the kernels compute it (three TF32 products a float32 product). A card it
does not know gives None, and ``mfu`` then returns no ratio.
"""

from __future__ import annotations

import torch

from . import card

# device-name prefix -> {compute dtype: peak FLOP/s}
_PEAKS = {
    "NVIDIA H100": {torch.bfloat16: card.PEAK_BF16_FLOPS, torch.float32: card.PEAK_SPLIT_TF32_FLOPS},
}


def aenc_gemm_flops_per_example(time_frames: int, output_frames: int, num_knobs: int,
                                n_bins: int, rank: int = 64) -> int:
    """One AsymAutoEncoder forward: nine affine layers over the frame axis,
    each an (n_bins, i) @ (i, o) product an example."""
    r = rank
    dims = [
        (time_frames, r), (r, r // 2), (r // 2, r // 4), (r // 4, r // 4),
        (r // 4 + num_knobs, r // 4), (r // 4, r // 4), (r // 4, r // 2),
        (r // 2, r), (r, output_frames),
    ]
    return 2 * n_bins * sum(i * o for i, o in dims)


def forward_gemm_flops_per_example(spec, rank: int = 64) -> int:
    """GEMM FLOPs of one AsymMPAEC forward, an example: the stacked analysis
    product, the folded synthesis product, the magnitude and phase
    autoencoders."""
    half = spec.ft_size // 2 + 1
    analysis = 2 * spec.time_frames * spec.ft_size * (2 * half)
    synthesis = 2 * spec.output_time_frames * (2 * half) * spec.ft_size
    aencs = 2 * aenc_gemm_flops_per_example(spec.time_frames, spec.output_time_frames,
                                            spec.num_knobs, half, rank)
    return analysis + synthesis + aencs


def train_step_flops_per_example(spec, rank: int = 64) -> int:
    """Forward, input and weight gradients: 3x the forward's GEMMs."""
    return 3 * forward_gemm_flops_per_example(spec, rank)


def peak_flops(device: str | torch.device | None = None,
               compute_dtype: torch.dtype = torch.bfloat16) -> float | None:
    """The card's peak FLOP/s for ``compute_dtype``, or None for a device
    this table does not know (the CPU, another card)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for prefix, peaks in _PEAKS.items():
        if name.startswith(prefix):
            return peaks.get(compute_dtype)
    return None


def mfu(spec, examples_per_sec: float, device: str | torch.device | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        rank: int = 64) -> tuple[float, float | None]:
    """(achieved FLOP/s, MFU or None) for a measured training throughput."""
    achieved = train_step_flops_per_example(spec, rank) * examples_per_sec
    peak = peak_flops(device, compute_dtype)
    return achieved, (achieved / peak if peak else None)
