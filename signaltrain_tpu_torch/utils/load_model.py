"""Checkpoint -> model on a device.

Counterpart of signaltrain_tpu/utils/load_model.py: the checkpoint's run
values map onto the model geometry, and its state_dict loads with
``strict=True``. A missing file raises ``FileNotFoundError``.
"""

from __future__ import annotations

import torch

from ..models.st_model import STModel, st_model
from ..training import checkpoint
from .device import resolve_device


def load_model(infile: str, device: str | torch.device = "cuda",
               compute_dtype: torch.dtype | None = None) -> tuple[STModel, dict]:
    """Rebuild (model, run_values) from a .tar checkpoint; the model is in
    eval mode on ``device`` and runs the fused front-end, in
    ``compute_dtype`` when one is given (float32 otherwise, the model's
    default, as in the JAX package)."""
    dev = resolve_device(device)
    state_dict, rv = checkpoint.load_checkpoint(infile)
    kwargs = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    model = st_model(
        scale_factor=rv["scale_factor"],
        shrink_factor=rv["shrink_factor"],
        num_knobs=len(rv["knob_names"]),
        sr=rv["sr"],
        device=dev,
        **kwargs,
    )
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    return model, rv
