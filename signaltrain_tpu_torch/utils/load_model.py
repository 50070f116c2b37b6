"""Checkpoint -> model on a device.

Counterpart of signaltrain_tpu/utils/load_model.py: the checkpoint's run
values map onto the model (its kind, ``models/kinds.py``, and its
geometry), and its state_dict loads with ``strict=True``. A missing file
raises ``FileNotFoundError``.
"""

from __future__ import annotations

import torch

from ..models.kinds import model_from_run_values
from ..training import checkpoint
from .device import resolve_device


def load_model(infile: str, device: str | torch.device = "cuda",
               compute_dtype: torch.dtype | None = None) -> tuple[torch.nn.Module, dict]:
    """Rebuild (model, run_values) from a .tar checkpoint; the model is in
    eval mode on ``device`` (the spectral model on its fused front-end, or a
    TCN), in ``compute_dtype`` when one is given (float32 otherwise, the
    model's default, as in the JAX package)."""
    dev = resolve_device(device)
    state_dict, rv = checkpoint.load_checkpoint(infile)
    model = model_from_run_values(rv, device=dev, compute_dtype=compute_dtype)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    return model, rv
