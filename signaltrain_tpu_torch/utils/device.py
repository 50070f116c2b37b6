"""Device selection for the port's entry points, and numbers put on a device.

Entry points default to ``"cuda"``. Asking for a CUDA device on a machine
without one raises: the port never moves work to the CPU on its own. The
plain PyTorch path runs only where the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numbers

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def as_device_tensor(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``v`` as a ``dtype`` tensor on ``device``. A number is filled in on the
    device (``torch.full``, rounded to ``dtype`` as ``torch.as_tensor`` rounds
    it), with no copy from the host, as a step captured in a CUDA graph
    needs; anything else goes through ``torch.as_tensor``."""
    if isinstance(v, numbers.Real):
        return torch.full((), float(v), dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)
