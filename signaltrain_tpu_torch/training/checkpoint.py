"""Checkpoint loading, in the reference's .tar schema.

The reference bundles weights and run metadata into one torch.save dict:
{epoch, state_dict, optimizer, effect_name, knob_names, knob_ranges,
scale_factor, shrink_factor, in_chunk_size, out_chunk_size, sr}. The port's
model carries the reference's state_dict names and layouts, so a checkpoint's
``state_dict`` loads into it with ``strict=True``:

  mpaec.dft_analysis.conv_analysis_{real,imag}.weight    (ft, 1, ft)
  mpaec.dft_synthesis.conv_synthesis_{real,imag}.weight  (ft, 1, ft)
  mpaec.{aenc,phs_aenc}.fnn_*.weight                     (out, in)
  mpaec.{aenc,phs_aenc}.fnn_*.bias                       (out,)

``params_to_state_dict`` maps the JAX package's parameter tree (numpy
leaves) onto those names, so both packages can run the same weights.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

AE_LAYERS = (
    "fnn_enc", "fnn_enc2", "fnn_enc3", "fnn_enc4", "fnn_addknobs",
    "fnn_dec4", "fnn_dec3", "fnn_dec2", "fnn_dec",
)


def params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """{"params": {"dft_analysis": {"w_real", "w_imag"}, "dft_synthesis": ...,
    "aenc": {"fnn_*": {"kernel", "bias"}}, "phs_aenc": ...}} with array
    leaves -> the port's state_dict. Dense kernels (in, out) are transposed
    to (out, in); front-end matrices (ft, ft) gain the conv axis (ft, 1, ft)."""
    p = params["params"]
    sd = {}
    for side, name in (("dft_analysis", "conv_analysis"), ("dft_synthesis", "conv_synthesis")):
        for part in ("real", "imag"):
            w = np.asarray(p[side][f"w_{part}"], dtype=np.float32)
            sd[f"mpaec.{side}.{name}_{part}.weight"] = torch.from_numpy(w[:, None, :].copy())
    for ae in ("aenc", "phs_aenc"):
        for layer in AE_LAYERS:
            node = p[ae][layer]
            sd[f"mpaec.{ae}.{layer}.weight"] = torch.from_numpy(
                np.asarray(node["kernel"], dtype=np.float32).T.copy()
            )
            sd[f"mpaec.{ae}.{layer}.bias"] = torch.from_numpy(
                np.asarray(node["bias"], dtype=np.float32).copy()
            )
    return sd


def load_checkpoint(checkpointname: str):
    """Load a .tar checkpoint: (state_dict, run_values).

    run_values carries the metadata, with the reference's defaults for keys
    that older checkpoints lack. A missing file raises FileNotFoundError."""
    if not os.path.isfile(checkpointname):
        raise FileNotFoundError(f"checkpoint {checkpointname} not found")
    rv: dict[str, Any] = {}
    print("\n***** Checkpoint file found. Loading weights.")
    # the schema stores numpy arrays (knob_ranges), which weights_only refuses
    checkpoint = torch.load(checkpointname, map_location="cpu", weights_only=False)

    rv.setdefault("sr", 44100)
    rv.setdefault("scale_factor", 1)
    rv.setdefault("shrink_factor", 4)
    rv.setdefault("in_chunk_size", 8192)
    rv.setdefault("out_chunk_size", 2048)
    rv.setdefault("knob_names", ["thresh", "ratio", "attackTime", "releaseTime"])
    rv.setdefault("knob_ranges", np.array([[-30, 0], [1, 5], [1e-3, 4e-2], [1e-3, 4e-2]]))
    for key, value in checkpoint.items():
        if "state_dict" not in key:
            rv[key] = value

    state_dict = {k: v.to(torch.float32) for k, v in checkpoint["state_dict"].items()}
    return state_dict, rv
