"""One entry point for the port's models, by kind; the only module that
names the kinds.

* ``"mpaec"`` (the default): SignalTrain's knob-conditioned spectral
  autoencoder (``models/st_model.py``), its geometry from ``scale_factor``
  and ``shrink_factor``.
* ``"tcn"``: TCN-300-C (``models/tcn.py``), its sizes a ``TCNSpec``.

``train()``, ``cli.run_train --model``, the checkpoints (``spec.run_values``)
and ``utils/load_model`` build through ``build_model`` and
``model_from_run_values``; ``predict_long`` serves either through the
models' shared call contract. What differs by kind is the spec's and the
model's own: the spec class (``spec_class``) carries ``default_dtype``,
``batch_statistics`` (``check_split``) and ``optimizer_form`` (the
checkpoint's form of Adam's moments); both models carry ``spec`` (with
``in_chunk_size``, ``out_chunk_size``, ``sr``), ``loss``, ``clip_grads``,
``numerics``, ``mesh``, ``has_spectra`` and ``windows_per_forward``
(``training/train.py`` runs its steps through them).
"""

from __future__ import annotations

import dataclasses

import torch

from .st_model import ModelSpec, st_model
from .tcn import TCNModel, TCNSpec

SPECS = {spec.kind: spec for spec in (ModelSpec, TCNSpec)}
MODEL_KINDS = tuple(SPECS)


def spec_class(kind: str):
    """The spec class of ``kind``; ValueError for a kind there is none of."""
    if kind not in SPECS:
        raise ValueError(f"model kind must be one of {MODEL_KINDS}, got {kind!r}")
    return SPECS[kind]


def check_split(kind: str, ranks: int = 1, micro: int = 1) -> None:
    """ValueError where a model of ``kind`` whose spec has
    ``batch_statistics`` would train over ``ranks`` processes or in
    ``micro`` slices of a step: its BatchNorm takes its statistics over the
    whole batch."""
    got = [f"{ranks} processes"] * (ranks > 1) + [f"ST_TPU_MICROBATCH={micro}"] * (micro > 1)
    if spec_class(kind).batch_statistics and got:
        raise ValueError(f"a {kind} model takes its BatchNorm statistics over the whole batch, "
                         f"so it trains in one process, its step never sliced (got "
                         f"{', '.join(got)})")


def build_model(kind: str = "mpaec", *, num_knobs: int = 4, sr: int = 44100,
                device: str | torch.device = "cuda", generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = torch.float32, scale_factor: float = 1.0,
                shrink_factor: float = 4.0, tcn: TCNSpec | None = None, mesh=None):
    """The model of ``kind``: the spectral model of (``scale_factor``,
    ``shrink_factor``), on a tensor-parallel ``mesh`` if given, or a TCN of
    ``tcn``'s sizes (TCN-300-C's by default), with ``num_knobs`` and ``sr``
    in either case."""
    spec_class(kind)
    if kind == "mpaec":
        return st_model(scale_factor=scale_factor, shrink_factor=shrink_factor,
                        num_knobs=num_knobs, sr=sr, device=device, generator=generator,
                        compute_dtype=compute_dtype, mesh=mesh)
    if mesh is not None:
        raise ValueError("a TCN is not split over a tensor-parallel mesh")
    spec = dataclasses.replace(tcn or TCNSpec(), num_knobs=num_knobs, sr=sr)
    return TCNModel(spec, device=device, generator=generator, compute_dtype=compute_dtype)


def kind_of(run_values: dict) -> str:
    """The model kind a checkpoint's run values name (older ones: "mpaec")."""
    return run_values.get("model_kind", "mpaec")


def geometry(run_values: dict) -> dict:
    """``build_model``'s size arguments from a checkpoint's run values
    (``checkpoint.load_checkpoint`` fills the reference's defaults)."""
    rv = run_values
    return {"scale_factor": rv["scale_factor"], "shrink_factor": rv["shrink_factor"],
            "tcn": TCNSpec(**rv["tcn"]) if kind_of(rv) == "tcn" else None}


def model_from_run_values(run_values: dict, device: str | torch.device = "cuda",
                          compute_dtype: torch.dtype | None = None):
    """The model a checkpoint's run values describe, in ``compute_dtype``
    when one is given (float32 otherwise)."""
    rv = run_values
    return build_model(kind_of(rv), num_knobs=len(rv["knob_names"]), sr=rv["sr"], device=device,
                       compute_dtype=compute_dtype or torch.float32, **geometry(rv))
