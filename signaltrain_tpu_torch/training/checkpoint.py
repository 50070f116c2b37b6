"""Checkpoint loading and saving, in the reference's .tar schema.

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
leaves) onto those names and ``state_dict_to_params`` maps back, so both
packages can run the same weights.

The optimizer state travels in the JAX package's form, so a ``.tar`` written
by either package resumes in the other: ``optax_state`` is the list of numpy
leaves of ``optax.adam(schedule).init(params)`` after ``optax_step`` updates,
in ``jax.tree_util.tree_leaves`` order:

  [count (int32 scalar),
   first moments  mu, one leaf per parameter,
   second moments nu, one leaf per parameter,
   count of the schedule (int32 scalar)]

A dict flattens in sorted key order, so the per-parameter leaves run
aenc, dft_analysis, dft_synthesis, phs_aenc; inside an autoencoder
fnn_addknobs, fnn_dec, fnn_dec2, fnn_dec3, fnn_dec4, fnn_enc, fnn_enc2,
fnn_enc3, fnn_enc4, each as bias then kernel (in, out); inside a front-end
side w_imag then w_real (ft, ft). ``torch.optim.Adam`` keeps the same
moments as ``exp_avg`` / ``exp_avg_sq`` per parameter and the same count as
``step``.

A tensor-parallel model (``parallel/mesh.py``) holds only its rows of the
four front-end matrices. Its checkpoint is the one a single card writes:
``training_tensors`` gathers each matrix and its two moments over the model
group to the whole (ft, ft) tensor under the reference's name, and loading
takes the rows of the mesh it resumes on (``shard_state_dict``,
``restore_optimizer``), so a run resumes under any mesh shape (the JAX
package's mesh-agnostic form, tests/test_mesh_elastic.py).

A TCN's checkpoint (``models/tcn.py``; JAX has no TCN, so no interchange
form applies) holds the same keys but the spectral geometry: its state dict
(BatchNorm's running statistics included), ``model_kind`` "tcn", its sizes
under ``tcn``, ``in_chunk_size``, ``out_chunk_size`` and ``sr``
(``TCNSpec.run_values``); Adam's moments by parameter name as
``adam_state`` {"exp_avg": ..., "exp_avg_sq": ...} and its count as
``adam_step`` (``restore_adam``).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..parallel import tensor as tp

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


def state_dict_to_params(sd) -> dict:
    """The inverse of ``params_to_state_dict``: a state_dict (tensors or
    arrays) -> the JAX package's parameter tree with numpy leaves."""

    def arr(key):
        v = sd[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return np.asarray(v, dtype=np.float32)

    p: dict[str, Any] = {}
    for side, name in (("dft_analysis", "conv_analysis"), ("dft_synthesis", "conv_synthesis")):
        p[side] = {f"w_{part}": arr(f"mpaec.{side}.{name}_{part}.weight")[:, 0, :].copy()
                   for part in ("real", "imag")}
    for ae in ("aenc", "phs_aenc"):
        p[ae] = {layer: {"kernel": arr(f"mpaec.{ae}.{layer}.weight").T.copy(),
                         "bias": arr(f"mpaec.{ae}.{layer}.bias").copy()}
                 for layer in AE_LAYERS}
    return {"params": p}


def frontend_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX parameter tree of a front-end variant ({"params": {...}} of
    ``DCTAnalysis``, ``DCTSynthesis``, ``FNNAnalysis`` or ``FNNSynthesis``)
    -> the state_dict of the port's module of that name. The leaves keep
    their names (``weight``, ``bias``, ``w_real``, ``w_imag``) and layouts."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params["params"].items()}


def _leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (how JAX flattens one)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(template, leaves: list):
    """Rebuild ``template``'s nesting from ``leaves`` (consumed in order)."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return leaves.pop(0)


def frontend_shards(model: torch.nn.Module) -> dict:
    """{state_dict name: ``FrontendShard``} of a tensor-parallel model's
    front-end matrices; empty for a whole model."""
    return {f"{prefix}.{name}": m.shard
            for prefix, m in model.named_modules() if getattr(m, "shard", None) is not None
            for name, _ in m.named_parameters()}


def param_count(model: torch.nn.Module) -> int:
    """The whole model's parameter count: a tensor-parallel model's front-end
    matrices at their whole (ft, ft) size, so that every mesh shape counts
    what one card holds (the JAX package counts before placement)."""
    shards = frontend_shards(model)
    return sum(shards[k].ft ** 2 if k in shards else p.numel()
               for k, p in model.named_parameters())


def shard_state_dict(model: torch.nn.Module, sd: dict) -> dict:
    """A state dict of whole matrices -> the tensors ``model`` holds: of a
    tensor-parallel model's front-end, its rank's rows."""
    shards = frontend_shards(model)
    return {k: v[torch.as_tensor(shards[k].rows())] if k in shards else v for k, v in sd.items()}


def training_tensors(model: torch.nn.Module,
                     optimizer: torch.optim.Adam | None = None) -> dict[str, dict]:
    """The tensors a checkpoint holds: {"state_dict": the model's state
    dict} and, with ``optimizer``, Adam's moments by parameter name,
    {"exp_avg": ..., "exp_avg_sq": ...} (zeros for a parameter not stepped
    yet). A whole model's are its live tensors; a tensor-parallel model's
    front-end matrices and their moments are gathered to the whole (ft, ft)
    tensors, a collective that every rank of the model group calls.
    ``async_io.snapshot`` copies them on the device for a background write
    (``save_checkpoint``)."""
    shards = frontend_shards(model)

    def whole(sd: dict) -> dict:
        return {k: tp.gather_rows(v, shards[k]) if k in shards else v for k, v in sd.items()}

    out = {"state_dict": whole(dict(model.state_dict()))}
    if optimizer is not None:
        names = {id(p): n for n, p in model.named_parameters()}
        moments = {"exp_avg": {}, "exp_avg_sq": {}}
        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                for key, sd in moments.items():
                    sd[names[id(p)]] = st[key] if key in st else torch.zeros_like(p)
        out.update({k: whole(v) for k, v in moments.items()})
    return out


class _NumpyLeaf:
    """A numpy array that ``torch.save`` writes as a tensor record, its
    bytes copied into the file as they are, and ``torch.load`` rebuilds as
    the same numpy array (through ``numpy.asarray``). Pickled inline, the
    arrays' bytes go through the pickler under protocol 2, which holds the
    interpreter lock all the while and so stalls the training loop's thread
    while the background writer saves."""

    def __init__(self, a: np.ndarray):
        self.t = torch.from_numpy(a)

    def __reduce__(self):
        return np.asarray, (self.t,)


def _optax_leaves(exp_avg: dict, exp_avg_sq: dict, step: int) -> list:
    count = np.asarray(step, dtype=np.int32)
    leaves = [count, *_leaves(state_dict_to_params(exp_avg)),
              *_leaves(state_dict_to_params(exp_avg_sq)), count.copy()]
    return [_NumpyLeaf(a) for a in leaves]


def restore_optimizer(model: torch.nn.Module, optimizer: torch.optim.Adam, leaves: list,
                      step: int) -> None:
    """Load ``optax_state`` leaves (module docstring) into Adam's state (of a
    tensor-parallel model, the moments' rows of its front-end shard). Every
    tensor of it, the float32 ``step`` included, lies on its parameter's
    device, where ``torch.optim.Adam(capturable=True)`` wants it."""
    template = state_dict_to_params(model.state_dict())
    n = len(_leaves(template))
    if len(leaves) != 2 * n + 2:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {2 * n + 2}")
    mu, nu = (shard_state_dict(model, params_to_state_dict(_unflatten(template, list(part))))
              for part in (leaves[1 : 1 + n], leaves[1 + n : 1 + 2 * n]))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32, device=p.device),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).contiguous(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).contiguous(),
        }


def restore_adam(model: torch.nn.Module, optimizer: torch.optim.Adam, moments: dict,
                 step: int) -> None:
    """Load a TCN checkpoint's ``adam_state`` (moments by parameter name)
    and count into Adam's state, each tensor on its parameter's device."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32, device=p.device),
            **{k: moments[k][name].to(p.device, torch.float32).reshape(p.shape).contiguous()
               for k in ("exp_avg", "exp_avg_sq")},
        }


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def save_checkpoint(checkpointname: str, spec, effect, epoch: int, tensors: dict,
                    step: int = 0) -> None:
    """Write a reference-schema .tar checkpoint from ``training_tensors``'
    dict (the live tensors, or ``async_io.snapshot``'s host copies of them)
    and the model's spec (``ModelSpec`` or ``TCNSpec``: its ``run_values``);
    with the moments also the optimizer state in the spec's
    ``optimizer_form``: "optax" as ``optax_state`` (numpy leaves once
    loaded) / ``optax_step``, "adam" as ``adam_state`` / ``adam_step``."""
    print(f"\nsaving model to {checkpointname}", end="")
    state = {
        "epoch": epoch + 1,
        "state_dict": _cpu(tensors["state_dict"]),
        "optimizer": {},  # schema slot; the reference never restores it either
        "effect_name": effect.name,
        "knob_names": effect.knob_names,
        "knob_ranges": np.asarray(effect.knob_ranges),
        **spec.run_values(),
    }
    if "exp_avg" in tensors and spec.optimizer_form == "optax":
        state["optax_state"] = _optax_leaves(tensors["exp_avg"], tensors["exp_avg_sq"], step)
        state["optax_step"] = step
    elif "exp_avg" in tensors:
        state["adam_state"] = {k: _cpu(tensors[k]) for k in ("exp_avg", "exp_avg_sq")}
        state["adam_step"] = step
    torch.save(state, checkpointname)


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

    state_dict = {k: v.to(torch.float32) if v.is_floating_point() else v
                  for k, v in checkpoint["state_dict"].items()}
    return state_dict, rv
