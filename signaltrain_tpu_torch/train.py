"""Reference-API facade for signaltrain.train: ``train``, ``make_optimizer``
and the JAX package's step builders, mapped onto the port's counterparts.

``tx`` is what ``make_optimizer`` returns, the pair (optimizer, lr_fn).

* ``make_train_step(model, tx, batch_fn, batch_size)`` -> ``step(s)``: one
  optimizer step on the batch of ``synth_data.step_generator(generator,
  seed, s)`` at ``lr_fn(s)``, dispatched op by op (``train.optimizer_step``
  through ``train_step_from_arrays``); returns the loss on the device.
* ``make_eval_step(model, val_batch_fn, batch_size)`` -> ``evaluate(v)``:
  (loss, mae, outputs) on the frozen validation batch v
  (``train.eval_step_from_arrays``).
* ``make_train_multi_step(model, tx, batch_fn, batch_size, n_inner)`` ->
  ``graphs.TrainGraph``: ``g(step0, n)`` runs n <= n_inner steps, each a
  CUDA-graph replay on the card, and returns their losses (the JAX
  package's ``lax.scan`` over steps in one device call).
* ``make_eval_scan(model, val_batch_fn, batch_size, n_val_steps)`` ->
  ``graphs.EvalGraph``: the whole validation pass, a replay a batch.

The four take ``mesh=`` (``parallel/mesh.py``), as the JAX package's do: a
train step then draws this rank's rows from its shard's stream and takes
the mean gradient over the ranks, an evaluation this rank's rows of the
global batch with the figures averaged over the ranks.

The graphs need a CUDA device; the two single-step callables run anywhere.
``batch_fn`` / ``val_batch_fn`` are ``fn(batch, generator)``, as
``data.synth_data.make_synth_batch_fn`` makes them. Each builder draws from
``generator`` (a new one on the model's device when none is given).
"""

from __future__ import annotations

import torch

from .data import synth_data
from .training import graphs
from .training import train as _train
from .training.train import make_optimizer, train  # noqa: F401


def _generator(model, generator):
    return generator if generator is not None else torch.Generator(device=model.device)


def make_train_step(model, tx, batch_fn, batch_size, generator=None, seed: int = 0,
                    clip_max_norm: float = 1.0, mesh=None):
    opt, lr_fn = tx
    g = _generator(model, generator)
    local, shard = ((batch_size, 0) if mesh is None
                    else (mesh.local_batch(batch_size), mesh.data_index))

    def step(s: int) -> torch.Tensor:
        x, y, knobs = batch_fn(local, synth_data.step_generator(g, seed, s, shard))
        return _train.train_step_from_arrays(model, opt, lr_fn, s, x, y, knobs, clip_max_norm,
                                             mesh)

    return step


def make_eval_step(model, val_batch_fn, batch_size, val_seed: int = synth_data.VAL_SEED,
                   generator=None, mesh=None):
    g = _generator(model, generator)
    rows = slice(None) if mesh is None else mesh.local_rows(batch_size)

    def evaluate(v: int):
        x, y, knobs = val_batch_fn(batch_size, synth_data.val_step_generator(g, v, val_seed))
        l, m, outputs = _train.eval_step_from_arrays(model, x[rows], y[rows], knobs[rows])
        l, m = _train.pmean_validation(mesh, l, m)
        return l, m, outputs

    return evaluate


def make_train_multi_step(model, tx, batch_fn, batch_size, n_inner: int, generator=None,
                          seed: int = 0, mesh=None) -> graphs.TrainGraph:
    opt, lr_fn = tx
    return graphs.TrainGraph(model, opt, lr_fn, batch_fn, batch_size,
                             _generator(model, generator), seed, capacity=n_inner, mesh=mesh)


def make_eval_scan(model, val_batch_fn, batch_size, n_val_steps: int,
                   generator=None, mesh=None) -> graphs.EvalGraph:
    return graphs.EvalGraph(model, val_batch_fn, batch_size, _generator(model, generator),
                            n_val_steps, mesh=mesh)
