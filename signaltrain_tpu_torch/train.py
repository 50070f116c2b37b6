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
                    clip_max_norm: float = 1.0):
    opt, lr_fn = tx
    g = _generator(model, generator)

    def step(s: int) -> torch.Tensor:
        x, y, knobs = batch_fn(batch_size, synth_data.step_generator(g, seed, s))
        return _train.train_step_from_arrays(model, opt, lr_fn, s, x, y, knobs, clip_max_norm)

    return step


def make_eval_step(model, val_batch_fn, batch_size, val_seed: int = synth_data.VAL_SEED,
                   generator=None):
    g = _generator(model, generator)

    def evaluate(v: int):
        x, y, knobs = val_batch_fn(batch_size, synth_data.val_step_generator(g, v, val_seed))
        return _train.eval_step_from_arrays(model, x, y, knobs)

    return evaluate


def make_train_multi_step(model, tx, batch_fn, batch_size, n_inner: int, generator=None,
                          seed: int = 0) -> graphs.TrainGraph:
    opt, lr_fn = tx
    return graphs.TrainGraph(model, opt, lr_fn, batch_fn, batch_size,
                             _generator(model, generator), seed, capacity=n_inner)


def make_eval_scan(model, val_batch_fn, batch_size, n_val_steps: int,
                   generator=None) -> graphs.EvalGraph:
    return graphs.EvalGraph(model, val_batch_fn, batch_size, _generator(model, generator),
                            n_val_steps)
