"""On-device synthetic data pipeline.

Counterpart of signaltrain_tpu/data/synth_data.py. The whole chain (chooser
coverage, signal synthesis, Beta(0.8, 0.8) knob draw, effect, output trim,
augmentation) runs batched on the effect's device from an explicit
``torch.Generator``: no host dataloader. The effect's ``go_batch`` runs once
over the whole (B, N) batch (its envelope, filter or vocoder on the card) and
draws what it needs (Denoise's noise, TimeAlign's chooser, shift and
re-synthesis) from the same generator, the step's stream.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..dsp import synths


def polarity_flip(x: torch.Tensor, y: torch.Tensor, flip: torch.Tensor):
    """The augmentation: input and target of example b change sign together
    where ``flip[b]``."""
    sign = torch.where(flip, -1.0, 1.0)[:, None].to(x.dtype)
    return x * sign, y * sign


def make_synth_batch_fn(effect, chunk_size: int, y_size: int, sr: float = 44100.0,
                        augment: bool = True,
                        choosers: Sequence[int] = synths.DEFAULT_CHOOSERS) -> Callable:
    """Returns gen(batch, generator) -> (x (B, chunk), y (B, y_size), knobs (B, K)),
    float32 on the effect's device; ``generator`` must live there too.

    Stratified inputs over ``choosers``, knobs ~ Beta(0.8, 0.8) - 0.5, the
    effect over the whole batch (its draws from ``generator``), y trimmed to its last y_size samples, then
    (with ``augment``) a random polarity flip of x and y together."""
    dev = effect.device
    t = torch.arange(chunk_size, dtype=torch.float32, device=dev) / sr
    nk = effect.num_knobs

    def gen_batch(batch: int, generator: torch.Generator):
        xs = synths.stratified_synth_batch(generator, t, choosers, batch)
        knobs = synths.random_ends(generator, batch, nk) - 0.5
        y, x = effect.go_batch(xs, knobs, generator)
        y = y[:, -y_size:]
        if augment:
            flip = torch.rand(batch, generator=generator, device=dev) < 0.5
            x, y = polarity_flip(x, y, flip)
        return x.float(), y.float().contiguous(), knobs.float()

    return gen_batch


def step_generator(generator: torch.Generator, seed: int, step: int,
                   shard: int = 0) -> torch.Generator:
    """Reseed ``generator`` for one step of one data shard: the same (seed,
    step, shard) always gives the same batch, whatever was drawn before, so a
    resumed run continues the stream and the validation batches are frozen.

    Shard 0, the whole batch of a single-process run, is seeded
    ``(seed & 0x7FFFFFFF) << 32 | step``, which never sets bit 63 for a step
    below 2**32. Shard s > 0 (rank s's rows, as each JAX device folds its
    shard into the step's key) is seeded from ``numpy.random.SeedSequence
    ([seed, step, s])`` with bit 63 set, so its stream is neither a shard-0
    stream nor another shard's."""
    if shard == 0:
        generator.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) + int(step))
    else:
        ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(step), int(shard)])
        generator.manual_seed(int(ss.generate_state(1, np.uint64)[0]) | (1 << 63))
    return generator


VAL_SEED = 7


def val_step_generator(generator: torch.Generator, step: int,
                       seed: int = VAL_SEED) -> torch.Generator:
    """The frozen validation stream: step v always yields the same batch."""
    return step_generator(generator, seed, step)
