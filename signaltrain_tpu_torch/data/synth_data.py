"""On-device synthetic data pipeline.

Counterpart of signaltrain_tpu/data/synth_data.py. The whole chain (chooser
coverage, signal synthesis, Beta(0.8, 0.8) knob draw, effect, output trim,
augmentation) runs batched on the effect's device from an explicit
``torch.Generator``: no host dataloader. The effect's ``go_batch`` runs the
envelope smoother (kernel C on a CUDA device) once over the whole (B, N)
batch.
"""

from __future__ import annotations

from typing import Callable, Sequence

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
    effect over the whole batch, y trimmed to its last y_size samples, then
    (with ``augment``) a random polarity flip of x and y together."""
    dev = effect.device
    t = torch.arange(chunk_size, dtype=torch.float32, device=dev) / sr
    nk = effect.num_knobs

    def gen_batch(batch: int, generator: torch.Generator):
        xs = synths.stratified_synth_batch(generator, t, choosers, batch)
        knobs = synths.random_ends(generator, batch, nk) - 0.5
        y, x = effect.go_batch(xs, knobs)
        y = y[:, -y_size:]
        if augment:
            flip = torch.rand(batch, generator=generator, device=dev) < 0.5
            x, y = polarity_flip(x, y, flip)
        return x.float(), y.float().contiguous(), knobs.float()

    return gen_batch


def step_generator(generator: torch.Generator, seed: int, step: int) -> torch.Generator:
    """Reseed ``generator`` for one step: the same (seed, step) always gives
    the same batch, whatever was drawn before, so a resumed run continues the
    stream and the validation batches are frozen."""
    generator.manual_seed(((int(seed) & 0x7FFFFFFF) << 32) + int(step))
    return generator


VAL_SEED = 7


def val_step_generator(generator: torch.Generator, step: int,
                       seed: int = VAL_SEED) -> torch.Generator:
    """The frozen validation stream: step v always yields the same batch."""
    return step_generator(generator, seed, step)
