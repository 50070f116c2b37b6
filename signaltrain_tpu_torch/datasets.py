"""Reference-API facade for signaltrain.datasets.

``SynthAudioDataSet`` / ``AudioFileDataSet`` keep the reference's constructor
signatures (datasets.py:64-334) and the feel of an indexable dataset, over
the device pipelines (``data/synth_data.py``, ``data/file_data.py``) on the
effect's device: ``__getitem__`` returns numpy triples; ``batches()`` yields
whole device batches, the efficient path.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import file_data, synth_data


def _numpy(batch) -> tuple:
    return tuple(a[0].cpu().numpy() for a in batch)


class SynthAudioDataSet:
    """Synthesized (x, y, knobs) examples made on the fly (datasets.py:263-334).

    ``recycle=True`` freezes the stream: item idx is always the same (the
    reference's fixed validation set), drawn from the generator reseeded for
    (seed, idx). Otherwise each item is the next of the stream of ``seed``."""

    def __init__(self, chunk_size, effect, sr=44100, datapoints=8000, recycle=False,
                 y_size=None, augment=True, seed=0):
        self.chunk_size = chunk_size
        self.effect = effect
        self.sr = sr
        self.datapoints = datapoints
        self.recycle = recycle
        self.y_size = chunk_size if y_size is None else y_size
        self.num_knobs = effect.num_knobs
        self._gen = synth_data.make_synth_batch_fn(effect, chunk_size, self.y_size, sr=sr,
                                                   augment=augment)
        self._generator = torch.Generator(device=effect.device)
        self._seed = seed
        self._draws = 0

    def __len__(self):
        return self.datapoints

    def __getitem__(self, idx):
        if self.recycle:
            g = synth_data.val_step_generator(self._generator, idx, seed=self._seed)
        else:
            g = synth_data.step_generator(self._generator, self._seed, self._draws)
            self._draws += 1
        return _numpy(self._gen(1, g))

    def batches(self, batch_size, steps=None, seed=None):
        """Yield (x, y, knobs) device batches, batch i from the generator
        reseeded for (seed, i): the efficient interface."""
        steps = steps if steps is not None else max(1, self.datapoints // batch_size)
        seed = self._seed if seed is None else seed
        for i in range(steps):
            yield self._gen(batch_size, synth_data.step_generator(self._generator, seed, i))


class AudioFileDataSet(file_data.FileDataset):
    """A dataset of recorded files (datasets.py:64-259); ``data.file_data.
    FileDataset`` holds the corpus on the device or in host memory by its
    size."""

    def __init__(self, chunk_size, effect, sr=44100, path="./Train/", datapoints=8000,
                 preload=True, rerun=False, y_size=None, augment=True, align_end=True,
                 compand=False, **kw):
        del preload  # always preloads (device or host residency by size)
        super().__init__(path, effect, chunk_size, y_size=y_size, sr=sr, rerun=rerun,
                         augment=augment, align_end=align_end, compand=compand, **kw)
        self.datapoints = datapoints
        self._generator = torch.Generator(device=self.device)
        self._draws = 0

    def __len__(self):
        return self.datapoints

    def __getitem__(self, idx):
        draw = self._draws
        self._draws += 1
        if self.device_resident:
            return _numpy(self.batch_fn(1, synth_data.step_generator(self._generator, 0, draw)))
        x, y, knobs = self.host_batch(1, np.random.default_rng(draw))
        return x[0], y[0], knobs[0]


def do_augment(x, y, rand_invert=True, mult_some=False, add_some=False, rng=None):
    """Host-side augmentation of numpy x, y (datasets.py:21-51); the device
    pipelines apply the rand_invert flip themselves."""
    rng = rng or np.random.default_rng()
    if rand_invert and rng.random() < 0.5:
        x, y = -x, -y
    lookback = x.size - y.size
    if mult_some and rng.random() < 0.5:
        n = int(lookback * 0.2)
        idx = rng.integers(0, lookback, size=n)
        x[idx] = x[idx] * (2 * rng.random(n) - 1).astype(x.dtype)
    if add_some and rng.random() < 0.5:
        n = int(lookback * 0.3)
        idx = rng.integers(0, lookback, size=n)
        tiny = np.max(x) / 1e6
        x[idx] = x[idx] + (tiny * (2 * rng.random(n) - 1)).astype(x.dtype)
    return x, y
