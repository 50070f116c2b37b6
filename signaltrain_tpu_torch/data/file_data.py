"""Pre-recorded file datasets.

Counterpart of signaltrain_tpu/data/file_data.py. A directory of sorted
``input_*`` / ``target_*`` pairs, the knob values in world coordinates
parsed from each target's name (``target_9400_Compressor_4c__-10.95__3.428
__0.005043__0.01308.wav``), mismatched lengths aligned at their ends, input
and target swapped for an inverse effect, optionally mu-law companded. The
arrays are built with the JAX package's numpy code, so they are bit-equal to
its arrays for the same files.

The corpus lives in one of three tiers, chosen by its size against
``device_resident_limit_bytes`` (4 GiB by default, as in the JAX package):

* **f32 on the device**: the padded (F, L) float32 input and target arrays;
* **int16 on the device**: when only the int16 copy fits,
  ``clip(round(a * 32767), -32768, 32767)`` (numpy's half-to-even
  rounding), dequantized by a true float32 division by 32767 after the
  crop. A 16-bit wav read at its own rate comes back bit for bit, so on a
  ``--pcm16`` dataset this tier gives the f32 tier's batches exactly;
* **host-resident**: the float32 arrays stay in host memory; ``host_batch``
  samples a batch with numpy (the JAX package's code, so the same
  ``default_rng`` gives the same batch) and ``prefetch_batches`` runs it on
  a producer thread into a ring of pinned buffers, ahead of the step.

On the device ``batch_fn(batch, generator)`` draws each example's file,
crop start and polarity from the step's generator, crops by one gather from
the flattened corpus at ``i * L + start + arange(chunk)`` (a row ``x[i]``
is never materialized), and, with ``rerun`` (``-t chunk``), re-runs the
effect over the cropped inputs. It copies nothing from the host and sizes
nothing by the data, so a CUDA graph captures it as it captures the
synthetic batch function.
"""

from __future__ import annotations

import glob
import os
import queue
import threading

import numpy as np
import torch

from ..dsp.effects import FileEffect
from ..dsp.knobs import knobs_nn_from_wc
from . import audio_io
from .synth_data import polarity_flip


class _Closed(Exception):
    """Raised in the producer when its prefetcher closes while it waits."""


class _Prefetcher:
    """A bounded producer thread: keeps n_slots batches made ahead of the
    consumer. An exception in the producer is delivered by ``next()``; the
    producer has then exited, so every later ``next()`` re-raises it instead
    of waiting for a batch that will not come. ``on_close`` runs when the
    prefetcher closes (before the thread is joined)."""

    def __init__(self, make_batch, n_slots: int = 2, on_close=None):
        self._q: queue.Queue = queue.Queue(maxsize=n_slots)
        self._dead: Exception | None = None
        self._stop = threading.Event()
        self._make = make_batch
        self._on_close = on_close
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            try:
                item = self._make()
            except Exception as e:  # delivered by next(), not lost with the thread
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def next(self):
        if self._dead is not None:
            raise self._dead
        item = self._q.get()
        if isinstance(item, Exception):
            self._dead = item
            raise item
        return item

    def close(self):
        self._stop.set()
        if self._on_close is not None:
            self._on_close()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class _PinnedRing:
    """``n`` host buffers for (x, y, knobs) batches, pinned when they feed a
    CUDA device. A slot goes back to the producer once its batch was copied
    out (``HostBatch.release``); before refilling it the producer waits for
    the event recorded on that copy, so no buffer is overwritten while the
    card still reads it."""

    def __init__(self, shapes, n: int, pin: bool):
        self.bufs = [tuple(torch.empty(s, dtype=torch.float32, pin_memory=pin) for s in shapes)
                     for _ in range(n)]
        self.events: list = [None] * n
        self.cuda = pin
        self.closed = False
        self.free: queue.Queue = queue.Queue()
        for i in range(n):
            self.free.put(i)

    def fill(self, arrays) -> "HostBatch":
        while True:
            if self.closed:
                raise _Closed()
            try:
                slot = self.free.get(timeout=0.2)
                break
            except queue.Empty:
                continue
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        for buf, a in zip(self.bufs[slot], arrays):
            buf.numpy()[...] = a
        return HostBatch(self, slot)


class HostBatch:
    """One prefetched (x, y, knobs) batch in a slot of a ``_PinnedRing``."""

    def __init__(self, ring: _PinnedRing, slot: int):
        self.ring, self.slot = ring, slot
        self.tensors = ring.bufs[slot]

    def copy_into(self, dst) -> None:
        """Copy the batch into the tensors ``dst`` on the current stream (from
        pinned memory, asynchronously, on a card), then give the slot back."""
        for d, s in zip(dst, self.tensors):
            d.copy_(s, non_blocking=self.ring.cuda)
        self.release()

    def take(self, device) -> tuple[torch.Tensor, ...]:
        """The batch as new tensors on ``device``; the slot goes back."""
        out = tuple(torch.empty(s.shape, dtype=s.dtype, device=device) for s in self.tensors)
        self.copy_into(out)
        return out

    def release(self) -> None:
        if self.ring.cuda:
            event = torch.cuda.Event()
            event.record()
            self.ring.events[self.slot] = event
        self.ring.free.put(self.slot)


def mu_compand_np(y, mu: float = 32.0):
    return np.sign(y) * np.log1p(mu * np.abs(y)) / np.log1p(mu)


def parse_knob_string(knob_str: str, ext: str = ".wav") -> np.ndarray:
    """File name -> world-coordinate knob values."""
    knob_list = knob_str.replace(ext, "").split("__")[1:]
    return np.array([float(x) for x in knob_list], dtype=np.float32)


def to_int16_tier(a: np.ndarray) -> np.ndarray:
    """The int16 tier's quantization: round(a * 32767) (half to even),
    clipped to int16."""
    return np.clip(np.round(a * 32767.0), -32768, 32767).astype(np.int16)


class FileDataset:
    def __init__(
        self,
        path: str,
        effect,
        chunk_size: int,
        y_size: int | None = None,
        sr: int = 44100,
        rerun: bool = False,
        augment: bool = True,
        align_end: bool = True,
        compand: bool = False,
        device_resident_limit_bytes: int = 4 << 30,
        max_files: int = 100000,
    ):
        """The corpus of ``path`` for ``effect``, on the effect's device or in
        host memory, by its size (the module docstring)."""
        if rerun and isinstance(effect, FileEffect):
            raise ValueError("rerun (target type 'chunk') needs an effect with a signal path; "
                             f"{effect.name} has none")
        self.effect = effect
        self.chunk_size = chunk_size
        self.y_size = y_size if y_size is not None else chunk_size
        self.sr = sr
        self.rerun = rerun
        self.augment = augment
        self.compand = compand
        self.device = effect.device

        self.input_filenames = sorted(glob.glob(os.path.join(path, "input_*")))
        self.target_filenames = sorted(glob.glob(os.path.join(path, "target_*")))
        print(
            f"FileDataset: Found {len(self.input_filenames)} input files and "
            f"{len(self.target_filenames)} target files in path {path}"
        )
        if len(self.input_filenames) != len(self.target_filenames):
            raise ValueError(f"input/target file count mismatch in {path}")
        if not self.input_filenames:
            raise ValueError(f"no input_* files found in {path}")

        n_files = min(max_files, len(self.input_filenames))
        xs, ys, knobs = [], [], []
        for i in range(n_files):
            x, _ = audio_io.read_audio_file(self.input_filenames[i], sr=sr, warn=False)
            y, _ = audio_io.read_audio_file(self.target_filenames[i], sr=sr, warn=False)
            if len(x) != len(y):
                if align_end:
                    minlen = min(len(x), len(y))
                    x, y = x[-minlen:], y[-minlen:]
            if effect.is_inverse:
                x, y = y, x
            if compand:
                x, y = mu_compand_np(x), mu_compand_np(y)
            xs.append(x)
            ys.append(y)
            knobs.append(parse_knob_string(self.target_filenames[i]))

        self.knobs_nn = knobs_nn_from_wc(np.stack(knobs),
                                         np.asarray(effect.knob_ranges, dtype=np.float32))

        self.lengths = np.array([len(x) for x in xs], dtype=np.int32)
        if int(self.lengths.min()) <= chunk_size:
            raise ValueError(f"every file must be longer than chunk_size={chunk_size}; "
                             f"shortest is {int(self.lengths.min())}")
        max_len = int(self.lengths.max())
        total_f32 = 2 * len(xs) * max_len * 4
        total_i16 = 2 * len(xs) * max_len * 2
        self.device_resident = total_f32 <= device_resident_limit_bytes
        self.device_resident_int16 = (
            not self.device_resident and total_i16 <= device_resident_limit_bytes
        )
        x_arr = np.zeros((len(xs), max_len), np.float32)
        y_arr = np.zeros((len(xs), max_len), np.float32)
        for i, (x, y) in enumerate(zip(xs, ys)):
            x_arr[i, : len(x)] = x
            y_arr[i, : len(y)] = y

        dev = self.device
        if self.device_resident:
            self.x = torch.from_numpy(x_arr).to(dev)
            self.y = torch.from_numpy(y_arr).to(dev)
        elif self.device_resident_int16:
            print(f"FileDataset: corpus ~{total_f32 / 1e9:.1f} GB as f32; "
                  f"storing int16 on {dev} (~{total_i16 / 1e9:.1f} GB)")
            self.x = torch.from_numpy(to_int16_tier(x_arr)).to(dev)
            self.y = torch.from_numpy(to_int16_tier(y_arr)).to(dev)
            self.device_resident = True
        else:
            print(f"FileDataset: corpus ~{total_f32 / 1e9:.1f} GB exceeds the device budget "
                  "even as int16; sampling on the host")
            self.x, self.y = x_arr, y_arr

        if self.device_resident:
            self._lengths = torch.from_numpy(self.lengths).to(dev)
            self._knobs = torch.from_numpy(np.ascontiguousarray(self.knobs_nn, np.float32)).to(dev)
            self._arange = torch.arange(chunk_size, dtype=torch.int64, device=dev)
            # a tensor, not a number: CUDA divides by a host number as a
            # multiplication by its reciprocal, an ulp off true division
            self._full_scale = torch.tensor(32767.0, dtype=torch.float32, device=dev)
        print("    ...finished preloading")

    # ------------------------------------------------ device-resident tiers

    def crop_starts(self, i: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Each example's crop start from its file i and a uniform u in [0, 1):
        min(int32(float32(u) * float32(limit)), limit - 1), limit = the file's
        length - chunk_size (the JAX sampler's arithmetic, in that order)."""
        limit = self._lengths[i] - self.chunk_size
        return torch.minimum((u * limit.to(torch.float32)).to(torch.int32), limit - 1)

    def crop(self, i: torch.Tensor, start: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(x, y) chunks (B, chunk_size) in float32 from files i at starts
        ``start``: one gather a corpus from the flattened (F, L) array; the
        int16 tier dequantizes after the gather."""
        idx = (i.to(torch.int64) * self.x.shape[1] + start.to(torch.int64))[:, None] + self._arange
        x, y = torch.take(self.x, idx), torch.take(self.y, idx)
        if self.x.dtype == torch.int16:
            x, y = x.to(torch.float32) / self._full_scale, y.to(torch.float32) / self._full_scale
        return x, y

    def batch_fn(self, batch: int, generator: torch.Generator):
        """(x (B, chunk), y (B, y_size), knobs (B, K)) on the device: a random
        file and crop start per example, the effect re-run on the crop with
        ``rerun``, y trimmed to its last y_size samples, then (with
        ``augment``) a random polarity flip; every draw from ``generator``."""
        if not self.device_resident:
            raise RuntimeError("corpus is host-resident; use host_batch / prefetch_batches")
        g = generator
        i = torch.randint(0, self.x.shape[0], (batch,), generator=g, device=g.device)
        u = torch.rand(batch, generator=g, device=g.device)
        x, y = self.crop(i, self.crop_starts(i, u))
        knobs = self._knobs[i]
        if self.rerun:  # the target re-made from each chunk alone
            y, x = self.effect.go_batch(x, knobs, generator=g)
        y = y[:, -self.y_size:]
        if self.augment:
            flip = torch.rand(batch, generator=g, device=g.device) < 0.5
            x, y = polarity_flip(x, y, flip)
        return x.float(), y.float().contiguous(), knobs

    # ----------------------------------------------------- host-resident tier

    def host_batch(self, batch_size: int, rng: np.random.Generator, rows: slice | None = None):
        """numpy (x, y, knobs) sampled on the host from ``rng`` (the
        host-resident tier). With ``rows`` (a data-parallel rank's
        ``mesh.local_rows``) every draw of the global batch of ``batch_size``
        is taken from ``rng`` as without it, and only those rows are
        cropped: the ranks' rows together are the global batch, bit for
        bit."""
        idx = rng.integers(0, len(self.lengths), size=batch_size)
        starts = [rng.integers(0, self.lengths[i] - self.chunk_size) for i in idx]
        keep = range(batch_size)[rows] if rows is not None else range(batch_size)
        x = np.empty((len(keep), self.chunk_size), np.float32)
        y = np.empty((len(keep), self.chunk_size), np.float32)
        for j, b in enumerate(keep):
            i, start = idx[b], starts[b]
            x[j] = self.x[i, start : start + self.chunk_size]
            y[j] = self.y[i, start : start + self.chunk_size]
        knobs = self.knobs_nn[idx[keep.start : keep.stop]]
        yb = y[:, -self.y_size :]
        if self.augment:
            sign = np.where(rng.random(batch_size) < 0.5, -1.0, 1.0).astype(np.float32)
            sign = sign[keep.start : keep.stop]
            x, yb = x * sign[:, None], yb * sign[:, None]
        return x, yb, knobs.astype(np.float32)

    def prefetch_batches(self, batch_size: int, rng: np.random.Generator,
                         n_slots: int = 2, rows: slice | None = None) -> _Prefetcher:
        """A producer thread running ``host_batch(batch_size, rng, rows)``
        into a ring of n_slots + 2 host buffers (pinned for a CUDA device),
        n_slots batches ahead: ``next()`` gives a ``HostBatch`` in the order
        that synchronous sampling from ``rng`` gives. Close it when done."""
        local = len(range(batch_size)[rows]) if rows is not None else batch_size
        shapes = [(local, self.chunk_size), (local, self.y_size),
                  (local, self.knobs_nn.shape[1])]
        ring = _PinnedRing(shapes, n_slots + 2, pin=self.device.type == "cuda")

        def close():
            ring.closed = True

        return _Prefetcher(lambda: ring.fill(self.host_batch(batch_size, rng, rows)),
                           n_slots=n_slots, on_close=close)
