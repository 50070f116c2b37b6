"""Long-audio inference: overlapped windows through the model.

Counterpart of signaltrain_tpu/inference/predict_long.py (the reference's
utils/predict_long.py:30-97). The signal is cut into windows of chunk_size
samples every out_chunk_size samples (the tail zero-padded so the windows
tile it); each window predicts its last out_chunk_size samples; the outputs
are concatenated and the zero-pad tail of the last window is trimmed. The
result has length len(signal) - (chunk_size - out_chunk_size) and starts at
sample chunk_size - out_chunk_size of the signal (the caller zero-pads the
head to align it).

The windows are a strided view of the signal on the model's device
(``ops/framing.sliding_window``); they run
exactly, with no bucketing (the JAX package rounds the count up only to bound
XLA recompiles), in super-batches of at most 1024 windows to bound memory.

With ``mesh`` (``parallel/mesh.py``) the window axis is split over the data
ranks, as the JAX package shards it over ``'data'``: the window count is
rounded up to a multiple of ``n_data`` (the pad windows are zeros, and are
trimmed), each rank runs its contiguous share in super-batches, and the
shares are combined by one all-reduce (sum) of a zero-filled output of every
window (gloo has no ``all_gather`` of CUDA tensors; adding zeros is exact).
Every rank returns the whole signal.

A signal no longer than the lookback (chunk_size - out_chunk_size) has no
full output window. For it the port returns what the JAX package returns:
the model's output over ``MIN_BUCKET`` windows of the zero-padded signal (its
smallest bucket), cut where a negative ``keep`` cuts it, counted from the end
(1,964 samples for 300 at chunk 512 / out 128).

A call is the span ``predict_long`` (``utils/profiling.py``; its id a
process-wide request number) around ``predict_long.upload``, one
``predict_long.super_batch`` a super-batch, ``predict_long.join`` (the
concatenation, with a mesh the ``predict_long.all_reduce`` inside it, the
cut and the PCM conversion) and ``predict_long.pull``. On a card the
request counts ``device_allocs`` (the caching allocator's ``cudaMalloc``
calls, read only while spans record).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..data import audio_io
from ..dsp.compressors import mu_compand
from ..ops import framing
from ..utils import profiling

SUPER_BATCH = 1024  # windows per forward
MIN_BUCKET = 16  # the JAX package's smallest window bucket


def _num_windows(length: int, size: int, overlap: int) -> int:
    step = size - overlap
    remainder = (length - size) % step
    padded = length if remainder == 0 else length + step - remainder
    return (padded - size) // step + 1


def predict_long(signal, knobs_nn, model, chunk_size: int | None = None,
                 out_chunk_size: int | None = None, compand: bool = False,
                 return_device: bool = False, out_dtype=None, mesh=None):
    """Process a 1-D signal on the model's device (with ``mesh``, its windows
    split over the ranks; module docstring).

    ``signal`` and ``knobs_nn`` may be numpy arrays or tensors.
    ``return_device=True`` returns the tensor on the model's device instead of
    a numpy array; ``out_dtype="int16"`` converts to 16-bit PCM on the device
    first (the only conversion offered)."""
    if out_dtype is not None and np.dtype(out_dtype) != np.int16:
        raise ValueError(f"predict_long: out_dtype must be None or int16, got {out_dtype}")
    with profiling.span("predict_long", next(_REQUESTS)):
        allocs = _device_allocs(model.device) if profiling.active() else None
        y = _predict_long(signal, knobs_nn, model, chunk_size, out_chunk_size, compand,
                          return_device, out_dtype, mesh)
        if allocs is not None:
            profiling.count("device_allocs", _device_allocs(model.device) - allocs)
    return y


_REQUESTS = itertools.count()


def _device_allocs(dev: torch.device) -> int:
    """The caching allocator's cudaMalloc calls on ``dev`` so far (0 off a card)."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats_as_nested_dict(dev).get("num_device_alloc", 0)


def _predict_long(signal, knobs_nn, model, chunk_size, out_chunk_size, compand, return_device,
                  out_dtype, mesh):
    dev = model.device
    chunk_size = chunk_size or model.spec.in_chunk_size
    out_chunk_size = out_chunk_size or model.spec.out_chunk_size
    with profiling.span("predict_long.upload"):
        signal = torch.as_tensor(signal, dtype=torch.float32).to(dev)
        knobs = torch.as_tensor(knobs_nn, dtype=torch.float32).to(dev)

    overlap = chunk_size - out_chunk_size
    length = int(signal.shape[-1])
    n_windows = _num_windows(length, chunk_size, overlap)
    n_real = n_windows
    if n_windows < 1:  # no full output window: run the JAX package's bucket
        n_real = MIN_BUCKET
        signal = torch.nn.functional.pad(
            signal, (0, chunk_size + (n_real - 1) * out_chunk_size - length))
    windows = framing.sliding_window(signal, chunk_size, overlap)  # (n_real, chunk) view
    n_data = 1 if mesh is None else mesh.n_data
    n_run = -(-n_real // n_data) * n_data
    if n_run > n_real:  # pad windows of zeros, so that the ranks' shares are equal
        windows = torch.cat([windows, windows.new_zeros(n_run - n_real, chunk_size)])
    share = n_run // n_data
    first = 0 if mesh is None else mesh.data_index * share

    outs = []
    with torch.inference_mode():
        for start in range(first, first + share, SUPER_BATCH):
            with profiling.span("predict_long.super_batch"):
                x = windows[start : min(start + SUPER_BATCH, first + share)]
                x = mu_compand(x) if compand else x.contiguous()
                kb = knobs[None, :].expand(x.shape[0], knobs.shape[-1])
                y_hat, _, _ = model(x, kb)
                outs.append(y_hat.reshape(-1))
    with profiling.span("predict_long.join"):
        with torch.inference_mode():
            y = torch.cat(outs)
        if mesh is not None:
            with profiling.span("predict_long.all_reduce"):
                # every window's output, zeros but for this rank's share; summed out of
                # inference mode, as the collective writes into it from its own thread
                full = torch.zeros(n_run * out_chunk_size, dtype=y.dtype, device=y.device)
                full[first * out_chunk_size : (first + share) * out_chunk_size] = y
                y = mesh.all_reduce(full)
        unique = chunk_size + (n_windows - 1) * out_chunk_size
        keep = n_windows * out_chunk_size - max(0, unique - length)
        y = y[:keep]  # keep <= 0 (no full window) counts from the end, as in JAX
        if out_dtype is not None:
            y = audio_io.to_pcm16(y)
    if return_device:
        return y
    with profiling.span("predict_long.pull"):
        return y.cpu().numpy()


def calc_ct(signal, effect, knobs_wc, out_chunk_size: int, chunk_size: int, sr: int = 44100,
            generator: torch.Generator | None = None):
    """The chunked target: the effect applied window by window, keeping each
    window's last out_chunk_size samples, as the model sees it. Every window
    draws from ``generator``'s state at entry (on the effect's device; None
    gives one seeded with 0), as the JAX function passes its one key to every
    window: a drawing effect (``effect.draws``: Denoise, TimeAlign) runs its
    windows one by one from that state, so all full-length windows get the
    same draws; any other runs its full-length windows as one batch on the
    effect's device. The shorter windows at the end run one by one. ``sr`` is
    unused, kept so that calls written for the JAX function's signature
    ``(signal, effect, knobs_wc, out_chunk_size, chunk_size, sr, key)`` run
    unchanged. Returns numpy."""
    del sr
    lookback_size = chunk_size - out_chunk_size
    if lookback_size < 0:
        return None
    if generator is None:
        generator = torch.Generator(device=effect.device).manual_seed(0)
    state = generator.get_state()
    signal = np.asarray(signal, np.float32)
    padded_sig = np.concatenate((np.zeros(lookback_size, dtype=np.float32), signal))
    y_ct = np.zeros(len(padded_sig), dtype=np.float32)
    starts = np.arange(0, len(padded_sig), out_chunk_size)
    full = [int(i) for i in starts if i + chunk_size <= len(padded_sig)]
    rest = [int(i) for i in starts if i + chunk_size > len(padded_sig)]

    def place(i, out_chunk):
        iend = min(i + chunk_size, len(padded_sig))
        if len(out_chunk) > out_chunk_size:
            out_chunk = out_chunk[-out_chunk_size:]
        y_ct[iend - len(out_chunk) : iend] = out_chunk

    if full and not effect.draws:
        sig_dev = torch.as_tensor(padded_sig).to(effect.device)
        batch = sig_dev.unfold(0, chunk_size, out_chunk_size)[: len(full)].contiguous()
        out, _ = effect.go_wc(batch, knobs_wc, generator)
        out = out.cpu().numpy()
        for row, i in enumerate(full):
            place(i, out[row])
        full = []
    for i in full + rest:
        generator.set_state(state)
        out, _ = effect.go_wc(padded_sig[i : i + chunk_size], knobs_wc, generator)
        place(i, out.cpu().numpy())
    return y_ct[lookback_size:]
