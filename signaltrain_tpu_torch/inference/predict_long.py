"""Long-audio inference: overlapped windows through the model.

Counterpart of signaltrain_tpu/inference/predict_long.py (the reference's
utils/predict_long.py:30-97). The signal is cut into windows of chunk_size
samples every out_chunk_size samples (the tail zero-padded so the windows
tile it); each window predicts its last out_chunk_size samples; the outputs
are placed end to end and the zero-pad tail of the last window is trimmed. The
result has length len(signal) - (chunk_size - out_chunk_size) and starts at
sample chunk_size - out_chunk_size of the signal (the caller zero-pads the
head to align it).

The windows are a strided view of the signal on the model's device
(``ops/framing.sliding_window``); they run
exactly, with no bucketing (the JAX package rounds the count up only to bound
XLA recompiles), in super-batches of at most 1024 windows to bound memory.
Each super-batch's output is cut to what survives the trim (and converted
to PCM there under ``out_dtype="int16"``, elementwise, so bit-equal to
converting the whole); once every forward is queued, the result is
allocated at its final length and each part is placed in it.

On a card, when the caller takes a numpy array (not ``return_device``, no
``mesh``), the result is a pinned host tensor from PyTorch's caching host
allocator (``torch.empty(..., pin_memory=True)``; a new block is pinned
while the card runs the queued forwards), and each part is copied into it
on a copy stream (one a device) that waits for the event recorded after the
forward that made it: the copies of the finished super-batches run on a
copy engine while the later ones compute, and the host waits only for the
copy stream's last event. The parts the copy stream reads stay alive until
then. The returned array lives in that pinned block until the caller drops
it; the allocator then hands the block (sizes rounded up to a power of two)
to a later request. Otherwise (off a card, or with ``return_device`` or a
mesh) the result is formed on the model's device and, but for
``return_device``, copied to the host at the end.

With ``mesh`` (``parallel/mesh.py``) the window axis is split over the data
ranks, as the JAX package shards it over ``'data'``: the window count is
rounded up to a multiple of ``n_data`` (the pad windows are zeros, and are
trimmed), each rank runs its contiguous share in super-batches, and the
shares are combined by one all-reduce (sum) of a zero-filled output of every
window, into which each rank places its super-batches (gloo has no
``all_gather`` of CUDA tensors; adding zeros is exact). Every rank returns
the whole signal.

A signal no longer than the lookback (chunk_size - out_chunk_size) has no
full output window. For it the port returns what the JAX package returns:
the model's output over ``MIN_BUCKET`` windows of the zero-padded signal (its
smallest bucket), cut where a negative ``keep`` cuts it, counted from the end
(1,964 samples for 300 at chunk 512 / out 128).

A call is the span ``predict_long`` (``utils/profiling.py``; its id a
process-wide request number) around ``predict_long.upload``, one
``predict_long.super_batch`` a super-batch (its forward and its cut part),
``predict_long.join`` (the result's allocation and the parts placed in it
or their copies queued; with a mesh the ``predict_long.all_reduce`` inside
it, the cut and the PCM conversion) and ``predict_long.pull`` (the wait for
the copy stream, or the copy to the host). On a card the request counts
``device_allocs`` (the caching allocator's ``cudaMalloc`` calls) and, when
its result is pinned, ``pinned_allocs`` (the caching host allocator's new
blocks: the reuse failed, as the caller still holds an earlier result of
the size), both read only while spans record.
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
    first (the only conversion offered). On a card the numpy array is pulled
    through a copy stream into pinned memory from PyTorch's caching host
    allocator, and holds that block until the caller drops it."""
    if out_dtype is not None and np.dtype(out_dtype) != np.int16:
        raise ValueError(f"predict_long: out_dtype must be None or int16, got {out_dtype}")
    pinned = model.device.type == "cuda" and not return_device and mesh is None
    with profiling.span("predict_long", next(_REQUESTS)):
        allocs = _device_allocs(model.device) if profiling.active() else None
        host = _pinned_allocs() if pinned and allocs is not None else None
        y = _predict_long(signal, knobs_nn, model, chunk_size, out_chunk_size, compand,
                          return_device, out_dtype, mesh, pinned)
        if allocs is not None:
            profiling.count("device_allocs", _device_allocs(model.device) - allocs)
        if host is not None:
            profiling.count("pinned_allocs", _pinned_allocs() - host)
    return y


_REQUESTS = itertools.count()


def _device_allocs(dev: torch.device) -> int:
    """The caching allocator's cudaMalloc calls on ``dev`` so far (0 off a card)."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats_as_nested_dict(dev).get("num_device_alloc", 0)


def _pinned_allocs() -> int:
    """The caching host allocator's new pinned blocks so far."""
    return torch.cuda.host_memory_stats().get("num_host_alloc", 0)


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    """The stream that pulls the card's outputs into pinned memory, one a
    device, made at first use."""
    if dev not in _COPY_STREAMS:
        _COPY_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _COPY_STREAMS[dev]


_COPY_STREAMS: dict = {}


def _predict_long(signal, knobs_nn, model, chunk_size, out_chunk_size, compand, return_device,
                  out_dtype, mesh, pinned):
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
    unique = chunk_size + (n_windows - 1) * out_chunk_size
    keep = n_windows * out_chunk_size - max(0, unique - length)
    # a mesh sums every window's output before the cut [:keep]; else only what it keeps
    n_out = (n_run * out_chunk_size if mesh is not None
             else len(range(n_real * out_chunk_size)[:keep]))

    parts = []  # (where a super-batch's output starts in the result, its part, its event)
    with torch.inference_mode():
        for start in range(first, first + share, SUPER_BATCH):
            with profiling.span("predict_long.super_batch"):
                x = windows[start : min(start + SUPER_BATCH, first + share)]
                x = mu_compand(x) if compand else x.contiguous()
                kb = knobs[None, :].expand(x.shape[0], knobs.shape[-1])
                y_hat, _, _ = model(x, kb)
                lo = start * out_chunk_size
                y = y_hat.reshape(-1)[: max(0, n_out - lo)]
                if mesh is None and out_dtype is not None:
                    y = audio_io.to_pcm16(y)
                done = torch.cuda.current_stream(dev).record_event() if pinned else None
                parts.append((lo, y, done))
    with profiling.span("predict_long.join"):
        if pinned:  # pinned while the card runs the forwards; each part copied once it is done
            result = torch.empty(n_out, dtype=parts[0][1].dtype, pin_memory=True)
            copy = _copy_stream(dev)
            with torch.cuda.stream(copy):
                for lo, y, done in parts:
                    copy.wait_event(done)
                    result[lo : lo + len(y)].copy_(y, non_blocking=True)
            done = copy.record_event()
        else:  # with a mesh, zeros but for this rank's share: the all-reduce sums the shares
            y0 = parts[0][1]
            result = y0.new_zeros(n_out) if mesh is not None else y0.new_empty(n_out)
            for lo, y, _ in parts:
                result[lo : lo + len(y)] = y
        if mesh is not None:
            with profiling.span("predict_long.all_reduce"):
                # summed out of inference mode, as the collective writes into it from its
                # own thread
                result = mesh.all_reduce(result)[:keep]  # keep <= 0 counts from the end, as in JAX
            if out_dtype is not None:
                result = audio_io.to_pcm16(result)
    if return_device:
        return result
    with profiling.span("predict_long.pull"):
        if pinned:
            done.synchronize()
            return result.numpy()
        return result.cpu().numpy()


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
