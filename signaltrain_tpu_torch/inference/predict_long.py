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

A signal no longer than the lookback (chunk_size - out_chunk_size) has no
full output window. For it the port returns what the JAX package returns:
the model's output over ``MIN_BUCKET`` windows of the zero-padded signal (its
smallest bucket), cut where a negative ``keep`` cuts it, counted from the end
(1,964 samples for 300 at chunk 512 / out 128).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import audio_io
from ..dsp.compressors import mu_compand
from ..ops import framing

SUPER_BATCH = 1024  # windows per forward
MIN_BUCKET = 16  # the JAX package's smallest window bucket


def _num_windows(length: int, size: int, overlap: int) -> int:
    step = size - overlap
    remainder = (length - size) % step
    padded = length if remainder == 0 else length + step - remainder
    return (padded - size) // step + 1


def predict_long(signal, knobs_nn, model, chunk_size: int | None = None,
                 out_chunk_size: int | None = None, compand: bool = False,
                 return_device: bool = False, out_dtype=None):
    """Process a 1-D signal on the model's device.

    ``signal`` and ``knobs_nn`` may be numpy arrays or tensors.
    ``return_device=True`` returns the tensor on the model's device instead of
    a numpy array; ``out_dtype="int16"`` converts to 16-bit PCM on the device
    first (the only conversion offered)."""
    if out_dtype is not None and np.dtype(out_dtype) != np.int16:
        raise ValueError(f"predict_long: out_dtype must be None or int16, got {out_dtype}")
    dev = model.device
    chunk_size = chunk_size or model.spec.in_chunk_size
    out_chunk_size = out_chunk_size or model.spec.out_chunk_size
    signal = torch.as_tensor(signal, dtype=torch.float32).to(dev)
    knobs = torch.as_tensor(knobs_nn, dtype=torch.float32).to(dev)

    overlap = chunk_size - out_chunk_size
    length = int(signal.shape[-1])
    n_windows = _num_windows(length, chunk_size, overlap)
    n_run = n_windows
    if n_windows < 1:  # no full output window: run the JAX package's bucket
        n_run = MIN_BUCKET
        signal = torch.nn.functional.pad(
            signal, (0, chunk_size + (n_run - 1) * out_chunk_size - length))
    windows = framing.sliding_window(signal, chunk_size, overlap)  # (n_run, chunk) view

    outs = []
    with torch.inference_mode():
        for start in range(0, n_run, SUPER_BATCH):
            x = windows[start : start + SUPER_BATCH]
            x = mu_compand(x) if compand else x.contiguous()
            kb = knobs[None, :].expand(x.shape[0], knobs.shape[-1])
            y_hat, _, _ = model(x, kb)
            outs.append(y_hat.reshape(-1))
        y = torch.cat(outs)
        unique = chunk_size + (n_windows - 1) * out_chunk_size
        keep = n_windows * out_chunk_size - max(0, unique - length)
        y = y[:keep]  # keep <= 0 (no full window) counts from the end, as in JAX
        if out_dtype is not None:
            y = audio_io.to_pcm16(y)
    return y if return_device else y.cpu().numpy()


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
