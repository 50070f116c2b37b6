"""Framing and overlap-add for the STFT front-end and long-audio windowing.

Framing is a strided view (``Tensor.unfold``): frame t of a signal padded by
``pad`` zeros on each side covers padded samples [t*hop, t*hop + ft), the
receptive field of a Conv1d(kernel=ft, stride=hop, padding=pad). Overlap-add
is its adjoint, written as ceil(ft/hop) shifted adds of contiguous blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_frames(length: int, ft_size: int, hop_size: int, pad: int) -> int:
    """Number of frames a Conv1d(kernel=ft, stride=hop, padding=pad) emits."""
    return (length + 2 * pad - ft_size) // hop_size + 1


def frame_signal(x: torch.Tensor, ft_size: int, hop_size: int, pad: int) -> torch.Tensor:
    """(B, L) -> (B, T, ft_size) view of overlapping frames of the padded signal."""
    if pad > 0:
        x = F.pad(x, (pad, pad))
    if num_frames(x.shape[-1], ft_size, hop_size, 0) <= 0:
        raise ValueError(
            f"frame_signal: padded signal length {x.shape[-1]} is shorter "
            f"than ft_size={ft_size}; no full frame fits (pad={pad})"
        )
    return x.unfold(-1, ft_size, hop_size)


def overlap_add(frames: torch.Tensor, hop_size: int) -> torch.Tensor:
    """(B, T, ft) -> (B, (T-1)*hop + ft): ConvTranspose1d(stride=hop) of the
    per-frame signals. Each frame is cut into ceil(ft/hop) blocks of hop
    samples; block j of frame t lands on output block t + j."""
    b, t, ft = frames.shape
    n_blocks = -(-ft // hop_size)
    padded_ft = n_blocks * hop_size
    if padded_ft != ft:
        frames = F.pad(frames, (0, padded_ft - ft))
    sub = frames.reshape(b, t, n_blocks, hop_size)
    acc = frames.new_zeros((b, t + n_blocks - 1, hop_size))
    for j in range(n_blocks):
        acc[:, j : j + t] += sub[:, :, j, :]
    return acc.reshape(b, -1)[:, : (t - 1) * hop_size + ft]


def sliding_window(x: torch.Tensor, size: int, overlap: int = 0) -> torch.Tensor:
    """1-D signal -> (n_windows, size) overlapping windows, tail zero-padded
    so the windows tile the signal:
        sliding_window(arange(10), 5, overlap=2) ==
            [[0 1 2 3 4], [3 4 5 6 7], [6 7 8 9 0]]
    A signal no longer than ``size`` gives one zero-padded window."""
    step = size - overlap
    length = x.shape[-1]
    if length <= size:
        return F.pad(x, (0, size - length))[None, :]
    remainder = (length - size) % step
    if remainder != 0:
        x = F.pad(x, (0, step - remainder))
    return x.unfold(0, size, step)


def undo_sliding_window(x: torch.Tensor, overlap: int, flatsize: int | None = None) -> torch.Tensor:
    """The inverse of ``sliding_window`` (n_windows, size) -> 1-D signal:
    the first window's overlap, then every window without its overlap, cut
    to ``flatsize`` if given. With no overlap ``x`` comes back as it is."""
    if overlap != 0:
        xnew = torch.cat((x[0, 0:overlap], x[:, overlap:].reshape(-1)))
        return xnew[0:flatsize] if flatsize is not None else xnew
    return x
