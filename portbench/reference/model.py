"""The model, its loss, the front-end clip and Adam, in plain PyTorch.

A frozen copy of the program's math (``models/mpaec.py`` batch-major path,
``models/autoencoder.py``, ``ops/frontend.py`` gemm path, ``ops/framing.py``,
``training/loss.py``, ``training/train.py`` ``clip_frontend_grads`` and
``make_optimizer``, ``training/schedule.py`` ``one_cycle_fn``), written from
the state dict of ``portbench/weights.py`` alone.

``precision`` says how every matrix product runs (the elementwise work runs
in the product's dtype):

* ``"f64"``: float64 throughout; the reference.
* ``"tf32"``: float32 with each product's operands rounded to TF32 (10
  mantissa bits, to nearest) and summed in float32, as a TF32 tensor-core
  product is; the control of a float32 configuration.
* ``"fp8"``: float32 with each product's operands scaled to their largest
  magnitude and rounded to float8 e4m3, summed in float32, in the forward and
  in both gradient products; the control of a bfloat16 configuration.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f64", "tf32", "fp8")
FRONTEND_KEYS = ("mpaec.dft_analysis.conv_analysis_real.weight",
                 "mpaec.dft_analysis.conv_analysis_imag.weight",
                 "mpaec.dft_synthesis.conv_synthesis_real.weight",
                 "mpaec.dft_synthesis.conv_synthesis_imag.weight")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), held in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> e4m3 with one scale for the tensor, held in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Rounded(torch.autograd.Function):
    """a @ b with both operands rounded by ``rnd`` in the forward, and the
    cotangent and the saved operands rounded in both gradient products."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ar, br = rnd(a), rnd(b)
        ctx.save_for_backward(ar, br)
        ctx.rnd = rnd
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = ctx.rnd(g)
        da = gr @ br.transpose(-1, -2)
        db = (ar.reshape(-1, ar.shape[-1]).t() @ gr.reshape(-1, gr.shape[-1]))
        return da, db, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., K) @ b (K, N) in ``precision``."""
    if precision == "f64":
        return a @ b
    rnd = round_tf32 if precision == "tf32" else round_fp8
    shape = a.shape
    out = _Rounded.apply(a.reshape(-1, shape[-1]), b, rnd)
    return out.reshape(*shape[:-1], b.shape[-1])


def frame(x: torch.Tensor, ft: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, T, ft): frames of x padded by ft zeros on both sides."""
    return F.pad(x, (ft, ft)).unfold(-1, ft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, ft) -> (B, (T-1)*hop + ft), the adjoint of ``frame``."""
    b, t, ft = frames.shape
    nb = -(-ft // hop)
    fr = F.pad(frames, (0, nb * hop - ft)).reshape(b, t, nb, hop)
    acc = frames.new_zeros((b, t + nb - 1, hop))
    for j in range(nb):
        acc = acc + F.pad(fr[:, :, j, :], (0, 0, j, nb - 1 - j))
    return acc.reshape(b, -1)[:, : (t - 1) * hop + ft]


def analysis_operand(p: dict, half: int) -> torch.Tensor:
    """(ft, 2*half): the used rows of the real and imaginary analysis matrices."""
    wr, wi = p[FRONTEND_KEYS[0]][:, 0, :], p[FRONTEND_KEYS[1]][:, 0, :]
    return torch.cat([wr[:half], wi[:half]], dim=0).t()


def synthesis_operand(p: dict, half: int) -> torch.Tensor:
    """(2*half, ft): the synthesis rows with the conjugate mirror folded in."""
    wr, wi = p[FRONTEND_KEYS[2]][:, 0, :], p[FRONTEND_KEYS[3]][:, 0, :]
    fr = torch.cat([wr[:1], wr[1 : half - 1] + torch.flip(wr[half:], dims=[0]), wr[half - 1 : half]])
    fi = torch.cat([wi[:1], wi[1 : half - 1] - torch.flip(wi[half:], dims=[0]), wi[half - 1 : half]])
    return torch.cat([fr, fi], dim=0)


def autoencoder(p: dict, prefix: str, x: torch.Tensor, knobs: torch.Tensor, skip: str,
                out_frames: int, precision: str) -> torch.Tensor:
    """(B, T, F) -> (B, OT, F): nine affine layers over the frame axis with
    ELUs, the knobs joined at the bottleneck, the output skip ``sf``
    (multiplied by the input's last frames) or none."""

    def dense(name, z):
        w, b = p[f"{prefix}.{name}.weight"], p[f"{prefix}.{name}.bias"]
        return mm(z, w.t(), precision) + b

    xi = x.transpose(1, 2)
    z = F.elu(dense("fnn_enc", xi))
    for name in ("fnn_enc2", "fnn_enc3", "fnn_enc4"):
        z = F.elu(dense(name, z))
    k = knobs[:, None, :].to(z.dtype).expand(z.shape[0], z.shape[1], knobs.shape[-1])
    z = torch.cat((z, k), dim=2)
    for name in ("fnn_addknobs", "fnn_dec4", "fnn_dec3", "fnn_dec2"):
        z = F.elu(dense(name, z))
    dec = dense("fnn_dec", z)
    out = F.elu(dec) * xi[:, :, -out_frames:] if skip == "sf" else F.elu(dec)
    return out.transpose(1, 2)


def forward(p: dict, x: torch.Tensor, knobs: torch.Tensor, config: dict, precision: str):
    """(y_hat (B, out), mag (B, T, F), mag_hat (B, OT, F)) of x (B, chunk)."""
    ft, hop, ot = config["ft_size"], config["hop_size"], config["output_time_frames"]
    half = ft // 2 + 1
    dt = dtype_of(precision)
    p = {k: v.to(dt) for k, v in p.items()}
    x = x.to(dt)
    knobs = knobs.to(dt)
    spec = mm(frame(x / 2, ft, hop), analysis_operand(p, half), precision)
    re, im = spec[..., :half], spec[..., half:]
    mag = torch.sqrt(torch.clamp_min(re * re + im * im, 1e-36))
    phs = torch.atan2(im, re + 1e-7)
    mag_hat = autoencoder(p, "mpaec.aenc", mag, knobs, "sf", ot, precision)
    phs_hat = autoencoder(p, "mpaec.phs_aenc", phs, knobs, "", ot, precision) + phs[:, -ot:, :]
    spec_out = torch.cat([mag_hat * torch.cos(phs_hat), mag_hat * torch.sin(phs_hat)], dim=-1)
    wave = overlap_add(mm(spec_out, synthesis_operand(p, half), precision), hop)
    wave = wave[:, ft : wave.shape[1] - ft]
    y_hat = wave + x[:, -wave.shape[-1]:] / 2
    return 2 * y_hat, mag, mag_hat


def loss(y_hat: torch.Tensor, y: torch.Tensor, mag_hat: torch.Tensor) -> torch.Tensor:
    """log-cosh of the residual plus the frequency-weighted spectral L1
    (lambda 2e-5 / 10, weights exp(7/bins * bin))."""
    z = torch.abs(y.to(y_hat.dtype) - y_hat)
    rec = torch.mean(z + torch.log1p(torch.exp(-2.0 * z)) - math.log(2.0))
    n = mag_hat.shape[-1]
    scale = torch.exp((7.0 / n) * torch.arange(n, dtype=mag_hat.dtype, device=mag_hat.device))
    return rec + (2e-5 / 10.0) * torch.mean(torch.abs(mag_hat * scale))


def one_cycle_lr(lr_max: float, n_data_points: int, epochs: int, batch_size: int):
    """fn(step) -> the 1cycle learning rate (cosine up over the first 30%
    from lr_max / 15, cosine down to lr_max / 1500)."""
    lr_start = lr_max / 15.0
    lr_end = lr_start / 1e2
    n_iter = n_data_points * epochs // batch_size
    a1 = int(n_iter * 0.3)
    a2 = n_iter - a1

    def lr_at(step):
        i = float(min(int(step), n_iter - 1))
        if i < a1:
            return float((lr_max - lr_start) * (1 - np.cos(np.pi * i / max(a1 - 1, 1))) / 2
                         + lr_start)
        j = i - a1
        return float((lr_max - lr_end) * (1 + np.cos(np.pi * j / max(a2 - 1, 1))) / 2 + lr_end)

    return lr_at


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) over a dict of
    tensors, in their dtype."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def clip_frontend(grads: dict, max_norm: float = 1.0) -> None:
    """Scale the four front-end gradients by min(1, max_norm / (L1 + 1e-6))."""
    total = sum(grads[k].abs().sum() for k in FRONTEND_KEYS)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for k in FRONTEND_KEYS:
        grads[k] = grads[k] * coef


def train_steps(state: dict, batches, lrs, config: dict, precision: str, rows=None):
    """Run one Adam step a batch from ``state`` (the initial weights, float32)
    in ``precision``. ``rows`` (or None) keeps that many rows of each batch,
    the fault that leaves part of a batch out. Returns (losses, first_grads,
    params): each step's loss, the clipped gradients of the first step (what
    Adam is given), and the parameters after the last step, float64 on the
    weights' device."""
    dt = dtype_of(precision)
    params = {k: v.detach().to(dt).clone() for k, v in state.items()}
    opt = Adam(params)
    losses, first = [], None
    for (x, y, knobs), lr in zip(batches, lrs):
        if rows is not None:
            x, y, knobs = x[:rows], y[:rows], knobs[:rows]
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        y_hat, _, mag_hat = forward(leaves, x, knobs, config, precision)
        l = loss(y_hat, y, mag_hat)
        grads = dict(zip(leaves, torch.autograd.grad(l, list(leaves.values()))))
        clip_frontend(grads)
        if first is None:
            first = {k: g.detach().double() for k, g in grads.items()}
        with torch.no_grad():
            opt.step(params, grads, lr)
        losses.append(float(l.detach()))
    return losses, first, {k: v.double() for k, v in params.items()}


@torch.no_grad()
def predict_long(state: dict, signal: torch.Tensor, knobs: torch.Tensor, config: dict,
                 precision: str, block: int = 512) -> torch.Tensor:
    """The whole output of serving a 1-D signal: windows of chunk samples
    every out_chunk samples (the tail zero-padded so the windows tile it),
    each window's last out_chunk output samples in order, cut to
    len(signal) - (chunk - out_chunk). Run ``block`` windows at a time.
    A frozen copy of ``inference/predict_long.py`` for a signal of at least
    one window."""
    chunk, out = config["in_chunk_size"], config["out_chunk_size"]
    overlap = chunk - out
    n = int(signal.shape[-1])
    if n <= chunk:
        raise ValueError("the reference serves signals longer than one window")
    rem = (n - chunk) % out
    padded = F.pad(signal, (0, 0 if rem == 0 else out - rem))
    windows = padded.unfold(0, chunk, out)
    params = {k: v.to(dtype_of(precision)) for k, v in state.items()}
    outs = []
    for s in range(0, windows.shape[0], block):
        w = windows[s : s + block]
        k = knobs[None, :].expand(w.shape[0], -1)
        outs.append(forward(params, w, k, config, precision)[0].reshape(-1))
    y = torch.cat(outs)
    n_win = windows.shape[0]
    keep = n_win * out - max(0, chunk + (n_win - 1) * out - n)
    return y[:keep]
