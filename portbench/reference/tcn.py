"""TCN-300-C, its loss and Adam, in plain PyTorch: the reference of the
``train-tcn300c-f32`` cell.

A frozen copy of the program's math (``models/tcn.py``, ``training/loss.py``
``logcosh``, ``training/train.py`` ``make_optimizer``; arXiv:2102.06200,
TCN-300-C), written from the state dict of ``portbench/weights_tcn.py``
alone: the conditioning MLP, each block's dilated convolution (no bias, no
padding), BatchNorm without affine on the batch's statistics (eps 1e-5),
FiLM, PReLU and the 1x1 residual cropped to its last samples (its centre for
a configuration that is not causal), and tanh of the 1x1 output. Each
convolution is a sum over its taps of channel products, tap k reading the
input from k * dilation. The departures from the paper are the program's:
comp_4c's 4 knobs (in [-0.5, 0.5]) for the LA-2A's 2, the log-cosh loss,
comp_4c data.

``precision`` says how the convolutions' products run (the rest runs in
their dtype):

* ``"f64"``: float64 throughout; the reference.
* ``"tf32"``: float32 with each channel product's operands (the dilated
  convolutions', the output's and the first block's residual, which mixes
  no channels but has one input channel) rounded to TF32 (10 mantissa bits,
  to nearest) and summed in float32, as a TF32 tensor-core product is, in the
  forward and in both gradient products; the control of the float32 cell.

``fault`` puts one of the faults that the calibration reads in the
program's place: ``"film_dropped"`` (g = 1, b = 0: the knobs ignored) or
``"bn_running"`` (BatchNorm on its running statistics in training).
"""

from __future__ import annotations

import math

import torch

from .model import Adam, one_cycle_lr, round_tf32  # noqa: F401  (one_cycle_lr: the drivers')

PRECISIONS = ("f64", "tf32")
FAULTS = (None, "film_dropped", "bn_running")
EPS = 1e-5


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def _taps(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """(B, Cin, N) * (Cout, Cin, K) at dilation d -> (B, Cout, N - (K - 1) d)."""
    n = x.shape[-1] - (w.shape[-1] - 1) * d
    out = w[:, :, 0] @ x[..., :n]
    for k in range(1, w.shape[-1]):
        out = out + w[:, :, k] @ x[..., k * d : k * d + n]
    return out


class _Conv(torch.autograd.Function):
    """``_taps`` with both operands rounded by ``rnd``, and the cotangent and
    the saved operands rounded in both gradient products."""

    @staticmethod
    def forward(ctx, x, w, d, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.d, ctx.rnd = d, rnd
        return _taps(xr, wr, d)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rnd(g.contiguous())
        d, n = ctx.d, g.shape[-1]
        dx = torch.zeros_like(xr) if ctx.needs_input_grad[0] else None
        dw = torch.empty_like(wr)
        for k in range(wr.shape[-1]):
            xk = xr[..., k * d : k * d + n]
            if dx is not None:
                dx[..., k * d : k * d + n] += wr[:, :, k].t() @ gr
            dw[:, :, k] = (gr @ xk.transpose(1, 2)).sum(0)
        return dx, dw, None, None


def conv(x: torch.Tensor, w: torch.Tensor, d: int, precision: str) -> torch.Tensor:
    rnd = round_tf32 if precision == "tf32" else (lambda t: t)
    return _Conv.apply(x, w, d, rnd)


def forward(p: dict, x: torch.Tensor, knobs: torch.Tensor, config: dict, precision: str,
            fault: str | None = None) -> torch.Tensor:
    """y_hat (B, out) of x (B, in) in training mode (the batch's statistics)."""
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    dt = dtype_of(precision)
    p = {k: v.to(dt) if v.is_floating_point() else v for k, v in p.items()}
    c = knobs.to(dt)
    for i in (0, 2, 4):
        c = torch.relu(c @ p[f"gen.{i}.weight"].t() + p[f"gen.{i}.bias"])
    h = x.to(dt)[:, None, :]
    for i in range(config["n_blocks"]):
        pre = f"blocks.{i}."
        u = conv(h, p[pre + "conv1.weight"], config["dilation_growth"] ** i, precision)
        if fault == "bn_running":
            mean, var = p[pre + "film.bn.running_mean"], p[pre + "film.bn.running_var"]
        else:
            mean, var = u.mean((0, 2)), u.var((0, 2), unbiased=False)
        z = (u - mean[:, None]) / torch.sqrt(var[:, None] + EPS)
        if fault != "film_dropped":
            gb = c @ p[pre + "film.adaptor.weight"].t() + p[pre + "film.adaptor.bias"]
            g, b = gb.chunk(2, dim=1)
            z = z * g[:, :, None] + b[:, :, None]
        z = torch.where(z >= 0, z, p[pre + "relu.weight"][:, None] * z)
        w_res = p[pre + "res.weight"]
        r = conv(h, w_res, 1, precision) if h.shape[1] == 1 else w_res[:, 0] * h
        n = z.shape[-1]
        start = r.shape[-1] - n if config["causal"] else (r.shape[-1] - n) // 2
        h = z + r[..., start : start + n]
    y = conv(h, p["output.weight"], 1, precision) + p["output.bias"][:, None]
    return torch.tanh(y[:, 0, :])


def loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log-cosh of the residual, its mean."""
    z = torch.abs(y.to(y_hat.dtype) - y_hat)
    return torch.mean(z + torch.log1p(torch.exp(-2.0 * z)) - math.log(2.0))


def parameter_names(state: dict) -> list[str]:
    """The state dict's parameters: its floating entries but BatchNorm's statistics."""
    return [k for k, v in state.items() if v.is_floating_point() and ".bn." not in k]


def train_steps(state: dict, batches, lrs, config: dict, precision: str, fault=None):
    """One Adam step a batch from ``state`` (the initial weights, float32) in
    ``precision``. Returns (losses, first_grads, params): each step's loss,
    the first step's gradients (what Adam is given), and the parameters
    after the last step, float64 on the weights' device."""
    dt = dtype_of(precision)
    names = parameter_names(state)
    params = {k: state[k].detach().to(dt).clone() for k in names}
    stats = {k: v for k, v in state.items() if k not in params}
    opt = Adam(params)
    losses, first = [], None
    for (x, y, knobs), lr in zip(batches, lrs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        l = loss(forward({**stats, **leaves}, x, knobs, config, precision, fault), y)
        got = torch.autograd.grad(l, list(leaves.values()), allow_unused=True)  # a fault's
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), got)}
        if first is None:
            first = {k: g.detach().double() for k, g in grads.items()}
        with torch.no_grad():
            opt.step(params, grads, lr)
        losses.append(float(l.detach()))
    return losses, first, {k: v.double() for k, v in params.items()}
