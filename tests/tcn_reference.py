"""TCN-300-C in plain PyTorch: the reference that the CPU tests hold
``signaltrain_tpu_torch/models/tcn.py`` to.

It imports neither JAX nor anything of ``signaltrain_tpu_torch``: it is
written from a state dict alone (micro-tcn's names: ``gen.{0,2,4}``,
``blocks.i.conv1``, ``blocks.i.film.bn``, ``blocks.i.film.adaptor``,
``blocks.i.relu``, ``blocks.i.res``, ``output``), in float64 or float32,
with no kernels, graphs or batching. The layers are C. J. Steinmetz and J.
D. Reiss, arXiv:2102.06200 (TCN-300-C; github.com/csteinmetz1/micro-tcn):

    c       = ReLU(L3 ReLU(L2 ReLU(L1 p)))
    u       = conv1d(h, W_i, dilation=growth**i)     no bias, no padding
    n       = (u - mean) / sqrt(var + 1e-5)          batch statistics over (batch,
                                                     time) in training (the running
                                                     ones move by 0.1, the variance
                                                     unbiased); the running ones in eval
    g, b    = chunk(A_i c + a_i, 2)
    h'      = PReLU_i(g n + b) + (r_i * h)[..., crop]
    y       = tanh(w_out . h_n + b_out)

``forward`` gives the output and the running statistics a training forward
leaves, ``logcosh`` the loss, ``train_steps`` the gradients (by autograd)
and Adam (betas 0.9, 0.999, eps 1e-8) under the 1cycle rate
(``one_cycle_lr``).

Departures from the paper, the same in the port:

* 4 knobs, comp_4c's threshold, ratio, attack and release, normalised to
  [-0.5, 0.5] as the port feeds them, in place of the LA-2A's 2 controls;
* the loss is the port's log-cosh of the waveform residual, not the paper's
  training loss;
* the data is comp_4c synthesized by the port, not the LA-2A recordings;
* the causal crop of the residual keeps its last samples (micro-tcn's own
  ``causal_crop`` may end one sample before the last: not confirmed);
* micro-tcn's blocks also hold an affine BatchNorm that the conditioned path
  never uses: it is not here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5
MOMENTUM = 0.1


def _p(state: dict, dtype) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}


def forward(state: dict, x: torch.Tensor, knobs: torch.Tensor, spec: dict,
            training: bool = True, dtype=torch.float64):
    """(y (B, L), running) of x (B, N): ``running`` the BatchNorms' running
    statistics after this forward ({name: tensor}; unchanged in eval)."""
    p = _p(state, dtype)
    c = knobs.to(dtype)
    for i in (0, 2, 4):
        c = torch.relu(c @ p[f"gen.{i}.weight"].t() + p[f"gen.{i}.bias"])
    h = x.to(dtype)[:, None, :]
    running = {}
    for i in range(spec["n_blocks"]):
        pre = f"blocks.{i}."
        u = F.conv1d(h, p[pre + "conv1.weight"], dilation=spec["dilation_growth"] ** i)
        rm, rv = pre + "film.bn.running_mean", pre + "film.bn.running_var"
        if training:
            mean, var = u.mean((0, 2)), u.var((0, 2), unbiased=False)
            n = u.shape[0] * u.shape[2]
            running[rm] = (1 - MOMENTUM) * p[rm] + MOMENTUM * mean.detach()
            running[rv] = (1 - MOMENTUM) * p[rv] + MOMENTUM * var.detach() * n / (n - 1)
            count = pre + "film.bn.num_batches_tracked"
            running[count] = p[count] + 1
        else:
            mean, var = p[rm], p[rv]
        norm = (u - mean[:, None]) / torch.sqrt(var[:, None] + EPS)
        gb = c @ p[pre + "film.adaptor.weight"].t() + p[pre + "film.adaptor.bias"]
        g, b = gb.chunk(2, dim=1)
        z = norm * g[:, :, None] + b[:, :, None]
        z = torch.where(z >= 0, z, p[pre + "relu.weight"][:, None] * z)
        r = p[pre + "res.weight"][:, 0, 0][:, None] * h  # 1x1, one weight an output channel
        start = r.shape[-1] - z.shape[-1] if spec["causal"] else (r.shape[-1] - z.shape[-1]) // 2
        h = z + r[..., start : start + z.shape[-1]]
    y = torch.tanh(torch.einsum("c,bcl->bl", p["output.weight"][0, :, 0], h) + p["output.bias"])
    return y, running


def logcosh(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean(log cosh(y - y_hat)) = mean(|z| + log1p(exp(-2|z|)) - log 2)."""
    z = torch.abs(y.to(y_hat.dtype) - y_hat)
    return torch.mean(z + torch.log1p(torch.exp(-2.0 * z)) - math.log(2.0))


def one_cycle_lr(lr_max: float, n_data_points: int, epochs: int, batch_size: int):
    """fn(step) -> the 1cycle rate: cosine up over the first 30% from
    lr_max / 15, cosine down to lr_max / 1500."""
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


def train_steps(state: dict, batches, lrs, spec: dict, dtype=torch.float64):
    """One Adam step a (x, y, knobs) batch from ``state``: (losses, grads,
    params, running), ``grads`` each step's gradients ({name: tensor} a
    step), ``params`` and ``running`` the parameters and running statistics
    after the last step. The parameters are the floating entries of
    ``state`` that are no BatchNorm statistics."""
    names = [k for k, v in state.items() if v.is_floating_point() and ".bn." not in k]
    params = {k: state[k].detach().to(dtype).clone() for k in names}
    bufs = {k: v for k, v in _p(state, dtype).items() if k not in params}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grads = [], []
    for t, ((x, y, knobs), lr) in enumerate(zip(batches, lrs), start=1):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        y_hat, running = forward({**bufs, **leaves}, x, knobs, spec, True, dtype)
        loss = logcosh(y_hat, y)
        g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        bufs.update(running)
        with torch.no_grad():
            for k, p in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        losses.append(float(loss.detach()))
        grads.append({k: v.detach() for k, v in g.items()})
    return losses, grads, params, bufs
