"""The model's weights, made on the device from the run's seed.

Both sides get these: the program through ``STModel.load_state_dict(...,
strict=True)``, the reference as they are. The layout (names and shapes) is
the reference checkpoint's (the ``mpaec.`` prefix, conv-weight front-end
matrices of shape (ft, 1, ft), ``fnn_*`` dense layers of shape (out, in)).

The front-end starts where the program's own initialisation starts (the
Hamming-windowed orthonormal DFT for the analysis, the Griffin-Lim window
for the synthesis), plus seeded noise of 2% of each matrix's RMS, so that
every seed gives other matrices; the autoencoders' weights are normal with
the Xavier variance, their biases normal with a standard deviation of 0.05.
Every random number comes from one ``torch.Generator`` on the device, in one
call.
"""

from __future__ import annotations

import math

import torch

FRONTEND = ("dft_analysis.conv_analysis_real", "dft_analysis.conv_analysis_imag",
            "dft_synthesis.conv_synthesis_real", "dft_synthesis.conv_synthesis_imag")
DENSE = ("fnn_enc", "fnn_enc2", "fnn_enc3", "fnn_enc4", "fnn_addknobs", "fnn_dec4", "fnn_dec3",
         "fnn_dec2", "fnn_dec")
FRONTEND_NOISE = 0.02
BIAS_STD = 0.05


def dense_shapes(config: dict) -> list[tuple[str, int, int]]:
    """(name, in, out) of one autoencoder's nine layers."""
    r, t, ot, k = (config["decomposition_rank"], config["time_frames"],
                   config["output_time_frames"], config["num_knobs"])
    dims = [(t, r), (r, r // 2), (r // 2, r // 4), (r // 4, r // 4), (r // 4 + k, r // 4),
            (r // 4, r // 4), (r // 4, r // 2), (r // 2, r), (r, ot)]
    return [(n, i, o) for n, (i, o) in zip(DENSE, dims)]


def _hamming(n: int, dev) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=dev)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * k / (n - 1))


def _gla_window(n: int, hop: int, dev) -> torch.Tensor:
    w = _hamming(n, dev)
    env = torch.zeros(n, dtype=torch.float64, device=dev)
    w2 = w * w
    for k in range(-(n // hop), n // hop + 1):
        s = k * hop
        if s >= 0:
            env[s:] += w2[: n - s]
        else:
            env[: n + s] += w2[-s:]
    return w / env


def initial_frontend(config: dict, dev) -> list[torch.Tensor]:
    """The four (ft, ft) matrices the program's own initialisation starts
    from, in float64: analysis real and imaginary, synthesis real and
    imaginary."""
    n, hop = config["ft_size"], config["hop_size"]
    c = torch.arange(n, dtype=torch.float64, device=dev)
    ang = 2.0 * math.pi * torch.outer(c, c) / n
    re, im = torch.cos(ang) / math.sqrt(n), -torch.sin(ang) / math.sqrt(n)
    wa, ws = _hamming(n, dev), _gla_window(n, hop, dev)
    return [re * wa, im * wa, re * ws, im * ws]


def make(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict, float32 on ``device``, for ``seed``."""
    dev = torch.device(device)
    ft = config["ft_size"]
    shapes = dense_shapes(config)
    n_dense = sum(o * i + o for _, i, o in shapes)
    gen = torch.Generator(device=dev).manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    noise = torch.randn(4 * ft * ft + 2 * n_dense, generator=gen, device=dev,
                        dtype=torch.float32)
    sd, at = {}, 0
    for name, m in zip(FRONTEND, initial_frontend(config, dev)):
        rms = float(m.pow(2).mean().sqrt())
        z = noise[at : at + ft * ft].view(ft, ft).double()
        sd[f"mpaec.{name}.weight"] = (m + FRONTEND_NOISE * rms * z).float()[:, None, :]
        at += ft * ft
    for enc in ("aenc", "phs_aenc"):
        for name, i, o in shapes:
            std = math.sqrt(2.0 / (i + o))
            sd[f"mpaec.{enc}.{name}.weight"] = noise[at : at + o * i].view(o, i) * std
            at += o * i
            sd[f"mpaec.{enc}.{name}.bias"] = noise[at : at + o] * BIAS_STD
            at += o
    return {k: v.contiguous() for k, v in sd.items()}
