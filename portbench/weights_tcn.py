"""TCN-300-C's weights, made on the device from the run's seed.

Both sides get these: the program through ``TCNModel.load_state_dict(...,
strict=True)``, the reference (``reference/tcn.py``) as they are. The layout
is the program's state dict (``models/tcn.py``, micro-tcn's names): the
conditioning MLP ``gen.{0,2,4}``, each block's ``conv1`` (C, Cin, k),
``film.adaptor`` (2C, 32), ``relu`` (C,), ``res`` (C, 1, 1) and its
BatchNorm's running statistics ``film.bn.*``, and ``output`` (1, C, 1).

Every weight and bias of a Linear or a convolution is uniform in
(-1/sqrt(fan_in), 1/sqrt(fan_in)), PyTorch's default initialisation; each
PReLU slope is 0.25 plus uniform noise of +-0.05, so that every seed gives
other slopes; the running statistics start where a new BatchNorm's do (mean
0, variance 1, no batches). Every random number comes from one
``torch.Generator`` on the device, in one call.
"""

from __future__ import annotations

import math

import torch

COND = (16, 32, 32)
SLOPE, SLOPE_NOISE = 0.25, 0.05


def shapes(config: dict) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter, in the program's order; a
    fan_in of 0 marks a PReLU slope."""
    out = []
    widths = (config["num_knobs"], *COND)
    for j, (i, o) in enumerate(zip(widths, widths[1:])):
        out += [(f"gen.{2 * j}.weight", (o, i), i), (f"gen.{2 * j}.bias", (o,), i)]
    ch, k = config["channels"], config["kernel_size"]
    for b in range(config["n_blocks"]):
        cin = 1 if b == 0 else ch
        pre = f"blocks.{b}."
        out += [(pre + "conv1.weight", (ch, cin, k), cin * k),
                (pre + "film.adaptor.weight", (2 * ch, COND[-1]), COND[-1]),
                (pre + "film.adaptor.bias", (2 * ch,), COND[-1]),
                (pre + "relu.weight", (ch,), 0),
                (pre + "res.weight", (ch, 1, 1), 1)]
    out += [("output.weight", (1, ch, 1), ch), ("output.bias", (1,), ch)]
    return out


def make(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict, float32 on ``device`` (the running counts int64), for ``seed``."""
    dev = torch.device(device)
    params = shapes(config)
    total = sum(math.prod(s) for _, s, _ in params)
    gen = torch.Generator(device=dev).manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    u = torch.rand(total, generator=gen, device=dev, dtype=torch.float32) * 2.0 - 1.0
    sd, at = {}, 0
    for name, shape, fan_in in params:
        z = u[at : at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        sd[name] = SLOPE + SLOPE_NOISE * z if fan_in == 0 else z / math.sqrt(fan_in)
    ch = config["channels"]
    for b in range(config["n_blocks"]):
        pre = f"blocks.{b}.film.bn."
        sd[pre + "running_mean"] = torch.zeros(ch, device=dev)
        sd[pre + "running_var"] = torch.ones(ch, device=dev)
        sd[pre + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=dev)
    return {k: v.contiguous() for k, v in sd.items()}
