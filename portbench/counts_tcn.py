"""Operations and bytes of TCN-300-C's convolutions on cuDNN: the
yardstick's arithmetic for the ``train-tcn300c-f32`` cell.

A train step of b examples makes, for each block i (kernel k, dilation
growth**i, Cin input and C output channels, an input of N and an output of
L = N - (k - 1) growth**i samples), three products of 2 b C Cin k L
operations: the forward, the data gradient (not for block 0, whose input,
the batch, takes no gradient) and the weight gradient. The two 1x1
convolutions that mix channels run on the same cuDNN kernels and are
counted with them: block 0's residual (1 -> C over N samples: forward and
weight gradient) and the output (C -> 1 over the last block's L: forward,
data and weight gradients). Bytes count each input read once and each
output written once, in float32, whatever the kernel computing the call
reads again. The depthwise residuals of blocks 1 and on (PyTorch's own
kernels), the conditioning, BatchNorm, FiLM and PReLU are left out: under
0.1% of the operations at TCN-300-C's sizes.
"""

from __future__ import annotations

from .counts import F32, PEAK_FLOPS, PEAK_HBM_BYTES  # noqa: F401  (the peaks: the readers')


def blocks(config: dict) -> list[tuple[int, int, int, int]]:
    """(Cin, N, L, dilation) of each block's dilated convolution."""
    k, n, out = config["kernel_size"], config["in_chunk_size"], []
    for i in range(config["n_blocks"]):
        d = config["dilation_growth"] ** i
        cin = 1 if i == 0 else config["channels"]
        out.append((cin, n, n - (k - 1) * d, d))
        n -= (k - 1) * d
    return out


def _products(name: str, b: int, cin: int, cout: int, k: int, n: int, l: int, dgrad: bool):
    """(name, flops, bytes) of one convolution's forward, data gradient (if
    ``dgrad``) and weight gradient on b examples of n samples in, l out."""
    flops = 2.0 * b * cout * cin * k * l
    x, w, y = b * cin * n, cout * cin * k, b * cout * l
    out = [(f"fwd.{name}", flops, F32 * (x + w + y))]
    if dgrad:
        out.append((f"dgrad.{name}", flops, F32 * (y + w + x)))
    return out + [(f"wgrad.{name}", flops, F32 * (x + y + w))]


def conv_calls(config: dict, b: int) -> list[tuple[str, float, float]]:
    """(name, flops, bytes) of every convolution product of one train step on
    b examples that cuDNN runs (module docstring): ``fwd.i``, ``dgrad.i``
    (i > 0), ``wgrad.i`` of block i's dilated convolution, then ``*.res0``
    and ``*.out`` of the 1x1s."""
    c, k = config["channels"], config["kernel_size"]
    calls = []
    for i, (cin, n, l, _) in enumerate(blocks(config)):
        calls += _products(str(i), b, cin, c, k, n, l, dgrad=i > 0)
    n0, last = config["in_chunk_size"], blocks(config)[-1][2]
    calls += _products("res0", b, 1, c, 1, n0, n0, dgrad=False)
    return calls + _products("out", b, c, 1, 1, last, last, dgrad=True)


def forward_flops(config: dict) -> float:
    """The convolutions' operations of one example's forward."""
    return sum(f for name, f, _ in conv_calls(config, 1) if name.startswith("fwd."))


def train_step_flops(config: dict) -> float:
    """The convolutions' operations of one example's train step."""
    return sum(f for _, f, _ in conv_calls(config, 1))


def train_conv_bound_s(config: dict, b: int, dtype: str) -> float:
    """The least seconds of one step's convolution products: each call's
    operations at the dtype's peak or its bytes at the HBM rate, whichever
    is longer, summed."""
    return sum(max(f / PEAK_FLOPS[dtype], n / PEAK_HBM_BYTES) for _, f, n in conv_calls(config, b))
