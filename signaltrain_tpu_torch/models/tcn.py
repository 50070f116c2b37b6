"""TCN-300-C: the causal, FiLM-conditioned dilated-convolution compressor model.

The "micro-TCN" of C. J. Steinmetz and J. D. Reiss, *Efficient neural
networks for real-time modeling of analog dynamic range compression* (AES
152, 2022; arXiv:2102.06200; reference code github.com/csteinmetz1/micro-tcn),
the public successor of SignalTrain on the same task. Its layers, with p the
knobs (B, K) and h_0 the input (B, 1, N):

    c       = ReLU(L3 ReLU(L2 ReLU(L1 p)))          K -> 16 -> 32 -> 32, with biases
    block i = 0 .. n_blocks - 1, dilation d = dilation_growth**i:
      u     = conv1d(h_i, W_i, dilation=d)          no bias, no padding: (k - 1) d shorter
      n     = BatchNorm1d(u)                        no affine; batch statistics in
                                                    training, running ones in eval
      g, b  = chunk(A_i c + a_i, 2)                 FiLM, Linear 32 -> 2 x channels
      h_i+1 = PReLU_i(g n + b) + R_i(h_i)[crop]     R_i 1x1, groups = in channels, no
                                                    bias; causal: its last samples
    y       = tanh(conv1x1(h_n) + b_out)            channels -> 1

At TCN-300-C's sizes (4 blocks, kernel 13, growth 10, 32 channels, causal)
the receptive field is 1 + 12 (1 + 10 + 100 + 1000) = 13,333 samples, 302 ms
at 44.1 kHz, and the model holds 50,769 parameters. An output of L samples
needs L + 13,332 input samples: ``TCNSpec.in_chunk_size``. The state dict
keeps micro-tcn's names (``gen``, ``blocks.i.conv1``, ``blocks.i.film.bn``,
``blocks.i.film.adaptor``, ``blocks.i.relu``, ``blocks.i.res``, ``output``),
without its blocks' affine BatchNorm, which the conditioned path never uses.

The model computes in float32 only. cuDNN may run float32 convolutions in
TF32; ``float32_convolutions`` keeps the model's own convolutions (its
forward, and through ``numerics`` the backward that ``train`` runs) in
float32, on cuDNN's deterministic algorithms, so that a captured step
replays bit for bit what the eager step computes.

It keeps the port's model contract: ``model(x (B, N), knobs (B, K))``
returns ``(y_hat (B, N - receptive_field + 1), None, None)`` (it has no
spectra), ``model.loss`` is log-cosh on the waveform and ``model.clip_grads``
clips nothing (its update is Adam alone). Each block's forward marks the
phases ``tcn.conv`` before its dilated convolution and ``tcn.norm`` before
its BatchNorm, FiLM, PReLU and residual (``utils/profiling.phase``); the
output layer is ``forward`` again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn as nn

from ..training import loss as loss_mod
from ..utils import profiling
from ..utils.device import resolve_device

COND = (16, 32, 32)  # the conditioning MLP's widths after the knobs
PRELU_INIT = 0.25
WINDOW_FLOATS = 1 << 26  # predict_long: floats of one block's activation a forward


@dataclasses.dataclass(frozen=True)
class TCNSpec:
    """A TCN's sizes and run values (TCN-300-C's by default)."""

    num_knobs: int = 4
    sr: int = 44100
    n_blocks: int = 4
    kernel_size: int = 13
    dilation_growth: int = 10
    channels: int = 32
    causal: bool = True
    out_chunk_size: int = 65536

    kind = "tcn"
    default_dtype = torch.float32  # its only dtype
    batch_statistics = True  # BatchNorm: one process, the whole batch a step
    optimizer_form = "adam"  # a checkpoint's moments by parameter name
    SIZES = ("n_blocks", "kernel_size", "dilation_growth", "channels", "causal",
             "out_chunk_size")

    @property
    def receptive_field(self) -> int:
        return 1 + (self.kernel_size - 1) * sum(self.dilation_growth ** i
                                                for i in range(self.n_blocks))

    @property
    def in_chunk_size(self) -> int:
        return self.out_chunk_size + self.receptive_field - 1

    def sizes(self) -> dict:
        return {k: getattr(self, k) for k in self.SIZES}

    def run_values(self) -> dict:
        """What a checkpoint keeps of the model: its kind, sizes and windows."""
        return {"model_kind": self.kind, "tcn": self.sizes(), "in_chunk_size": self.in_chunk_size,
                "out_chunk_size": self.out_chunk_size, "sr": self.sr}


@contextlib.contextmanager
def float32_convolutions():
    """cuDNN's float32 convolutions in float32 (no TF32) and on its
    deterministic algorithms inside the block; the process's flags as they
    were after it."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = before


def _crop(r: torch.Tensor, n: int, causal: bool) -> torch.Tensor:
    """The last n samples of r (causal), or its centre n."""
    start = r.shape[-1] - n if causal else (r.shape[-1] - n) // 2
    return r[..., start : start + n]


class FiLM(nn.Module):
    """BatchNorm without affine, then the conditioning's scale and shift."""

    def __init__(self, channels: int, cond_dim: int):
        super().__init__()
        self.bn = nn.BatchNorm1d(channels, affine=False)
        self.adaptor = nn.Linear(cond_dim, 2 * channels)

    def forward(self, u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        g, b = self.adaptor(c)[..., None].chunk(2, dim=1)
        return self.bn(u) * g + b


class TCNBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dilation: int, cond_dim: int,
                 causal: bool):
        super().__init__()
        self.causal = causal
        self.conv1 = nn.Conv1d(in_ch, out_ch, kernel_size, dilation=dilation, bias=False)
        self.film = FiLM(out_ch, cond_dim)
        self.relu = nn.PReLU(out_ch, init=PRELU_INIT)
        self.res = nn.Conv1d(in_ch, out_ch, 1, groups=in_ch, bias=False)

    def forward(self, h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        profiling.phase("tcn.conv")
        u = self.conv1(h)
        profiling.phase("tcn.norm")
        g = self.relu(self.film(u, c))
        return g + _crop(self.res(h), g.shape[-1], self.causal)


def _init(model: nn.Module, gen: torch.Generator) -> None:
    """PyTorch's default initialisation of every Linear and Conv1d, drawn
    from ``gen`` in module order: weight and bias U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)


class TCNModel(nn.Module):
    """TCN-300-C (module docstring) with its ``TCNSpec``."""

    mesh = None  # never split over a tensor-parallel mesh
    has_spectra = False

    def __init__(self, spec: TCNSpec, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if compute_dtype != torch.float32:
            raise ValueError(f"a TCN computes in float32 only, got compute_dtype={compute_dtype}")
        dev = resolve_device(device)
        self.spec = spec
        self.compute_dtype = compute_dtype
        widths = (spec.num_knobs, *COND)
        layers = []
        for i, o in zip(widths, widths[1:]):
            layers += [nn.Linear(i, o), nn.ReLU()]
        self.gen = nn.Sequential(*layers)
        ch = spec.channels
        self.blocks = nn.ModuleList(
            TCNBlock(1 if i == 0 else ch, ch, spec.kernel_size, spec.dilation_growth ** i,
                     COND[-1], spec.causal) for i in range(spec.n_blocks))
        self.output = nn.Conv1d(ch, 1, 1)
        _init(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.output.weight.device

    @property
    def windows_per_forward(self) -> int:
        """``predict_long``'s windows a forward: a block's activation of
        about ``WINDOW_FLOATS`` floats."""
        return max(1, WINDOW_FLOATS // (self.spec.channels * self.spec.in_chunk_size))

    def numerics(self):
        """The context the model's convolutions run in, forward and backward."""
        return float32_convolutions()

    def forward(self, x: torch.Tensor, knobs: torch.Tensor):
        """x: (B, N) waveform, knobs: (B, K). Returns (y_hat, None, None),
        y_hat (B, N - receptive_field + 1)."""
        with self.numerics():
            c = self.gen(knobs.float())
            h = x.float()[:, None, :]
            for block in self.blocks:
                h = block(h, c)
            profiling.phase("forward")
            y = torch.tanh(self.output(h))[:, 0, :]
        return y, None, None

    def loss(self, y_hat: torch.Tensor, y: torch.Tensor, mag_hat=None) -> torch.Tensor:
        """log-cosh of the residual (``loss.logcosh``); there is no spectrum."""
        return loss_mod.logcosh(y_hat, y)

    def clip_grads(self, max_norm: float = 1.0) -> None:
        """Nothing: the TCN's update is Adam alone."""

