"""Operations, bytes and peaks: the yardstick's arithmetic.

Frozen copies: the model's product FLOPs of ``signaltrain_tpu_torch/utils/
flops.py`` (``aenc_gemm_flops_per_example``, ``forward_gemm_flops_per_example``,
``train_step_flops_per_example``, :40-68), the H100 data-sheet rates of
``utils/card.py`` (:12-15) and the front-end kernels' operation counts of
``cli/time_frontend.py`` (A :436, D :448, B and its live samples :283-290, E
:311). Bytes count each input read once and each output written once, at
the dtype the call is given (every front-end call takes and returns
float32), whatever the kernel computing the call reads again.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}  # bf16; TF32 over three products
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def aenc_flops(config: dict) -> int:
    """One autoencoder's nine products over the frame axis, an example."""
    r, t, ot, k = (config["decomposition_rank"], config["time_frames"],
                   config["output_time_frames"], config["num_knobs"])
    half = config["ft_size"] // 2 + 1
    dims = [(t, r), (r, r // 2), (r // 2, r // 4), (r // 4, r // 4), (r // 4 + k, r // 4),
            (r // 4, r // 4), (r // 4, r // 2), (r // 2, r), (r, ot)]
    return 2 * half * sum(i * o for i, o in dims)


def forward_flops(config: dict) -> int:
    """The forward's products an example: analysis, synthesis, two autoencoders."""
    ft, half = config["ft_size"], config["ft_size"] // 2 + 1
    analysis = 2 * config["time_frames"] * ft * (2 * half)
    synthesis = 2 * config["output_time_frames"] * (2 * half) * ft
    return analysis + synthesis + 2 * aenc_flops(config)


def train_step_flops(config: dict) -> int:
    """Forward, input and weight gradients: three times the forward's products."""
    return 3 * forward_flops(config)


def live(config: dict) -> tuple[int, int]:
    """(output samples that the synthesis frames cover after the trim, summed
    over the frames; frames that reach the trimmed output)."""
    ft, hop, ot = config["ft_size"], config["hop_size"], config["output_time_frames"]
    la = (ot - 1) * hop + ft
    spans = [max(0, min(t * hop + ft, la - ft) - max(t * hop, ft)) for t in range(ot)]
    return sum(spans), sum(1 for s in spans if s > 0)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least seconds: operations at the dtype's peak or bytes at the HBM rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES)


def analysis_call(config: dict, b: int) -> tuple[float, float]:
    """Kernel A on b rows: (flops, bytes)."""
    ft, half, t = config["ft_size"], config["ft_size"] // 2 + 1, config["time_frames"]
    flops = 2.0 * b * t * ft * 2 * half
    nbytes = F32 * (b * (config["in_chunk_size"] + 2 * ft) + ft * 2 * half + 2 * t * b * half)
    return flops, nbytes


def synthesis_call(config: dict, b: int) -> tuple[float, float]:
    """Kernel B on b rows: (flops, bytes)."""
    ft, half = config["ft_size"], config["ft_size"] // 2 + 1
    samples, frames = live(config)
    flops = 2.0 * b * 2 * half * samples
    nbytes = F32 * (2 * frames * b * half + 2 * half * ft + b * config["out_chunk_size"])
    return flops, nbytes


def analysis_bwd_call(config: dict, b: int) -> tuple[float, float]:
    """Kernel D on b rows with no gradient of the signal (the spectrum and
    dW products): (flops, bytes)."""
    ft, half, t = config["ft_size"], config["ft_size"] // 2 + 1, config["time_frames"]
    flops = 2 * 2.0 * b * t * ft * 2 * half
    nbytes = F32 * (b * (config["in_chunk_size"] + 2 * ft) + ft * 2 * half + 2 * t * b * half
                    + ft * 2 * half)
    return flops, nbytes


def synthesis_bwd_call(config: dict, b: int) -> tuple[float, float]:
    """Kernel E on b rows (dspec and dW products): (flops, bytes)."""
    ft, half, ot = config["ft_size"], config["ft_size"] // 2 + 1, config["output_time_frames"]
    samples, frames = live(config)
    flops = 2 * 2.0 * b * 2 * half * samples
    nbytes = F32 * (2 * frames * b * half + 2 * half * ft + b * config["out_chunk_size"]
                    + 2 * ot * b * half + 2 * half * ft)
    return flops, nbytes


def train_frontend_bound_s(config: dict, b: int, dtype: str) -> float:
    """The four front-end calls of one train step: A, B, E, D."""
    return sum(bound_s(*f(config, b), dtype)
               for f in (analysis_call, synthesis_call, synthesis_bwd_call, analysis_bwd_call))


def super_batches(n_windows: int, size: int = 1024) -> list[int]:
    """The rows of each forward that serving one signal of n_windows windows runs."""
    return [min(size, n_windows - s) for s in range(0, n_windows, size)]


def n_windows(length: int, chunk: int, out: int) -> int:
    """Windows that tile a signal of ``length`` samples (length >= chunk)."""
    rem = (length - chunk) % out
    padded = length if rem == 0 else length + out - rem
    return (padded - chunk) // out + 1
