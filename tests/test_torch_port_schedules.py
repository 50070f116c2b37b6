"""The two schedules of kernels D and E in bf16 (ops/cuda_frontend.py), on the CPU.

The wgmma schedule (csrc/wgmma_product.cuh) and the mma.sync one
(csrc/tc_product.cuh) run only on the card (tests/test_torch_port_cuda.py);
what surrounds them is plain Python and is held here: the rule that picks a
schedule by shape, the scratch each asks for, the wrapper refusing what it
cannot run, and the slack that the card checks of bf16 D allow for a flip of
dspec's one bf16 rounding (fused_analysis_bwd_flip_slack), against float64.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from signaltrain_tpu_torch.ops import cuda_frontend as cf
from signaltrain_tpu_torch.ops import framing

from tests.torch_port_util import analysis_bwd_inputs

BF16 = torch.bfloat16


# (ft, hop, padded row length of D, of E) -> the rule's pick
@pytest.mark.parametrize("ft,hop,lp,want", [
    (1024, 384, 8192 + 2 * 1024, "wgmma"),   # the flagship, D
    (1024, 384, 8 * 384 + 1024, "wgmma"),    # the flagship, E (9 frames)
    (64, 24, 512 + 2 * 64, "wgmma"),         # "small"
    (100, 30, 700 + 2 * 100, "mma"),         # "ragged": hop 30 is 60 bytes of bf16
    (602, 201, 8 * 201 + 602, "mma"),
    (1024, 384, 8190 + 2 * 1024, "mma"),     # a row length that is not 16 bytes
])
def test_the_rule_picks_wgmma_where_tma_can_read_the_frames(ft, hop, lp, want):
    assert cf.uses_wgmma(ft, hop, lp) == (want == "wgmma")
    assert cf.schedule_for(None, BF16, ft, hop, lp) == want
    assert cf.schedule_for(None, torch.float32, ft, hop, lp) == "mma"  # f32 has one schedule
    assert cf.schedule_for("mma", BF16, ft, hop, lp) == "mma"


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_the_dspec_reference_is_the_first_half_of_the_plain_version(dtype):
    """analysis_bwd_dspec_reference gives the operands and the rounded dspec
    that D's plain version multiplies (what a kernel's dspec, read back by
    analysis_bwd_dspec on the card, is held against); analysis_bwd_dspec
    reads a launch's scratch, so it refuses CPU tensors."""
    ft, hop = 64, 24
    inp = {k: torch.from_numpy(v) for k, v in analysis_bwd_inputs(ft, hop, 512, 5).items()}
    xp = F.pad(inp["x"], (ft, ft))
    w = cf.stack_analysis_weights(inp["wr"], inp["wi"], ft // 2 + 1)
    args = (xp, w, inp["a"], inp["c"], ft, hop)
    frames, wr, dspec = cf.analysis_bwd_dspec_reference(*args, dtype)
    assert dspec.shape == (25, 5, 2 * (ft // 2 + 1))
    assert torch.equal(cf.round_operand(dspec, dtype), dspec)  # rounded once, as the kernel does
    _, dw = cf.fused_analysis_bwd_reference(*args, dtype)
    assert torch.equal(dw, frames.reshape(-1, ft).t() @ dspec.reshape(-1, dspec.shape[-1]))
    with pytest.raises(ValueError, match="CUDA"):
        cf.analysis_bwd_dspec(*args)


def test_the_wrapper_refuses_an_unknown_or_impossible_schedule():
    inp = {k: torch.from_numpy(v) for k, v in analysis_bwd_inputs(64, 24, 512, 5).items()}
    xp = F.pad(inp["x"], (64, 64))
    w = cf.stack_analysis_weights(inp["wr"], inp["wi"], 33)
    args = (xp, w, inp["a"], inp["c"], 64, 24)
    for bad in ("tma", "WGMMA", ""):
        with pytest.raises(ValueError, match="schedule"):
            cf.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=bad)
    with pytest.raises(ValueError, match="wgmma"):  # float32 stays on the mma.sync loop
        cf.fused_analysis_bwd(*args, schedule="wgmma")
    mag = torch.rand(9, 5, 33)
    ws = torch.zeros(66, 64)
    dout = torch.zeros(5, 8 * 24 - 64)
    with pytest.raises(ValueError, match="schedule"):
        cf.fused_synthesis_bwd(mag, mag, ws, dout, 64, 24, compute_dtype=BF16, schedule="tma")
    ragged = torch.zeros(7, 700 + 200)
    with pytest.raises(ValueError, match="wgmma"):  # hop 30: not a TMA stride
        cf.fused_analysis_bwd(ragged, torch.zeros(100, 102), torch.zeros(30, 7, 51),
                              torch.zeros(30, 7, 51), 100, 30, compute_dtype=BF16,
                              schedule="wgmma")
    # both schedules name the same plain version on CPU tensors
    got = [cf.fused_analysis_bwd(*args, compute_dtype=BF16, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_each_schedule_asks_for_its_own_scratch():
    b, lp, ft, half, t = 200, 10240, 1024, 513, 25
    ldc = cf.packed_width(half, BF16)
    assert ldc == 1032 and cf.pad_rows(200) == 200 and cf.pad_rows(5) == 8 and cf.pad_rows(1) == 8
    wg = cf.analysis_bwd_scratch("wgmma", BF16, b, lp, ft, half, t, False, True)
    assert wg == {"xq": ((b, lp), BF16), "wp": ((ft, ldc), BF16),
                  "dspec": ((t * 200, ldc), BF16), "dframes": None}
    mma = cf.analysis_bwd_scratch("mma", BF16, b, lp, ft, half, t, False, True)
    nsplit = cf.k_slices(ft, ldc, t * b)
    assert nsplit == 4 and mma["dw_partial"] == ((nsplit, ft, ldc), torch.float32)
    assert mma["dspec"] == ((t * b, ldc), BF16) and mma["dframes"] is None
    with_dxp = cf.analysis_bwd_scratch("wgmma", BF16, 5, 640, 64, 33, 25, True, False)
    assert with_dxp["dspec"] == ((25 * 8, 72), BF16)  # padded rows: 8 a frame
    assert with_dxp["dframes"] == ((25 * 5, 64), torch.float32)
    f32 = cf.analysis_bwd_scratch("mma", torch.float32, b, lp, ft, half, t, True, True)
    assert f32["xq"] is None and f32["wp"] == ((ft, 1028), torch.float32)

    ot, out_len = 9, 2048
    wg = cf.synthesis_bwd_scratch("wgmma", BF16, b, ot, ft, half, out_len, True)
    assert wg == {"wp": ((ft, ldc), BF16), "doutp": ((b, out_len + 2 * ft), BF16),
                  "spec": ((7 * 200, ldc), BF16)}
    mma = cf.synthesis_bwd_scratch("mma", BF16, b, ot, ft, half, out_len, True)
    assert mma["dspec"] == ((cf.k_slices(1400, ldc, ft), 1400, ldc), torch.float32)
    assert mma["dw_partial"] == ((cf.k_slices(ft, ldc, 1400), ft, ldc), torch.float32)
    nbytes = lambda spec: sum(int(np.prod(v[0])) * v[1].itemsize for v in spec.values() if v)
    # the partials the wgmma schedule does without: ~34 MB at this shape
    assert nbytes(mma) - nbytes(wg) > 30e6
    assert cf.synthesis_bwd_scratch("wgmma", BF16, b, ot, ft, half, out_len, False)["spec"] is None


def _bf16_dspec_grads(xp, w, dmag, dphs, ft, hop, noise=None):
    """bf16 D's (dxp, dw) in float64, the same roundings as the plain
    version, with the spectrum moved by ``noise`` before dspec is formed and
    rounded: what another order of the spectrum's sums does to it."""
    half = w.shape[1] // 2
    frames = framing.frame_signal(xp, ft, hop, pad=0).transpose(0, 1) * 0.5
    frames, w = cf.round_operand(frames, BF16), cf.round_operand(w, BF16)
    spec = frames @ w + (0 if noise is None else noise)
    re, im = spec[..., :half], spec[..., half:]
    sq = re * re + im * im
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(torch.clamp_min(sq, 1e-36)),
                     torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = cf.round_operand(torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], -1),
                             BF16)
    dxp = framing.overlap_add((dspec @ w.t() * 0.5).transpose(0, 1), hop)
    dxp = F.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    return dxp, frames.reshape(-1, ft).t() @ dspec.reshape(-1, 2 * half)


@pytest.mark.parametrize("spread", ["sigma", "k_sigma"])
def test_the_flip_slack_covers_another_order_of_the_spectrum_against_float64(spread):
    """At the "small" geometry with unit-normal phase cotangents: the
    spectrum moved by noise no larger than the largest error the card showed
    (cf.FLIP_K * cf.FLIP_SIGMA * max|spectrum|) flips some of dspec's bf16
    roundings; the float64 result moves by no more than the slack plus the
    card rule's floor (1e-3 * max|g|) on every seed. "sigma": normal noise of
    the card's root mean square (cf.FLIP_SIGMA * max|spectrum|), clipped
    there. "k_sigma": every component moved by that largest error, of random
    sign, a stress far past the reading, under which the moves pass the
    floor, so the slack is what holds the rule. The control, the float32
    plain version (no rounding), stays more than GAP_D = 2 times over the
    rule's limit with the slack taken off."""
    ft, hop, chunk, b = 64, 24, 512, 5
    inp = {k: torch.from_numpy(v) for k, v in analysis_bwd_inputs(ft, hop, chunk, b).items()}
    xp = F.pad(inp["x"], (ft, ft))
    w = cf.stack_analysis_weights(inp["wr"], inp["wi"], ft // 2 + 1)
    args64 = (xp.double(), w.double(), inp["a"].double(), inp["c"].double(), ft, hop)
    exact = _bf16_dspec_grads(*args64)
    assert all(torch.equal(a, c) for a, c in zip(
        exact, cf.fused_analysis_bwd_reference(*args64[:4], ft, hop, BF16)))
    slack = cf.fused_analysis_bwd_flip_slack(xp, w, inp["a"], inp["c"], ft, hop)
    sl = [(slice(None), slice(ft, -ft)), (slice(None), slice(None))]  # dx unpadded, dW
    frames = (xp.shape[1] - ft) // hop + 1
    spec = cf.round_operand(framing.frame_signal(xp.double(), ft, hop, pad=0) * 0.5, BF16) @ (
        cf.round_operand(w.double(), BF16))
    sigma = cf.FLIP_SIGMA * float(spec.abs().max())
    largest = cf.FLIP_K * sigma
    moved_over_floor = 0.0
    for seed in range(3):
        noise = torch.randn((frames, b, w.shape[1]), generator=torch.Generator().manual_seed(seed),
                            dtype=torch.float64)
        noise = (noise * sigma).clamp(-largest, largest) if spread == "sigma" else (
            torch.sign(noise) * largest)
        moved = _bf16_dspec_grads(*args64, noise=noise)
        for m, x, s, cut in zip(moved, exact, slack, sl):
            diff, floor = (m - x)[cut].abs(), 1e-3 * float(x[cut].abs().max())
            moved_over_floor = max(moved_over_floor, float(diff.max()) / floor)
            assert float((diff - s[cut]).max()) <= floor, seed
    assert moved_over_floor > (1 if spread == "k_sigma" else 0)
    plain = cf.fused_analysis_bwd_reference(xp, w, inp["a"], inp["c"], ft, hop, BF16)
    f32 = cf.fused_analysis_bwd_reference(xp, w, inp["a"], inp["c"], ft, hop, torch.float32)
    for p, f, x, s, cut in zip(plain, f32, exact, slack, sl):
        limit = 2 * float((p.double() - x)[cut].abs().max()) + 1e-3 * float(x[cut].abs().max())
        assert float(((f.double() - x)[cut].abs() - s[cut]).max()) > 2 * limit
    # an all-padding frame gives an exact 0 spectrum: no slack on it
    assert float(slack[1].abs().sum()) > 0
    edge = torch.zeros_like(inp["a"])
    edge[0] = 1.0  # frame 0 covers only padding
    none = cf.fused_analysis_bwd_flip_slack(xp, w, edge, edge, ft, hop)
    assert float(none[1].abs().max()) == 0 and float(none[0].abs().max()) == 0
