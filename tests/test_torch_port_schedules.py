"""The two schedules of kernels A, B, D and E in bf16 (ops/cuda_frontend.py), on the CPU.

The wgmma schedule (csrc/wgmma_product.cuh) and the mma.sync one
(csrc/tc_product.cuh) run only on the card (tests/test_torch_port_cuda.py);
what surrounds them is plain Python and is held here: the rule that picks a
schedule by shape, the scratch each asks for, the wrapper refusing what it
cannot run, A and B with a schedule named still matching the JAX package
through their plain versions, and the slack that the card checks of bf16 D
allow for a flip of dspec's one bf16 rounding (fused_analysis_bwd_flip_slack),
against float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu_torch.ops import _cuda, frontend
from signaltrain_tpu_torch.ops import cuda_frontend as cf
from signaltrain_tpu_torch.ops import framing

from tests.torch_port_util import (analysis_bwd_inputs, assert_analysis_close,
                                   synthesis_bwd_inputs, t)

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
    # float32: D (and A) on wgmma where the frames are 16 bytes of floats and
    # the signal is aligned; E where its frames are 16 bytes of floats (they
    # are its own scratch, so no alignment enters)
    f32_d = "wgmma" if ft % 4 == hop % 4 == lp % 4 == 0 else "mma"
    assert cf.uses_wgmma(ft, hop, lp, torch.float32) == (f32_d == "wgmma")
    assert cf.schedule_for(None, torch.float32, ft, hop, lp, "D") == f32_d
    assert cf.schedule_for(None, torch.float32, ft, hop, lp, "D", aligned=False) == "mma"
    assert cf.schedule_for(None, torch.float32, ft, hop, lp, "E") == f32_d
    assert cf.schedule_for(None, torch.float32, ft, hop, lp, "E", aligned=False) == f32_d
    assert cf.schedule_for(None, torch.float32, ft, hop, lp) == "mma"  # no kernel named
    assert cf.schedule_for("mma", BF16, ft, hop, lp) == "mma"
    assert cf.schedule_for("mma", torch.float32, ft, hop, lp, "D") == "mma"


# (ft, hop, padded row length of A) -> the pick of A's rule and of B's: B
# reads no frames through TMA, so it takes wgmma at every geometry
@pytest.mark.parametrize("ft,hop,lp,want_a", [
    (1024, 384, 8192 + 2 * 1024, "wgmma"),   # the flagship
    (64, 24, 512 + 2 * 64, "wgmma"),         # "small"
    (100, 30, 700 + 2 * 100, "mma"),         # "ragged": hop 30 is 60 bytes of bf16
    (602, 201, 8 * 201 + 602, "mma"),        # a narrow last column tile, odd hop
    (1024, 384, 8190 + 2 * 1024, "mma"),     # a row length that is not 16 bytes
    (16, 5, 203 + 2 * 16, "mma"),
])
def test_the_rule_picks_the_forward_schedules_by_shape(ft, hop, lp, want_a):
    assert cf.schedule_for(None, BF16, ft, hop, lp) == want_a
    assert cf.schedule_for(None, BF16, ft, hop, None) == "wgmma"
    # float32 A takes wgmma where its frames are 16 bytes of floats; B, as in
    # bf16, at every geometry
    f32_a = "wgmma" if ft % 4 == hop % 4 == lp % 4 == 0 else "mma"
    assert cf.schedule_for(None, torch.float32, ft, hop, lp, "A") == f32_a
    assert cf.schedule_for(None, torch.float32, ft, hop, None, "B") == "wgmma"
    for lp_b in (lp, None):
        assert cf.schedule_for("mma", BF16, ft, hop, lp_b) == "mma"
    assert cf.schedule_for("wgmma", BF16, ft, hop, None) == "wgmma"
    assert cf.schedule_for("wgmma", torch.float32, ft, hop, None, "B") == "wgmma"
    assert cf.schedule_for("mma", torch.float32, ft, hop, None, "B") == "mma"


def test_each_forward_schedule_asks_for_its_own_scratch():
    b, lp, ft, half, ot = 200, 10240, 1024, 513, 9
    ldc = cf.packed_width(half, BF16)
    # A's is the same on both schedules: no K slices on either
    assert cf.analysis_fwd_scratch(BF16, b, lp, ft, half) == {"xq": ((b, lp), BF16),
                                                              "wp": ((ft, ldc), BF16)}
    assert cf.analysis_fwd_scratch(torch.float32, b, lp, ft, half) == {
        "xq": None, "wp": ((ft, 1028), torch.float32)}
    # float32 on wgmma: the split planes of the packed weights' transpose
    assert cf.analysis_fwd_scratch(torch.float32, b, lp, ft, half, "wgmma") == {
        "wt_hi": ((1028, ft), torch.float32), "wt_lo": ((1028, ft), torch.float32)}
    rows = 7 * b  # the live frames 1 .. OT-2
    wg = cf.synthesis_fwd_scratch("wgmma", BF16, b, ot, ft, half)
    assert wg == {"wp": ((ft, ldc), BF16), "spec": ((rows, ldc), BF16),
                  "frames": ((rows, ft), torch.float32)}  # written once: no K slices
    mma = cf.synthesis_fwd_scratch("mma", BF16, b, ot, ft, half)
    nsplit = cf.k_slices(rows, ft, ldc)
    assert nsplit == 3 and mma["frames"] == ((nsplit, rows, ft), torch.float32)
    assert mma["spec"] == wg["spec"] and mma["wp"] == wg["wp"]
    # at 643 windows: 4,501 rows fill the card, so the mma loop takes one slice too
    assert cf.synthesis_fwd_scratch("mma", BF16, 643, ot, ft, half)["frames"][0] == (
        1, 7 * 643, ft)
    f32 = cf.synthesis_fwd_scratch("mma", torch.float32, 100, ot, 602, 302)
    assert f32["spec"] == ((700, 604), torch.float32)


def test_the_forward_wrappers_refuse_an_unknown_or_impossible_schedule():
    ft, hop = 64, 24
    xp = torch.zeros(5, 512 + 2 * ft)
    w = torch.zeros(ft, 2 * 33)
    mag = torch.rand(9, 5, 33)
    ws = torch.zeros(66, ft)
    for bad in ("tma", "WGMMA", ""):
        with pytest.raises(ValueError, match="schedule"):
            cf.fused_analysis(xp, w, ft, hop, BF16, schedule=bad)
        with pytest.raises(ValueError, match="schedule"):
            cf.fused_synthesis(mag, mag, ws, ft, hop, BF16, schedule=bad)
    # float32 A takes wgmma only from a 16-byte aligned signal (TMA reads it
    # as it is); float32 B, which reads no frames, takes it at any shape, and
    # on CPU tensors runs its plain version on either schedule
    off = torch.zeros(xp.numel() + 1)[1:].view(xp.shape)  # 4 bytes past a boundary
    with pytest.raises(ValueError, match="wgmma"):
        cf.fused_analysis(off, w, ft, hop, schedule="wgmma")
    got = [cf.fused_synthesis(mag, mag, ws, ft, hop, schedule=s) for s in cf.SCHEDULES]
    assert torch.equal(got[0], got[1])
    ragged = torch.zeros(7, 700 + 200)
    for dtype in (BF16, torch.float32):  # hop 30: not a TMA stride of A's frames
        with pytest.raises(ValueError, match="wgmma"):
            cf.fused_analysis(ragged, torch.zeros(100, 102), 100, 30, dtype, schedule="wgmma")
    got = [cf.fused_analysis(xp + 1, w + 1, ft, hop, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    # B takes wgmma at the ragged geometry; on CPU tensors either schedule
    # names the same plain version
    rmag = torch.rand(9, 7, 51)
    rw = torch.randn(102, 100)
    got = [cf.fused_synthesis(rmag, rmag, rw, 100, 30, BF16, schedule=s) for s in cf.SCHEDULES]
    assert torch.equal(got[0], got[1])
    got = [cf.fused_analysis(xp + 1, w + 1, ft, hop, BF16, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))


def test_the_forward_schedules_match_jax_pallas():
    """A and B in bf16 with each schedule named, on CPU tensors (their plain
    versions), against the JAX package's bf16 Pallas kernels in interpret
    mode, run once, on the same numpy inputs at the "small" geometry:
    magnitude 2e-5, phase 2e-4 on bins >= 1e-2 (assert_analysis_close), wave
    3e-4 + 3e-4|w|."""
    ft, hop, chunk, b = 64, 24, 512, 5
    half = ft // 2 + 1
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    xp = np.pad(inp["x"], ((0, 0), (ft, ft)))
    jw = pf.stack_analysis_weights(jnp.asarray(inp["wr"]), jnp.asarray(inp["wi"]), half)
    jmag, jphs = pf.fused_analysis(jnp.asarray(xp), jw, ft, hop, half, jnp.bfloat16, True)
    w = cf.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half)

    sinp = synthesis_bwd_inputs(ft, hop, b)
    wr_eff, wi_eff = jfrontend.fold_synthesis_weights(jnp.asarray(sinp["wr"]),
                                                      jnp.asarray(sinp["wi"]), half)
    want = pf.fused_synthesis(jnp.asarray(sinp["mag"]), jnp.asarray(sinp["phs"]),
                              pf.stack_synthesis_weights(wr_eff, wi_eff, half), ft, hop, half,
                              jnp.bfloat16, True)
    pw = cf.stack_synthesis_weights(*frontend.fold_synthesis_weights(t(sinp["wr"]), t(sinp["wi"]),
                                                                     half))
    for schedule in cf.SCHEDULES:
        _cuda.reset_counts()
        mag, phs = cf.fused_analysis(t(xp), w, ft, hop, BF16, schedule=schedule)
        assert cf.ANALYSIS_BF16.plain_calls == 1 and cf.ANALYSIS_BF16_MMA.launches == 0
        assert_analysis_close(mag, phs, jmag, jphs)
        wave = cf.fused_synthesis(t(sinp["mag"]), t(sinp["phs"]), pw, ft, hop, BF16,
                                  schedule=schedule)
        assert cf.SYNTHESIS_BF16.plain_calls == 1
        np.testing.assert_allclose(wave.numpy(), np.asarray(want), atol=3e-4, rtol=3e-4)


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
    off = torch.zeros(xp.numel() + 1)[1:].view(xp.shape)  # 4 bytes past a boundary
    with pytest.raises(ValueError, match="wgmma"):  # float32 TMA reads the signal itself
        cf.fused_analysis_bwd(off, *args[1:], schedule="wgmma")
    mag = torch.rand(9, 5, 33)
    ws = torch.zeros(66, 64)
    dout = torch.zeros(5, 8 * 24 - 64)
    with pytest.raises(ValueError, match="schedule"):
        cf.fused_synthesis_bwd(mag, mag, ws, dout, 64, 24, compute_dtype=BF16, schedule="tma")
    # float32 E reads the frames of its padded dout through TMA: hop 30 (120
    # bytes) cannot be a stride, hop 24 can
    rmag, rws, rdout = torch.rand(9, 7, 51), torch.zeros(102, 100), torch.zeros(7, 8 * 30 - 100)
    with pytest.raises(ValueError, match="wgmma"):
        cf.fused_synthesis_bwd(rmag, rmag, rws, rdout, 100, 30, schedule="wgmma")
    got = [cf.fused_synthesis_bwd(mag, mag, ws, dout, 64, 24, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    ragged = torch.zeros(7, 700 + 200)
    for dtype in (BF16, torch.float32):  # hop 30: not a TMA stride
        with pytest.raises(ValueError, match="wgmma"):
            cf.fused_analysis_bwd(ragged, torch.zeros(100, 102), torch.zeros(30, 7, 51),
                                  torch.zeros(30, 7, 51), 100, 30, compute_dtype=dtype,
                                  schedule="wgmma")
    got = [cf.fused_analysis_bwd(*args, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))
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
    # float32 on wgmma: B's split planes, dspec's transpose for dW, no partials
    f32 = torch.float32
    wg32 = cf.analysis_bwd_scratch("wgmma", f32, b, lp, ft, half, t, False, True)
    assert wg32 == {"wt_hi": ((1028, ft), f32), "wt_lo": ((1028, ft), f32), "wp_hi": None,
                    "wp_lo": None, "dspec": None, "dspect_hi": ((1028, t * 200), f32),
                    "dspect_lo": ((1028, t * 200), f32), "dframes": None}
    wg32 = cf.analysis_bwd_scratch("wgmma", f32, 5, 640, 64, 33, 25, True, False)
    assert wg32["wp_hi"] == wg32["wp_lo"] == ((64, 68), f32) and wg32["dspect_hi"] is None
    assert wg32["dspec"] == ((25 * 8, 68), f32) and wg32["dframes"] == ((25 * 5, 64), f32)

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
