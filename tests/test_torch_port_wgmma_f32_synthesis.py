"""The float32 (split-TF32) mode of the wgmma schedule of kernels B and E, on the CPU.

csrc/wgmma_product.cuh forms each f32 product of B and E as three TF32 ones
on wgmma, summed from zero over a K step of 32 and joined to the tile's sums
by round-to-nearest adds; its B operand is read from shared memory K-major,
pre-split into hi and lo planes (csrc/tc_product.cuh pack_split_synthesis,
and E's spectrum, written transposed and split by its dspec pass). A CUDA
kernel cannot run here, so what surrounds it is held instead: a plain model
of the schedule's arithmetic (cuda_frontend.split_tf32_matmul with chunks of
32: B's frame product over K = the interleaved spectrum column, E's dspec
over K = the frame sample and its dW over K = the padded rows t * bpad + b)
against the JAX package's float32 Pallas kernels in interpret mode, within
the JAX tolerances of the synthesis (wave 3e-4, gradients 5e-4 + 5e-4|g|),
and against float64 within twice the plain version's error plus 1e-6 *
max|result|, the rule chip_smoke.py holds the kernels to (with its control,
one TF32 product, more than GAP_F32 = 10 times over it); the plain versions
of the new repacks against split_tf32; and the rule, the scratch and the
counters that give float32 B and E the wgmma schedule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend as cf
from signaltrain_tpu_torch.ops import framing, frontend

from tests.torch_port_util import n, synthesis_bwd_inputs, t

F32 = torch.float32
GEOMS = pytest.mark.parametrize("ft,hop,b", [(64, 24, 5), (100, 30, 7)], ids=["small", "ragged"])
GAP_F32 = 10.0  # chip_smoke.py's: how far over the float64 rule one TF32 product must land


def _weights(inp, ft):
    """The port's stacked synthesis weights (2*half, ft) of the inputs."""
    half = ft // 2 + 1
    return cf.stack_synthesis_weights(*frontend.fold_synthesis_weights(t(inp["wr"]), t(inp["wi"]),
                                                                       half))


def _jax_synthesis(inp, ft, hop):
    """B and E of the JAX package at compute_dtype float32, in interpret
    mode: (wave, dmag, dphs, dw), dw as the port's (2*half, ft)."""
    half = ft // 2 + 1
    wr_eff, wi_eff = jfrontend.fold_synthesis_weights(jnp.asarray(inp["wr"]),
                                                      jnp.asarray(inp["wi"]), half)
    jw = pf.stack_synthesis_weights(wr_eff, wi_eff, half)
    mag, phs = jnp.asarray(inp["mag"]), jnp.asarray(inp["phs"])
    wave = pf._fused_synthesis_fwd_impl(mag, phs, jw, ft, hop, half, jnp.float32, True)
    dmag, dphs, dw = pf._fused_synthesis_bwd(ft, hop, half, jnp.float32, True, (mag, phs, jw),
                                             jnp.asarray(inp["a"]))
    cw = jw.shape[0] // 2
    dw = np.concatenate([np.asarray(dw[:half]), np.asarray(dw[cw : cw + half])])
    return np.asarray(wave), np.asarray(dmag), np.asarray(dphs), dw


def _split_b(mag, phs, w, ft, hop, chunk=32):
    """Kernel B's arithmetic on the float32 wgmma schedule: the spectrum of
    the live frames 1 .. OT-2, interleaved (ldc columns), times the packed
    weights as chunked split sums over K = the column, overlap-added and
    trimmed."""
    half, (ot, b) = mag.shape[-1], mag.shape[:2]
    ldc = cf.packed_width(half)
    spec = torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], dim=-1)[1 : ot - 1]
    wp = cf.interleave(w.t(), ldc)  # (ft, ldc): column 2*bin + part = row part*half + bin
    frames = torch.zeros(ot, b, ft, dtype=mag.dtype)
    frames[1 : ot - 1] = cf.split_tf32_matmul(cf.interleave(spec, ldc), wp.t().contiguous(),
                                              chunk=chunk)
    wave = framing.overlap_add(frames.transpose(0, 1), hop)
    return wave[:, ft : wave.shape[1] - ft]


def _split_e(mag, phs, w, dout, ft, hop, chunk=32):
    """Kernel E's arithmetic on the float32 wgmma schedule: dspec of the live
    frames of the padded dout over K = the frame sample (the packed weights'
    transpose, w's rows interleaved), dmag / dphs from it, and dW over K = the
    padded rows t * bpad + b of the frames and the spectrum, each a chunked
    split sum; the edge frames' gradients exact zeros."""
    half, (ot, b) = mag.shape[-1], mag.shape[:2]
    ldc, bpad = cf.packed_width(half), cf.pad_rows(b)
    frames = framing.frame_signal(dout, ft, hop, pad=ft).transpose(0, 1)[1 : ot - 1]  # (live, B, ft)
    dspec = cf.split_tf32_matmul(frames, cf.interleave(w.t(), ldc), chunk=chunk)
    d_re, d_im = dspec[..., 0 : 2 * half : 2], dspec[..., 1 : 2 * half : 2]
    m, c, s = mag[1 : ot - 1], torch.cos(phs[1 : ot - 1]), torch.sin(phs[1 : ot - 1])
    dmag, dphs = torch.zeros_like(mag), torch.zeros_like(mag)
    dmag[1 : ot - 1] = d_re * c + d_im * s
    dphs[1 : ot - 1] = m * (d_im * c - d_re * s)
    spec = cf.interleave(torch.cat([m * c, m * s], dim=-1), ldc)
    fpad = F.pad(frames, (0, 0, 0, bpad - b)).reshape(-1, ft)
    spad = F.pad(spec, (0, 0, 0, bpad - b)).reshape(-1, ldc)
    dw_i = cf.split_tf32_matmul(fpad.t().contiguous(), spad, chunk=chunk)  # (ft, ldc)
    dw = torch.cat([dw_i[:, 0 : 2 * half : 2], dw_i[:, 1 : 2 * half : 2]], dim=1).t()
    return dmag, dphs, dw


def _f64_ratio(got, plain, exact):
    """How many times over the float64 rule (twice the plain version's error
    plus 1e-6 * max|exact|) ``got`` lands."""
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    return err / (2 * plain_err + 1e-6 * float(exact.abs().max()))


@GEOMS
def test_split_model_of_b_and_e_matches_jax_pallas(ft, hop, b):
    """The schedule's arithmetic against the JAX package's float32 B and E
    (interpret mode) on the same numpy inputs: wave within 3e-4 + 3e-4|w|,
    dmag, dphs and dW within 5e-4 + 5e-4|g|; the edge frames exactly 0; and
    within the float64 rule beside the plain version."""
    inp = synthesis_bwd_inputs(ft, hop, b)
    jwave, jdmag, jdphs, jdw = _jax_synthesis(inp, ft, hop)
    mag, phs, dout, w = t(inp["mag"]), t(inp["phs"]), t(inp["a"]), _weights(inp, ft)
    wave = _split_b(mag, phs, w, ft, hop)
    np.testing.assert_allclose(n(wave), jwave, atol=3e-4, rtol=3e-4)
    got = _split_e(mag, phs, w, dout, ft, hop)
    for g, want, name in zip(got, (jdmag, jdphs, jdw), ("dmag", "dphs", "dW")):
        np.testing.assert_allclose(n(g), want, atol=5e-4, rtol=5e-4, err_msg=name)
    for g in got[:2]:
        assert torch.all(g[0] == 0) and torch.all(g[-1] == 0)
    args64 = (mag.double(), phs.double(), w.double())
    assert _f64_ratio(wave, cf.fused_synthesis_reference(mag, phs, w, ft, hop),
                      cf.fused_synthesis_reference(*args64, ft, hop)) <= 1
    plain = cf.fused_synthesis_bwd_reference(mag, phs, w, dout, ft, hop)
    exact = cf.fused_synthesis_bwd_reference(*args64, dout.double(), ft, hop)
    for g, p, x, name in zip(got, plain, exact, ("dmag", "dphs", "dW")):
        assert _f64_ratio(g, p, x) <= 1, name


def test_split_model_is_as_accurate_as_f32_and_one_tf32_product_is_not():
    """At the flagship geometry (batch 3, OT 9), the chunked split sums of B
    and E (32 a chunk) lie within the float64 rule, and the control the card
    uses, the plain version on operands cut to TF32 (one product, no split),
    more than GAP_F32 times over it: the rule can tell the split sum from one
    TF32 product."""
    ft, hop, b = 1024, 384, 3
    inp = synthesis_bwd_inputs(ft, hop, b)
    mag, phs, dout, w = t(inp["mag"]), t(inp["phs"]), t(inp["a"]), _weights(inp, ft)
    args64 = (mag.double(), phs.double(), w.double())
    cut = lambda x: cf.split_tf32(x)[0]
    plain = cf.fused_synthesis_reference(mag, phs, w, ft, hop)
    exact = cf.fused_synthesis_reference(*args64, ft, hop)
    assert _f64_ratio(_split_b(mag, phs, w, ft, hop), plain, exact) <= 1
    spec = torch.cat([mag * torch.cos(phs), mag * torch.sin(phs)], dim=-1)
    one = framing.overlap_add((cut(spec) @ cut(w)).transpose(0, 1), hop)[:, ft:-ft]
    assert _f64_ratio(one, plain, exact) > GAP_F32
    plain = cf.fused_synthesis_bwd_reference(mag, phs, w, dout, ft, hop)
    exact = cf.fused_synthesis_bwd_reference(*args64, dout.double(), ft, hop)
    ones = cf.fused_synthesis_bwd_reference(mag, phs, cut(w), cut(dout), ft, hop)
    for g, o, p, x, name in zip(_split_e(mag, phs, w, dout, ft, hop), ones, plain, exact,
                                ("dmag", "dphs", "dW")):
        assert _f64_ratio(g, p, x) <= 1, name
        assert _f64_ratio(o, p, x) > GAP_F32, name


@pytest.mark.parametrize("ft", [64, 1024, 100])
def test_the_synthesis_split_repacks_are_split_tf32_of_the_packed_weights(ft):
    """pack_split_synthesis_reference: the stacked (2*half, ft) synthesis
    weights packed as (ft, ldc), column 2*bin + part = row part*half + bin,
    the padding columns zero, cut by split_tf32 into hi and lo (TF32 values
    whose sum recovers each weight to 2^-21); transposed, the (ldc, ft)
    planes of the same values, w's rows interleaved."""
    half = ft // 2 + 1
    ldc = cf.packed_width(half)
    rng = np.random.default_rng(ft + 1)
    w = t(rng.normal(size=(2 * half, ft)) * 0.1)
    hi, lo = cf.pack_split_synthesis_reference(w)
    thi, tlo = cf.pack_split_synthesis_reference(w, transposed=True)
    assert hi.shape == lo.shape == (ft, ldc) and thi.shape == tlo.shape == (ldc, ft)
    assert torch.equal(thi, hi.t()) and torch.equal(tlo, lo.t())
    want = torch.zeros(ldc, ft)
    for c in range(2 * half):
        want[c] = w[(c % 2) * half + c // 2]
    whi, wlo = cf.split_tf32(want)
    assert torch.equal(thi, whi) and torch.equal(tlo, wlo)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0  # TF32 numbers
    assert torch.all(thi[2 * half :] == 0) and torch.all(tlo[2 * half :] == 0)
    mask = want != 0
    assert float(((thi + tlo - want).abs()[mask] / want.abs()[mask]).max()) <= 2.0 ** -21


@pytest.mark.parametrize("ft,hop,ot,want_e", [
    (1024, 384, 9, "wgmma"),   # the flagship: a padded row of 8 * 384 + 1024 floats
    (64, 24, 9, "wgmma"),      # "small"
    (100, 30, 9, "mma"),       # "ragged": hop 30 is 120 bytes
    (602, 201, 9, "mma"),      # an odd hop
    (600, 200, 9, "wgmma"),    # a narrow last column tile, ldc 604
])
def test_the_rule_gives_float32_b_and_e_the_wgmma_schedule(ft, hop, ot, want_e):
    """Float32 B takes wgmma at every geometry (it reads no frames through
    TMA); E where its padded dout's frames are 16 bytes of floats, which no
    pointer enters (the padded dout is the launch's own scratch); "mma"
    stays reachable by name, and a forced wgmma the rule cannot give raises."""
    lp = (ot - 1) * hop - ft + 2 * ft
    assert cf.schedule_for(None, F32, ft, hop, None, "B") == "wgmma"
    assert cf.schedule_for(None, F32, ft, hop, lp, "E") == want_e
    assert cf.schedule_for(None, F32, ft, hop, lp, "E", aligned=False) == want_e
    for kernel, lp_k in (("B", None), ("E", lp)):
        assert cf.schedule_for("mma", F32, ft, hop, lp_k, kernel) == "mma"
    if want_e == "mma":
        with pytest.raises(ValueError, match="wgmma"):
            cf.schedule_for("wgmma", F32, ft, hop, lp, "E")
    assert set(cf.F32_WGMMA_KERNELS) == {"A", "B", "D", "E"}


def test_the_float32_wgmma_launches_name_their_scratch_and_counters():
    """Float32 B and E on wgmma ask for the split planes of their B operands
    and no K-slice partials: B the packed weights' (ft, ldc) and the frames
    written once, E the weights' transpose (ldc, ft) and, for dW, the
    spectrum's transpose over the padded rows; each schedule has its own
    counter; on CPU tensors both schedules run the same plain version,
    counted as the float32 kernel's plain calls."""
    b, ot, ft, half, out_len = 200, 9, 1024, 513, 2048
    rows, f32 = 7 * 200, F32
    assert cf.synthesis_fwd_scratch("wgmma", f32, b, ot, ft, half) == {
        "wp_hi": ((ft, 1028), f32), "wp_lo": ((ft, 1028), f32), "spec": ((rows, 1028), f32),
        "frames": ((rows, ft), f32)}
    mma = cf.synthesis_fwd_scratch("mma", f32, b, ot, ft, half)
    assert mma["wp"] == ((ft, 1028), f32) and mma["frames"] == ((3, rows, ft), f32)
    e = cf.synthesis_bwd_scratch("wgmma", f32, 5, ot, 64, 33, 8 * 24 - 64, True)
    assert e == {"wt_hi": ((68, 64), f32), "wt_lo": ((68, 64), f32),
                 "doutp": ((5, 8 * 24 + 64), f32), "spect_hi": ((68, 7 * 8), f32),
                 "spect_lo": ((68, 7 * 8), f32)}
    e = cf.synthesis_bwd_scratch("wgmma", f32, b, ot, ft, half, out_len, False)
    assert e["spect_hi"] is None and e["spect_lo"] is None and "dspec" not in e
    assert cf.synthesis_bwd_scratch("mma", f32, b, ot, ft, half, out_len, True)["dw_partial"][0] == (
        cf.k_slices(ft, 1028, rows), ft, 1028)
    assert cf.SYNTHESIS_MMA.name == "fused_synthesis_mma"
    assert cf.SYNTHESIS_BWD_MMA.name == "fused_synthesis_bwd_mma"
    inp = synthesis_bwd_inputs(64, 24, 5)
    mag, phs, dout, w = t(inp["mag"]), t(inp["phs"]), t(inp["a"]), _weights(inp, 64)
    _cuda.reset_counts()
    waves = [cf.fused_synthesis(mag, phs, w, 64, 24, schedule=s) for s in cf.SCHEDULES]
    assert torch.equal(waves[0], waves[1])
    grads = [cf.fused_synthesis_bwd(mag, phs, w, dout, 64, 24, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, c) for a, c in zip(*grads))
    assert cf.SYNTHESIS.plain_calls == 2 and cf.SYNTHESIS_BWD.plain_calls == 2
    for c in (cf.SYNTHESIS, cf.SYNTHESIS_MMA, cf.SYNTHESIS_BWD, cf.SYNTHESIS_BWD_MMA):
        assert c.launches == 0
