"""The float32 (split-TF32) mode of the wgmma schedule of kernels A and D, on the CPU.

csrc/wgmma_product.cuh forms each f32 product of A and D as three TF32 ones
on wgmma, summed from zero over a K step of 32 and joined to the tile's sums
by round-to-nearest adds; its B operand is read from shared memory K-major,
pre-split into hi and lo planes (the repacks of csrc/tc_product.cuh). A CUDA
kernel cannot run here, so what surrounds it is held instead: the chunked
split sum (cuda_frontend.split_tf32_matmul with ``chunk``) against the JAX
package's own products at Precision.HIGHEST, within the JAX tolerances of the
analysis (magnitude 2e-5, phase 2e-4: assert_analysis_close) and of the
gradients (5e-4, with well-conditioned phase cotangents); the plain versions
of the new repacks against split_tf32; and the rule (schedule_for) that gives
float32 A and D the wgmma schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.ops import framing as jframing
from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu_torch.ops import cuda_frontend as cf
from signaltrain_tpu_torch.ops import framing

from tests.torch_port_util import (analysis_bwd_inputs, assert_analysis_close, n,
                                   regular_phase_cotangent, t)

F32 = torch.float32
# (ft, hop, chunk, batch): the "small" geometry, and the flagship at batch 2
GEOMS = [(64, 24, 512, 5), (1024, 384, 8192, 2)]


def _jax_analysis(xp, w, ft, hop):
    """A's function in the JAX package's float32 arithmetic: the frames of the
    padded signal, halved, times the stacked matrix through its front-end
    product (ops/frontend._gemm, Precision.HIGHEST), magnitude and phase as
    its fused kernel forms them."""
    half = w.shape[1] // 2
    frames = jnp.swapaxes(jframing.frame_signal(xp, ft, hop, 0), 0, 1) * 0.5  # (T, B, ft)
    spec = jfrontend._gemm(frames, w, jnp.float32)
    re, im = spec[..., :half], spec[..., half:]
    return jnp.sqrt(jnp.maximum(re * re + im * im, 1e-36)), jnp.arctan2(im, re + 1e-7)


def _split_d(xp, w, dmag, dphs, ft, hop, chunk):
    """Kernel D's arithmetic on the wgmma schedule: the spectrum over K = the
    frame sample, dxp's frame product over K = the interleaved spectrum column
    and dW over K = the padded rows t * bpad + b (8 windows a frame box), each
    a chunked split sum; the x/2 on the finished sums. Returns (mag, phs,
    dxp, dw) of that arithmetic."""
    half = w.shape[1] // 2
    ldc = cf.packed_width(half)
    frames = framing.frame_signal(xp, ft, hop, pad=0).transpose(0, 1)  # (T, B, ft)
    spec = 0.5 * cf.split_tf32_matmul(frames, w, chunk=chunk)
    re, im = spec[..., :half], spec[..., half:]
    mag, phs = cf.mag_phs(re, im)
    sq = re * re + im * im
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(sq.clamp_min(1e-36)), torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], dim=-1)
    dspec_i, w_i = cf.interleave(dspec, ldc), cf.interleave(w, ldc)  # columns 2 * bin + part
    dframes = 0.5 * cf.split_tf32_matmul(dspec_i, w_i.t().contiguous(), chunk=chunk)
    dxp = framing.overlap_add(dframes.transpose(0, 1), hop)
    dxp = torch.nn.functional.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    tt, b = frames.shape[:2]
    bpad = cf.pad_rows(b)
    fpad = torch.nn.functional.pad(frames, (0, 0, 0, bpad - b)).reshape(tt * bpad, ft)
    dpad = torch.nn.functional.pad(dspec_i, (0, 0, 0, bpad - b)).reshape(tt * bpad, ldc)
    dw_i = 0.5 * cf.split_tf32_matmul(fpad.t().contiguous(), dpad, chunk=chunk)
    dw = torch.cat([dw_i[:, 0 : 2 * half : 2], dw_i[:, 1 : 2 * half : 2]], dim=1)
    return mag, phs, dxp, dw


def _inputs(ft, hop, chunk, b, regular=True):
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    if regular:
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    xp = np.pad(inp["x"], ((0, 0), (ft, ft)))
    w = np.asarray(cf.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), ft // 2 + 1))
    return xp, w, inp["a"], inp["c"]


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("ft,hop,chunk_len,b", GEOMS)
def test_chunked_split_sum_matches_jax_at_highest(ft, hop, chunk_len, b, chunk):
    """A's and D's products as the mma.sync loop (chunks of 8) and the wgmma
    schedule (chunks of 32, one K step) add them, against the JAX package's
    analysis and its gradients at Precision.HIGHEST: magnitude and phase by
    A's rule, dx and dW within 5e-4 + 5e-4|g| (well-conditioned phase
    cotangents); the edge frames exactly (1e-18, 0)."""
    xp, w, dmag, dphs = _inputs(ft, hop, chunk_len, b)
    (jmag, jphs), vjp = jax.vjp(lambda x, m: _jax_analysis(x, m, ft, hop), jnp.asarray(xp),
                                jnp.asarray(w))
    jdxp, jdw = vjp((jnp.asarray(dmag), jnp.asarray(dphs)))
    mag, phs, dxp, dw = _split_d(t(xp), t(w), t(dmag), t(dphs), ft, hop, chunk)
    assert_analysis_close(mag, phs, np.asarray(jmag), np.asarray(jphs))
    for e in (0, -1):
        assert torch.all(mag[e] == np.float32(1e-18)) and torch.all(phs[e] == 0)
    np.testing.assert_allclose(n(dxp), np.asarray(jdxp), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(n(dw), np.asarray(jdw), atol=5e-4, rtol=5e-4)


def test_chunked_split_sum_is_as_accurate_as_f32():
    """At the flagship geometry the magnitude of the chunked split sum (32 a
    chunk, as the wgmma schedule adds) lies within twice the plain f32
    version's error against float64 plus 1e-7, the rule the card holds the
    kernel to; chunks of one K and of 8 give the same arithmetic order as
    before."""
    ft, hop, chunk, b = GEOMS[1]
    half = ft // 2 + 1
    xp, w, _, _ = (t(a) for a in _inputs(ft, hop, chunk, b))
    frames = framing.frame_signal(xp, ft, hop, pad=0).transpose(0, 1)
    spec64 = 0.5 * (frames.double() @ w.double())
    mag64 = torch.sqrt(spec64[..., :half] ** 2 + spec64[..., half:] ** 2).clamp_min(1e-18)
    plain = float((cf.fused_analysis_reference(xp, w, ft, hop)[0] - mag64).abs().max())
    for c in (None, 8, 32):
        spec = 0.5 * cf.split_tf32_matmul(frames, w, chunk=c)
        err = float((cf.mag_phs(spec[..., :half], spec[..., half:])[0] - mag64).abs().max())
        assert err <= 2 * plain + 1e-7, (c, err, plain)
    assert torch.equal(cf.split_tf32_matmul(frames, w), cf.split_tf32_matmul(frames, w, chunk=ft))


@pytest.mark.parametrize("ft", [64, 1024, 100])
def test_the_split_repacks_are_split_tf32_of_the_packed_weights(ft):
    """pack_split_reference: the stacked (ft, 2*half) weights interleaved into
    (ft, ldc), column 2*bin + part = stacked column part*half + bin, the
    padding columns zero, cut by split_tf32 into hi and lo (TF32 values whose
    sum recovers each weight to 2^-21); transposed, the (ldc, ft) planes of
    the same values."""
    half = ft // 2 + 1
    ldc = cf.packed_width(half)
    rng = np.random.default_rng(ft)
    w = t(rng.normal(size=(ft, 2 * half)) * 0.1)
    hi, lo = cf.pack_split_reference(w)
    thi, tlo = cf.pack_split_reference(w, transposed=True)
    assert hi.shape == lo.shape == (ft, ldc) and thi.shape == tlo.shape == (ldc, ft)
    assert torch.equal(thi, hi.t()) and torch.equal(tlo, lo.t())
    want = torch.zeros(ft, ldc)
    for c in range(2 * half):
        want[:, c] = w[:, (c % 2) * half + c // 2]
    whi, wlo = cf.split_tf32(want)
    assert torch.equal(hi, whi) and torch.equal(lo, wlo)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0  # TF32 numbers
    assert torch.all(hi[:, 2 * half:] == 0) and torch.all(lo[:, 2 * half:] == 0)
    mask = want != 0
    assert float(((hi + lo - want).abs()[mask] / want.abs()[mask]).max()) <= 2.0 ** -21


@pytest.mark.parametrize("ft,hop,lp,aligned,want", [
    (1024, 384, 10240, True, "wgmma"),   # the flagship
    (64, 24, 640, True, "wgmma"),        # "small"
    (1024, 384, 10240, False, "mma"),    # a signal 4 bytes off a 16-byte boundary
    (100, 30, 900, True, "mma"),         # "ragged": hop 30 is 120 bytes
    (1024, 384, 10238, True, "mma"),     # a row length that is not 16 bytes
    (1026, 384, 10242, True, "mma"),     # ft 1026: not 16 bytes
])
def test_schedule_for_gives_float32_a_and_d_wgmma_where_tma_reads_the_signal(ft, hop, lp, aligned,
                                                                             want):
    """Float32 A and D take the wgmma schedule where ft, hop and the row
    length are multiples of 4 floats and the signal is 16-byte aligned (TMA
    reads it as it lies); E where the row is so, at any alignment (its frames
    are its own scratch); B at every shape; a schedule the rule cannot give
    raises."""
    for kernel in ("A", "D"):
        assert cf.schedule_for(None, F32, ft, hop, lp, kernel, aligned) == want
        assert cf.schedule_for("mma", F32, ft, hop, lp, kernel, aligned) == "mma"
        if want == "mma":
            with pytest.raises(ValueError, match="wgmma"):
                cf.schedule_for("wgmma", F32, ft, hop, lp, kernel, aligned)
    want_e = "wgmma" if cf.uses_wgmma(ft, hop, lp, F32) else "mma"
    assert cf.schedule_for(None, F32, ft, hop, lp, "E", aligned) == want_e
    assert cf.schedule_for(None, F32, ft, hop, None, "B") == "wgmma"
    assert cf.schedule_for("wgmma", F32, ft, hop, None, "B") == "wgmma"
    for kernel, lp_k in (("E", lp), ("B", None)):
        assert cf.schedule_for("mma", F32, ft, hop, lp_k, kernel) == "mma"
    if want_e == "mma":
        with pytest.raises(ValueError, match="wgmma"):
            cf.schedule_for("wgmma", F32, ft, hop, lp, "E")
    # bf16 keeps its own rule, which no pointer enters
    assert cf.schedule_for(None, torch.bfloat16, ft, hop, lp, "A", aligned) == (
        "wgmma" if cf.uses_wgmma(ft, hop, lp) else "mma")


def test_the_float32_wgmma_launch_names_its_scratch_and_counters():
    """Float32 A and D on wgmma ask for the split planes of their B operands
    and no K-slice partials; each schedule has its own counter, and on CPU
    tensors both schedules run the same plain version (counted as the
    float32 kernel's plain calls)."""
    f32 = cf.analysis_fwd_scratch(F32, 200, 10240, 1024, 513, "wgmma")
    assert set(f32) == {"wt_hi", "wt_lo"}
    d = cf.analysis_bwd_scratch("wgmma", F32, 200, 10240, 1024, 513, 25, False, True)
    assert "dw_partial" not in d and d["dspect_hi"] == ((1028, 25 * 200), F32)
    assert cf.ANALYSIS_MMA.name == "fused_analysis_mma"
    assert cf.ANALYSIS_BWD_MMA.name == "fused_analysis_bwd_mma"
    xp, w, dmag, dphs = (t(a) for a in _inputs(64, 24, 512, 5))
    cf.ANALYSIS.reset(), cf.ANALYSIS_MMA.reset()
    got = [cf.fused_analysis(xp, w, 64, 24, schedule=s) for s in cf.SCHEDULES]
    assert all(torch.equal(a, b) for a, b in zip(*got))
    assert cf.ANALYSIS.plain_calls == 2 and cf.ANALYSIS_MMA.launches == cf.ANALYSIS.launches == 0
