"""The port's front-end gradients (kernels D and E) against the JAX package.

On the CPU the port's ``fused_analysis`` / ``fused_synthesis`` run their
written-out plain backward versions; they are held to ``jax.grad`` through
the Pallas kernels in interpret mode (so to ``_an_bwd_kernel`` and
``_syn_bwd_kernel``), on the same numpy inputs and cotangents, and to
``torch.autograd`` through the plain forward versions. Tolerances are those
of tests/test_pallas_frontend.py: dx, dmag, dphs and the synthesis weights
atol = rtol = 5e-4. The analysis weights come in two cases. "full": unit-normal
phase cotangents on every bin; the atan2 adjoint dphs / |spec| is heavy-tailed
over the bins of near-zero magnitude (max|dW| 50-800, median 0.7-18), so dW is
held to 1e-3 * max|dW| as the JAX package's own test holds it. "regular": the
phase cotangent zeroed on the bins of small magnitude, so that dW (median
0.5-12) and dx are well conditioned and every element is held to
5e-4 + 5e-4*|g|, dxp on the padding included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.ops import framing as jframing
from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, framing, frontend
from tests.torch_port_util import (BWD_GEOMS, BWD_IDS, analysis_bwd_inputs, assert_dw_close, n,
                                   regular_phase_cotangent, synthesis_bwd_inputs, t)

GEOMS = pytest.mark.parametrize("ft,hop,chunk,b", BWD_GEOMS, ids=BWD_IDS)
COTANGENTS = pytest.mark.parametrize("cot", ["full", "regular"])


def _analysis_inputs(ft, hop, chunk, b, cot, seed=0):
    inp = analysis_bwd_inputs(ft, hop, chunk, b, seed=seed)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    return inp


def _assert_dw(got, want, cot, name):
    if cot == "regular":
        np.testing.assert_allclose(n(got), n(want), atol=5e-4, rtol=5e-4, err_msg=name)
    else:
        assert_dw_close(n(got), n(want), name)


def _port_analysis_grads(inp, ft, hop):
    """Gradients of sum(mag*a) + sum(phs*c) w.r.t. (x, w_real, w_imag)
    through the port's fused_analysis."""
    half = ft // 2 + 1
    x, wr, wi = (t(inp[k]).requires_grad_() for k in ("x", "wr", "wi"))
    xp = torch.nn.functional.pad(x, (ft, ft))
    mag, phs = cuda_frontend.fused_analysis(
        xp, cuda_frontend.stack_analysis_weights(wr, wi, half), ft, hop)
    loss = (mag * t(inp["a"])).sum() + (phs * t(inp["c"])).sum()
    return torch.autograd.grad(loss, (x, wr, wi))


@COTANGENTS
@GEOMS
def test_analysis_grads_match_jax_pallas(ft, hop, chunk, b, cot):
    inp = _analysis_inputs(ft, hop, chunk, b, cot)
    half = ft // 2 + 1
    a, c = jnp.asarray(inp["a"]), jnp.asarray(inp["c"])

    def loss(x, wr, wi):
        w = pf.stack_analysis_weights(wr, wi, half)
        xp = jnp.pad(x, ((0, 0), (ft, ft)))
        mag, phs = pf.fused_analysis(xp, w, ft, hop, half, jnp.float32, True)
        return jnp.sum(mag * a) + jnp.sum(phs * c)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(inp[k]) for k in ("x", "wr", "wi")))
    _cuda.reset_counts()
    got = _port_analysis_grads(inp, ft, hop)
    assert cuda_frontend.ANALYSIS_BWD.plain_calls == 1 and cuda_frontend.ANALYSIS_BWD.launches == 0
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=5e-4, rtol=5e-4, err_msg="dx")
    _assert_dw(got[1], want[1], cot, "dwr")
    _assert_dw(got[2], want[2], cot, "dwi")
    # rows >= half of the parameters are unused: exactly zero gradient
    assert np.all(n(got[1])[half:] == 0) and np.all(n(got[2])[half:] == 0)


@COTANGENTS
@GEOMS
def test_analysis_plain_backward_matches_autograd(ft, hop, chunk, b, cot):
    """The written-out formulas of kernel D against torch.autograd through
    the plain forward (so the formulas are checked, not assumed)."""
    inp = _analysis_inputs(ft, hop, chunk, b, cot, seed=1)
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(t(inp["x"]), (ft, ft)).requires_grad_()
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half).requires_grad_()
    mag, phs = cuda_frontend.fused_analysis_reference(xp, w, ft, hop)
    want = torch.autograd.grad((mag * t(inp["a"])).sum() + (phs * t(inp["c"])).sum(), (xp, w))
    dxp, dw = cuda_frontend.fused_analysis_bwd_reference(
        xp.detach(), w.detach(), t(inp["a"]), t(inp["c"]), ft, hop)
    assert dxp.shape == xp.shape and dw.shape == w.shape
    # "full": dx on the unpadded signal (the padding's part, which the pad's
    # adjoint cuts off, carries the 1e7 * dphs of the all-padding frames)
    keep = slice(None) if cot == "regular" else slice(ft, -ft)
    np.testing.assert_allclose(n(dxp)[:, keep], n(want[0])[:, keep], atol=5e-4, rtol=5e-4)
    _assert_dw(dw, want[1], cot, "dw")
    only_dw = cuda_frontend.fused_analysis_bwd(xp.detach(), w.detach(), t(inp["a"]), t(inp["c"]),
                                               ft, hop, need_dxp=False)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


def test_analysis_edge_frames_give_no_magnitude_gradient():
    """Frames that cover only padding sit under the 1e-36 floor: their
    magnitude cotangent reaches neither dxp nor dw (the clamp's gradient
    passes only where sq >= 1e-36)."""
    ft, hop, chunk, b = BWD_GEOMS[0]
    inp = analysis_bwd_inputs(ft, hop, chunk, b, seed=2)
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(t(inp["x"]), (ft, ft))
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half)
    a = torch.zeros_like(t(inp["a"]))
    a[0], a[-1] = 1e6, 1e6  # only the all-padding frames get a cotangent
    dxp, dw = cuda_frontend.fused_analysis_bwd_reference(xp, w, a, torch.zeros_like(a), ft, hop)
    assert torch.all(dxp == 0) and torch.all(dw == 0)


def _port_synthesis_grads(inp, ft, hop):
    half = ft // 2 + 1
    mag, phs, wr, wi = (t(inp[k]).requires_grad_() for k in ("mag", "phs", "wr", "wi"))
    w = cuda_frontend.stack_synthesis_weights(*frontend.fold_synthesis_weights(wr, wi, half))
    wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop)
    return torch.autograd.grad((wave * t(inp["a"])).sum(), (mag, phs, wr, wi))


@GEOMS
def test_synthesis_grads_match_jax_pallas(ft, hop, chunk, b):
    inp = synthesis_bwd_inputs(ft, hop, b)
    half = ft // 2 + 1
    a = jnp.asarray(inp["a"])

    def loss(mag, phs, wr, wi):
        wr_eff, wi_eff = jfrontend.fold_synthesis_weights(wr, wi, half)
        w = pf.stack_synthesis_weights(wr_eff, wi_eff, half)
        return jnp.sum(pf.fused_synthesis(mag, phs, w, ft, hop, half, jnp.float32, True) * a)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(inp[k]) for k in ("mag", "phs", "wr", "wi")))
    _cuda.reset_counts()
    got = _port_synthesis_grads(inp, ft, hop)
    assert cuda_frontend.SYNTHESIS_BWD.plain_calls == 1
    assert cuda_frontend.SYNTHESIS_BWD.launches == 0
    for g, w_, name in zip(got, want, ("dmag", "dphs", "dwr", "dwi")):
        np.testing.assert_allclose(n(g), np.asarray(w_), atol=5e-4, rtol=5e-4, err_msg=name)
    # the first and last frame lie wholly in the trimmed margin: exact zeros
    for g in got[:2]:
        assert np.all(n(g)[0] == 0) and np.all(n(g)[-1] == 0)
    # rows >= half get the mirrored (imag: negated) gradient of rows 1..half-2
    dwr, dwi = n(got[2]), n(got[3])
    np.testing.assert_array_equal(dwr[half:], dwr[1 : half - 1][::-1])
    np.testing.assert_array_equal(dwi[half:], -dwi[1 : half - 1][::-1])


@GEOMS
def test_synthesis_plain_backward_matches_autograd(ft, hop, chunk, b):
    inp = synthesis_bwd_inputs(ft, hop, b, seed=1)
    half = ft // 2 + 1
    mag, phs = t(inp["mag"]).requires_grad_(), t(inp["phs"]).requires_grad_()
    w = cuda_frontend.stack_synthesis_weights(
        *frontend.fold_synthesis_weights(t(inp["wr"]), t(inp["wi"]), half)).requires_grad_()
    wave = cuda_frontend.fused_synthesis_reference(mag, phs, w, ft, hop)
    want = torch.autograd.grad((wave * t(inp["a"])).sum(), (mag, phs, w))
    got = cuda_frontend.fused_synthesis_bwd_reference(
        mag.detach(), phs.detach(), w.detach(), t(inp["a"]), ft, hop)
    for g, w_, name in zip(got, want, ("dmag", "dphs", "dw")):
        np.testing.assert_allclose(n(g), n(w_), atol=5e-4, rtol=5e-4, err_msg=name)


def test_backward_takes_strided_and_expanded_cotangents():
    """The cotangents autograd hands to backward may be expanded (sum) or
    strided (a transposed use) views; the Functions make them contiguous."""
    ft, hop, chunk, b = BWD_GEOMS[0]
    inp = analysis_bwd_inputs(ft, hop, chunk, b, seed=3)
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(t(inp["x"]), (ft, ft))
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half).requires_grad_()
    mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop)
    c_bm = t(inp["c"]).transpose(0, 1).contiguous()  # batch-major
    (got,) = torch.autograd.grad(mag.sum() + (phs.transpose(0, 1) * c_bm).sum(), w)
    _, want = cuda_frontend.fused_analysis_bwd_reference(
        xp, w.detach(), torch.ones_like(mag), t(inp["c"]), ft, hop)
    assert_dw_close(n(got), n(want))


def test_phs_and_mag_used_twice_sum_their_cotangents():
    """mag feeds the autoencoder and the skip-filter, phs the autoencoder and
    the residual skip: autograd sums the two cotangents before kernel D."""
    ft, hop, chunk, b = BWD_GEOMS[0]
    inp = analysis_bwd_inputs(ft, hop, chunk, b, seed=4)
    half = ft // 2 + 1
    xp = torch.nn.functional.pad(t(inp["x"]), (ft, ft))
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half).requires_grad_()
    a, c = t(inp["a"]), t(inp["c"])
    mag, phs = cuda_frontend.fused_analysis(xp, w, ft, hop)
    (got,) = torch.autograd.grad((mag * a).sum() + (mag[-9:] * a[-9:]).sum()
                                 + (phs * c).sum() + (phs[-9:] * c[-9:]).sum(), w)
    a2, c2 = a.clone(), c.clone()
    a2[-9:] *= 2
    c2[-9:] *= 2
    _, want = cuda_frontend.fused_analysis_bwd_reference(xp, w.detach(), a2, c2, ft, hop)
    assert_dw_close(n(got), n(want))


@pytest.mark.parametrize("ft,hop,length,pad", [(64, 24, 512, 64), (16, 5, 37, 0), (100, 30, 700, 100)])
def test_framing_adjoints_match_jax(ft, hop, length, pad):
    """frame_signal and overlap_add differentiate by plain autograd to each
    other's adjoints, as the JAX package's framing VJPs do."""
    rng = np.random.default_rng(ft + length)
    x = rng.normal(size=(3, length)).astype(np.float32)
    frames_shape = np.asarray(jframing.frame_signal(jnp.asarray(x), ft, hop, pad)).shape
    g = rng.normal(size=frames_shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jframing.frame_signal(v, ft, hop, pad) * g))(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (got,) = torch.autograd.grad((framing.frame_signal(xt, ft, hop, pad) * t(g)).sum(), xt)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)

    fr = rng.normal(size=(2, 7, ft)).astype(np.float32)
    go = rng.normal(size=(2, 6 * hop + ft)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jframing.overlap_add(v, hop) * go))(jnp.asarray(fr))
    frt = t(fr).requires_grad_()
    (got,) = torch.autograd.grad((framing.overlap_add(frt, hop) * t(go)).sum(), frt)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


# (m, n, k) of a tensor-core product, and the K slices the rule gives it
K_SLICES = {
    "D dW, flagship batch 200": ((1024, 1028, 25 * 200), 4),  # 64 tiles: 256 blocks
    "D dW, 7 K steps": ((1024, 1028, 7 * 32), 1),
    "D dW, small, 400 K steps": ((64, 68, 400 * 32), 50),
    "D dW, small, 4 K steps": ((64, 68, 4 * 32), 1),
    "B frames, flagship batch 200": ((7 * 200, 1024, 1028), 3),  # 88 tiles: 264 blocks
    "B frames, flagship batch 643": ((7 * 643, 1024, 1028), 1),  # 288 tiles fill the card
    "E dspec, flagship batch 200": ((7 * 200, 1028, 1024), 3),
    "E dW, flagship batch 200": ((1024, 1028, 7 * 200), 4),
    "B frames, ft 600 batch 100": ((7 * 100, 600, 604), 2),  # at least 8 K steps a slice
    "E dW, ft 600 batch 100": ((600, 604, 7 * 100), 2),
}


@pytest.mark.parametrize("shape,want", K_SLICES.values(), ids=K_SLICES.keys())
def test_dw_slices_are_fixed_by_the_shapes(shape, want):
    """The number of K slices of a tensor-core product (dW of D and E, B's
    frames, E's dspec) depends on shapes only (a fixed summation order), is at
    least 1, keeps every full-width block on the card at once and leaves every
    slice at least 8 K steps."""
    m, nn, k = shape
    got = cuda_frontend.k_slices(m, nn, k)
    assert got == want
    assert got == 1 or (-(-m // 128) * (nn // 128) * got <= 2 * 132 and -(-k // 32) // got >= 8)
