"""The split-TF32 arithmetic of kernels A, B, D and E, on the CPU.

csrc/tc_product.cuh forms every f32 product on the tensor cores from three
TF32 ones. A CUDA kernel cannot run here, but its arithmetic can:
cuda_frontend.split_tf32 / split_tf32_matmul round as the kernel does and add
the three products in its order; K slices are summed in order as the passes
after a sliced product add them. These tests hold that arithmetic to the
tolerances the kernels are held to on the card: the analysis rule of
tests/torch_port_util.assert_analysis_close against the plain version and
against the JAX package's Pallas kernel (interpret mode), 5e-4 on the
gradients with well-conditioned cotangents, 3e-4 + 3e-4|wave| on the
synthesis waveform and 5e-4 + 5e-4|g| on the synthesis gradients. One TF32
product alone misses the magnitude tolerance: that is why the split is there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, framing, frontend
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import (FLAGSHIP, analysis_bwd_inputs, assert_analysis_close,
                                   assert_close_where_conditioned, n,
                                   regular_phase_cotangent, synthesis_bwd_inputs, t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FT, HOP, CHUNK = FLAGSHIP["ft"], FLAGSHIP["hop"], FLAGSHIP["chunk"]
HALF = FT // 2 + 1
LDC = cuda_frontend.packed_width(HALF)
BATCH = 4


@pytest.fixture(scope="module")
def demo():
    """The shipped comp_4c model's analysis matrices and a seeded padded batch."""
    model, _ = load_model(os.path.join(REPO, "demo", "model_comp4c_demo.tar"), device="cpu")
    an = model.mpaec.dft_analysis
    with torch.no_grad():
        w = an.stacked_weights().contiguous()
        wr = an.conv_analysis_real.weight[:, 0, :].clone()
        wi = an.conv_analysis_imag.weight[:, 0, :].clone()
    x = (np.random.default_rng(11).normal(size=(BATCH, CHUNK)) * 0.3).astype(np.float32)
    return dict(w=w, wr=wr, wi=wi, xp=np.pad(x, ((0, 0), (FT, FT))))


def _frames(xp: torch.Tensor) -> torch.Tensor:
    """(T, B, ft) frames of the padded signal, not halved."""
    return framing.frame_signal(xp, FT, HOP, pad=0).transpose(0, 1)


def _split_analysis(xp: torch.Tensor, w: torch.Tensor):
    """Kernel A's arithmetic: the split product of the raw frames, the x/2 on
    the finished sum (exact), magnitude and phase."""
    spec = 0.5 * cuda_frontend.split_tf32_matmul(_frames(xp), w)
    return cuda_frontend.mag_phs(spec[..., :HALF], spec[..., HALF:])


@pytest.mark.parametrize("scale", [1e-20, 1.0, 3e7])
def test_split_recovers_x(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 30)
    x = t(rng.normal(size=4096) * scale)
    hi, lo = cuda_frontend.split_tf32(x)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21
    # both parts are TF32 values: the low 13 bits of the mantissa are zero
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float((lo.abs() / x.abs()).max()) <= 2.0 ** -11  # hi is x rounded to nearest


def test_split_rounds_to_nearest_ties_away_and_keeps_zeros():
    bits = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F802FFF, 0x3F803000],
                        dtype=torch.int32)
    x = torch.cat([bits.view(torch.float32), -bits.view(torch.float32)])
    hi = cuda_frontend.split_tf32(x)[0].view(torch.int32) & 0x7FFFFFFF
    want = [0x3F800000, 0x3F802000, 0x3F802000, 0x3F802000, 0x3F804000]
    assert hi.tolist() == want + want  # as cvt.rna.tf32.f32: a tie goes away from zero
    z = torch.tensor([0.0, -0.0])
    for part in cuda_frontend.split_tf32(z):
        assert torch.all(part == 0)
    # an all-zero frame times any weights is an exact zero
    assert torch.all(cuda_frontend.split_tf32_matmul(torch.zeros(3, 8), torch.randn(8, 5)) == 0)


def test_split_analysis_matches_plain_and_pallas(demo):
    xp, w = t(demo["xp"]), demo["w"]
    mag, phs = _split_analysis(xp, w)
    rmag, rphs = cuda_frontend.fused_analysis_reference(xp, w, FT, HOP)
    stats = assert_analysis_close(mag, phs, rmag, rphs)
    assert stats["regular_bins"] > 0.9 * mag.numel() * 23 / 25  # the rule's main class is not empty
    # edge frames cover only padding: the floor and atan2(0, 1e-7), exactly
    assert torch.all(mag[0] == np.float32(1e-18)) and torch.all(phs[0] == 0)
    assert torch.all(mag[-1] == np.float32(1e-18)) and torch.all(phs[-1] == 0)

    jw = pf.stack_analysis_weights(jnp.asarray(n(demo["wr"])), jnp.asarray(n(demo["wi"])), HALF)
    jmag, jphs = pf.fused_analysis(jnp.asarray(demo["xp"]), jw, FT, HOP, HALF, jnp.float32, True)
    assert_analysis_close(mag, phs, np.asarray(jmag), np.asarray(jphs))


def test_split_product_is_as_accurate_as_f32(demo):
    xp, w = t(demo["xp"]), demo["w"]
    spec64 = 0.5 * (_frames(xp).double() @ w.double())
    mag64 = torch.sqrt(spec64[..., :HALF] ** 2 + spec64[..., HALF:] ** 2).clamp_min(1e-18)
    err = float((_split_analysis(xp, w)[0] - mag64).abs().max())
    plain = float((cuda_frontend.fused_analysis_reference(xp, w, FT, HOP)[0] - mag64).abs().max())
    assert err <= 2 * plain + 1e-7, (err, plain)


def test_one_tf32_product_misses_the_magnitude_tolerance(demo):
    """hi parts only, as a plain TF32 tensor-core product would compute."""
    xp, w = t(demo["xp"]), demo["w"]
    spec = 0.5 * torch.matmul(cuda_frontend.split_tf32(_frames(xp))[0],
                              cuda_frontend.split_tf32(w)[0])
    mag = cuda_frontend.mag_phs(spec[..., :HALF], spec[..., HALF:])[0]
    rmag = cuda_frontend.fused_analysis_reference(xp, w, FT, HOP)[0]
    assert float(((mag - rmag).abs() - (2e-5 + 2e-5 * rmag.abs())).max()) > 0


@pytest.mark.parametrize("cot", ["regular", "full"])
def test_split_gradients_match_plain(cot):
    """Kernel D's three products in split arithmetic. With well-conditioned
    phase cotangents: dx and dW within 5e-4 of the plain version. With a
    unit-normal phase cotangent on every bin (ill-conditioned): against the
    plain version in float64, with the slack each element's conditioning
    gives it."""
    b = 2
    inp = analysis_bwd_inputs(FT, HOP, CHUNK, b)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, FT, HOP)
    xp = torch.nn.functional.pad(t(inp["x"]), (FT, FT))
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), HALF)
    dmag, dphs = t(inp["a"]), t(inp["c"])
    mm = cuda_frontend.split_tf32_matmul

    frames = _frames(xp)
    spec = 0.5 * mm(frames, w)
    re, im = spec[..., :HALF], spec[..., HALF:]
    sq = re * re + im * im
    gm = torch.where(sq >= 1e-36, dmag / torch.sqrt(sq.clamp_min(1e-36)), torch.zeros_like(sq))
    rr = re + 1e-7
    den = rr * rr + im * im
    dspec = torch.cat([gm * re - dphs * im / den, gm * im + dphs * rr / den], dim=-1)
    dxp = framing.overlap_add((0.5 * mm(dspec, w.t().contiguous())).transpose(0, 1), HOP)
    dxp = torch.nn.functional.pad(dxp, (0, xp.shape[1] - dxp.shape[1]))
    dw = 0.5 * mm(frames.reshape(-1, FT).t().contiguous(), dspec.reshape(-1, 2 * HALF))

    if cot == "regular":
        rdxp, rdw = cuda_frontend.fused_analysis_bwd_reference(xp, w, dmag, dphs, FT, HOP)
        np.testing.assert_allclose(n(dxp), n(rdxp), atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(n(dw), n(rdw), atol=5e-4, rtol=5e-4)
        return
    xdxp, xdw = cuda_frontend.fused_analysis_bwd_reference(xp.double(), w.double(), dmag.double(),
                                                           dphs.double(), FT, HOP)
    sdxp, sdw = cuda_frontend.fused_analysis_bwd_conditioning(xp, w, dmag, dphs, FT, HOP)
    sl = slice(FT, -FT)  # the padding's part of dxp carries the all-zero frames' adjoint
    assert_close_where_conditioned(dxp[:, sl], xdxp[:, sl], sdxp[:, sl], name="dx")
    assert_close_where_conditioned(dw, xdw, sdw, name="dW")
    # the slack is no blank cheque: half of dx gets less than the 5e-4 itself,
    # and the all-padding edge frames contribute exactly nothing
    assert float((sdxp[:, sl] < 5e-4).double().mean()) > 0.4
    assert torch.isfinite(sdw).all() and torch.isfinite(sdxp).all()


# ---- kernels B and E: the synthesis side

@pytest.fixture(scope="module")
def syn():
    """Seeded synthesis inputs at the flagship geometry, batch 4 (OT 9), and
    the folded, stacked synthesis weights (2*half, ft)."""
    inp = synthesis_bwd_inputs(FT, HOP, BATCH)
    w = cuda_frontend.stack_synthesis_weights(
        *frontend.fold_synthesis_weights(t(inp["wr"]), t(inp["wi"]), HALF))
    return dict(inp, w=w)


def _interleave(x: torch.Tensor) -> torch.Tensor:
    """(..., 2*half) stacked as [re | im] -> (..., ldc) with re and im of a bin
    side by side and zero padding columns: the layout of the kernels' packed
    weights and spectra."""
    out = torch.zeros(*x.shape[:-1], LDC)
    out[..., 0 : 2 * HALF : 2] = x[..., :HALF]
    out[..., 1 : 2 * HALF : 2] = x[..., HALF:]
    return out


def _sliced_matmul(a: torch.Tensor, b: torch.Tensor, nsplit: int) -> torch.Tensor:
    """a @ b in split arithmetic with K cut as the kernels cut it: the 32-wide
    K steps in nsplit contiguous slices, the slices' results added in order."""
    steps = -(-a.shape[-1] // 32)
    bounds = [steps * z // nsplit * 32 for z in range(nsplit + 1)]
    parts = [cuda_frontend.split_tf32_matmul(a[..., lo:hi], b[lo:hi])
             for lo, hi in zip(bounds, bounds[1:])]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _split_synthesis(mag: torch.Tensor, phs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel B's arithmetic: the interleaved spectrum of the live frames
    1 .. OT-2, the K-sliced split product with the packed (ft, ldc) weights,
    the overlap-add and the trim."""
    ot, b = mag.shape[:2]
    live = mag[1:-1]
    spec = _interleave(torch.cat([live * torch.cos(phs[1:-1]), live * torch.sin(phs[1:-1])], -1))
    rows = (ot - 2) * b
    wp = _interleave(w.t())  # wp[j, 2*bin + part] = w[part*half + bin, j]
    frames = _sliced_matmul(spec.reshape(rows, LDC), wp.t(), cuda_frontend.k_slices(rows, FT, LDC))
    wave = framing.overlap_add(frames.reshape(ot - 2, b, FT).transpose(0, 1), HOP)
    out_len = (ot - 1) * HOP - FT
    return wave[:, FT - HOP : FT - HOP + out_len]  # the live frames start at sample hop


def test_split_synthesis_matches_plain_and_pallas(syn):
    mag, phs, w = t(syn["mag"]), t(syn["phs"]), syn["w"]
    assert cuda_frontend.k_slices((mag.shape[0] - 2) * BATCH, FT, LDC) > 1  # slices are summed
    wave = _split_synthesis(mag, phs, w)
    ref = cuda_frontend.fused_synthesis_reference(mag, phs, w, FT, HOP)
    assert wave.shape == ref.shape == (BATCH, 2048)
    np.testing.assert_allclose(n(wave), n(ref), atol=3e-4, rtol=3e-4)

    jwr, jwi = jfrontend.fold_synthesis_weights(jnp.asarray(syn["wr"]), jnp.asarray(syn["wi"]), HALF)
    want = pf.fused_synthesis(jnp.asarray(syn["mag"]), jnp.asarray(syn["phs"]),
                              pf.stack_synthesis_weights(jwr, jwi, HALF), FT, HOP, HALF,
                              jnp.float32, True)
    np.testing.assert_allclose(n(wave), np.asarray(want), atol=3e-4, rtol=3e-4)


def test_split_synthesis_bwd_matches_plain(syn):
    """Kernel E's arithmetic: dspec by tc::Spectrum on the padded dout from the
    first live frame on, K-sliced, then dmag and dphs; dW^T by the K-sliced
    product of the frames with the interleaved spectrum, un-interleaved and
    transposed. Frames 0 and OT-1 are never read: exact zeros."""
    mag, phs, w, dout = t(syn["mag"]), t(syn["phs"]), syn["w"], t(syn["a"])
    ot, b = mag.shape[:2]
    rows = (ot - 2) * b
    doutp = torch.nn.functional.pad(dout, (FT, FT))
    dframe = framing.frame_signal(doutp[:, HOP:], FT, HOP, pad=0)[:, : ot - 2]
    dframe = dframe.transpose(0, 1).reshape(rows, FT)
    n_dspec, n_dw = cuda_frontend.k_slices(rows, LDC, FT), cuda_frontend.k_slices(FT, LDC, rows)
    assert n_dspec > 1 and n_dw == 1  # batch 4: E's dW has 4 K steps
    dspec = _sliced_matmul(dframe, _interleave(w.t()), n_dspec).reshape(ot - 2, b, LDC)
    d_re, d_im = dspec[..., 0 : 2 * HALF : 2], dspec[..., 1 : 2 * HALF : 2]
    c, s = torch.cos(phs[1:-1]), torch.sin(phs[1:-1])
    dmag, dphs = torch.zeros_like(mag), torch.zeros_like(mag)
    dmag[1:-1] = d_re * c + d_im * s
    dphs[1:-1] = mag[1:-1] * (d_im * c - d_re * s)
    spec = _interleave(torch.cat([mag[1:-1] * c, mag[1:-1] * s], -1)).reshape(rows, LDC)
    dwt = _sliced_matmul(dframe.t().contiguous(), spec, n_dw)  # (ft, ldc)
    dw = torch.cat([dwt[:, 0 : 2 * HALF : 2], dwt[:, 1 : 2 * HALF : 2]], 1).t()

    want = cuda_frontend.fused_synthesis_bwd_reference(mag, phs, w, dout, FT, HOP)
    for got, ref, name in zip((dmag, dphs, dw), want, ("dmag", "dphs", "dW")):
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(n(got), n(ref), atol=5e-4, rtol=5e-4, err_msg=name)
    for ref in want[:2]:
        assert torch.all(ref[0] == 0) and torch.all(ref[-1] == 0)


@pytest.mark.parametrize("ft,hop,lp,width", [(1024, 384, 10240, 4), (64, 24, 640, 4),
                                             (100, 30, 900, 1), (16, 5, 235, 1),
                                             (1024, 384, 10241, 1)])
def test_loader_is_chosen_by_alignment(ft, hop, lp, width):
    """16-byte copies need every frame offset b*lp + t*hop, the frame length
    and the pointers on 4-float boundaries; anything else takes 4-byte copies."""
    xp = torch.zeros(2, lp)
    assert cuda_frontend.copy_width(ft, hop, lp, xp) == width
    if width == 4:  # a misaligned pointer falls back to the 4-byte loader
        assert cuda_frontend.copy_width(ft, hop, lp, torch.zeros(lp + 1)[1:]) == 1
    half = ft // 2 + 1
    assert cuda_frontend.packed_width(half) % 4 == 0
    assert 0 <= cuda_frontend.packed_width(half) - 2 * half < 4


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A kernel library is named by its source AND the headers it may include,
    so an edited tc_product.cuh cannot load a stale build."""
    for name in ("frontend.cu", "tc_product.cuh"):
        (tmp_path / name).write_bytes((_cuda.CSRC / name).read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = _cuda.library_path("frontend")
    assert before == _cuda.library_path("frontend")
    with open(tmp_path / "tc_product.cuh", "ab") as f:
        f.write(b"// edited\n")
    assert _cuda.library_path("frontend") != before
