"""The port's envelope smoother and comp_4c effect against the JAX package.

The plain version of kernel C (dsp/iir.switched_one_pole, reached through
ops/cuda_kernels.switched_one_pole_batched on CPU tensors) is held to the
Pallas kernel in interpret mode and to the lax.scan smoother at atol 1e-6
(tests/test_pallas_smoother.py:52); the compressor and Compressor_4c to the
JAX compressor at atol 1e-5 (tests/test_pallas_smoother.py:185: log10/exp/
pow round differently in the two libraries).

Kernel C's chunked schedule (speculate, then verify; csrc/smoother.cu) runs
only on the card. Its logic is held here through a plain model of it, with
the kernel's warm-up rule, meeting rule and fix-up walk, bit-equal to the
plain version on rows that meet at once, that need fix-ups and that never
meet.
"""

import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.dsp import compressors as jcomp
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import iir as jiir
from signaltrain_tpu.ops import pallas_kernels as pk
from signaltrain_tpu_torch.cli import time_smoother
from signaltrain_tpu_torch.dsp import compressors, effects, iir, synths
from signaltrain_tpu_torch.ops import _cuda, cuda_kernels
from tests.torch_port_util import n, t


def _case(b, length, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, length)).astype(np.float32)
    aa = rng.uniform(0.9, 0.999, size=(b,)).astype(np.float32)
    ar = rng.uniform(0.9, 0.999, size=(b,)).astype(np.float32)
    return g, aa, ar


@pytest.mark.parametrize(
    "b,length",
    [
        (1, 8),          # minimum
        (3, 50),         # N not a multiple of 8
        (1024, 40),      # batch exactly one (8, 128) tile: the round-5 crash width
        (4, 2 * 512 + 137),  # longer than one 512-step time block
        (200, 300),      # training-like batch, per-example alphas
    ],
)
def test_plain_smoother_matches_pallas_and_scan(b, length):
    g, aa, ar = _case(b, length, seed=b * 1000 + length)
    _cuda.reset_counts()
    got = n(cuda_kernels.switched_one_pole_batched(t(g), t(aa), t(ar)))
    assert cuda_kernels.SMOOTHER.plain_calls == 1 and cuda_kernels.SMOOTHER.launches == 0
    want_kernel = pk.switched_one_pole_batched(jnp.asarray(g), jnp.asarray(aa),
                                               jnp.asarray(ar), interpret=True)
    want_scan = jax.vmap(jiir.switched_one_pole)(jnp.asarray(g), jnp.asarray(aa),
                                                 jnp.asarray(ar))
    assert np.all(got[:, 0] == 0.0)
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want_scan), atol=1e-6)


@pytest.mark.parametrize("length", [257, 1000])
def test_plain_smoother_adversarial_rows_match_pallas_and_scan(length):
    """cli/time_smoother.adversarial_rows (ties, +-0.0, subnormals, alpha_a >
    alpha_r, equal alphas, alphas 0 and 0.9999, a step) through the plain
    version, against the Pallas kernel in interpret mode and the lax.scan at
    the same 1e-6 (on the CPU XLA may flush the subnormal rows to zero); the
    rows hit what they are named for."""
    g, aa, ar = (x.numpy() for x in time_smoother.adversarial_rows(length, torch.device("cpu")))
    got = n(cuda_kernels.switched_one_pole_batched(t(g), t(aa), t(ar)))
    want_kernel = pk.switched_one_pole_batched(jnp.asarray(g), jnp.asarray(aa),
                                               jnp.asarray(ar), interpret=True)
    want_scan = jax.vmap(jiir.switched_one_pole)(jnp.asarray(g), jnp.asarray(aa),
                                                 jnp.asarray(ar))
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want_scan), atol=1e-6)
    names = [name for name, _, _ in time_smoother.ADVERSARIAL]
    ties = g[:, 1:] == got[:, :-1]  # g[n] == s[n-1]: the select takes alpha_r
    for name in ("ties", "ties_release", "negative_zeros"):
        assert ties[names.index(name)].sum() > length // 2, name
    sub = np.abs(got[names.index("subnormal_decay")])
    assert np.any((sub > 0) & (sub < np.finfo(np.float32).tiny))
    zero = names.index("alpha_0")
    np.testing.assert_array_equal(got[zero, 1:], g[zero, 1:])  # alpha 0: s = g


@pytest.mark.parametrize("rows,sms,per", [
    (1, 132, 1), (7, 132, 1), (8, 132, 1), (9, 132, 1), (64, 132, 1), (132, 132, 1),
    (133, 132, 2), (200, 132, 2), (264, 132, 2), (265, 132, 4), (528, 132, 4),
    (529, 132, 8), (645, 132, 8), (1292, 132, 8), (10**6, 132, 8), (9, 4, 4), (3, 1, 4),
])
def test_rows_per_block_rule(rows, sms, per):
    """The row scan's rows a block: the least power of two, at most 8, that
    puts the rows on no more blocks than there are SMs."""
    assert cuda_kernels.rows_per_block(rows, sms) == per


def test_plain_smoother_scalar_alphas_1d():
    g, aa, ar = _case(1, 500, seed=3)
    got = iir.switched_one_pole(t(g[0]), float(aa[0]), float(ar[0]))
    want = jiir.switched_one_pole(jnp.asarray(g[0]), aa[0], ar[0])
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)


def test_smoother_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        cuda_kernels.switched_one_pole_batched(torch.zeros(1, 8, device="meta"),
                                               torch.zeros(1, device="meta"),
                                               torch.zeros(1, device="meta"))


def _knobs(b, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, size=(b,)).astype(np.float32)
            for lo, hi in ((-30, 0), (1, 5), (1e-3, 4e-2), (1e-3, 4e-2))]


def test_compressor_4controls_batched_per_example():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(6, 300)) * 0.5).astype(np.float32)
    th, ra, at, re = _knobs(6, seed=12)
    want = jcomp.compressor_4controls(jnp.asarray(x), jnp.asarray(th), jnp.asarray(ra),
                                      jnp.asarray(at), jnp.asarray(re))
    got = compressors.compressor_4controls(t(x), t(th), t(ra), t(at), t(re))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_compressor_4controls_1d_scalar_knobs():
    x = (np.random.default_rng(13).normal(size=(2000,)) * 0.5).astype(np.float32)
    args = (-20.0, 3.0, 0.005, 0.02)
    want = jcomp.compressor_4controls(jnp.asarray(x), *args)
    got = compressors.compressor_4controls(t(x), *args)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


def test_compressor_4c_go_wc_and_go_batch():
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(4, 1500)) * 0.4).astype(np.float32)
    knobs_wc = np.array([-25.0, 4.0, 0.005, 0.02], np.float32)
    knobs_nn = rng.uniform(-0.5, 0.5, size=(4, 4)).astype(np.float32)
    jfx = jeffects.Compressor_4c()
    fx = effects.Compressor_4c(device="cpu")

    y, x_out = fx.go_wc(x[0], knobs_wc)
    jy, _ = jfx.go_wc(jnp.asarray(x[0]), jnp.asarray(knobs_wc))
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-5)
    np.testing.assert_array_equal(n(x_out), x[0])

    yb, _ = fx.go_batch(x, knobs_nn)
    jyb, _ = jfx.go_batch(jnp.asarray(x), jnp.asarray(knobs_nn))
    np.testing.assert_allclose(n(yb), np.asarray(jyb), atol=1e-5)

    np.testing.assert_allclose(n(fx.knobs_wc(knobs_nn)),
                               np.asarray(jfx._knobs_wc_batch(jnp.asarray(knobs_nn))),
                               rtol=1e-6)
    yg, _ = fx.go(x[1], knobs_nn[1])
    jyg, _ = jfx.go(jnp.asarray(x[1]), jnp.asarray(knobs_nn[1]))
    np.testing.assert_allclose(n(yg), np.asarray(jyg), atol=1e-5)


def test_mu_law_matches_jax():
    y = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_allclose(n(compressors.mu_compand(t(y))),
                               np.asarray(jcomp.mu_compand(jnp.asarray(y))), atol=1e-6)
    np.testing.assert_allclose(n(compressors.mu_decompand(t(y))),
                               np.asarray(jcomp.mu_decompand(jnp.asarray(y))), atol=1e-6)


def test_make_effect():
    """Every name the JAX package registers but "files" builds the port's
    counterpart, with the JAX effect's name, knobs, ranges and is_inverse;
    "files" without a dataset directory raises FileNotFoundError, as the JAX
    package's does (tests/test_torch_port_file_data.py builds it on one), and
    an unknown name raises ValueError."""
    names = set(jeffects.EFFECTS)
    assert set(effects.EFFECTS) == names
    for name in names:
        fx = effects.make_effect(name, sr=22050, device="cpu")
        jfx = jeffects.make_effect(name, sr=22050)
        assert type(fx).__name__ == type(jfx).__name__ and fx.sr == 22050, name
        assert fx.name == jfx.name and fx.knob_names == jfx.knob_names, name
        np.testing.assert_array_equal(fx.knob_ranges, jfx.knob_ranges)
        assert fx.knob_ranges.dtype == np.float32 and fx.is_inverse == jfx.is_inverse, name
    with pytest.raises(FileNotFoundError):
        jeffects.make_effect("files")
    with pytest.raises(FileNotFoundError):
        effects.make_effect("files", device="cpu")
    with pytest.raises(ValueError):
        effects.make_effect("no_such_effect", device="cpu")


KNOBS_WC = (-25.0, 4.0, 0.005, 0.02)  # the serving path's comp_4c knobs
TILE = 256  # the kernel's staged tile: warm-ups and chunks are multiples of it
_F32 = struct.Struct("f")


def _serving_gain_curve(seconds):
    """The smoother's input on the serving path: comp_4c's gain change on a
    seeded music-like clip at the demo knobs, and its two coefficients."""
    x = synths.music_like_clip(seconds, sr=44100, seed=0)
    gc, aa, ar = compressors.gain_curve(t(x), *KNOBS_WC, sr=44100)
    return n(gc), float(aa), float(ar)


def _f32(x):
    return _F32.unpack(_F32.pack(x))[0]


def _same_bits(a, b):
    return _F32.pack(a) == _F32.pack(b)


def _warmup(aa, ar, decays, w_max):
    """The kernel's W: decays / (1 - max alpha) in float32, at most w_max,
    rounded up to a tile."""
    with np.errstate(divide="ignore"):
        w = np.float32(decays) / (np.float32(1.0) - max(np.float32(aa), np.float32(ar)))
    steps = int(math.ceil(w)) if 0 < w < w_max else w_max
    return -(-steps // TILE) * TILE


def _run(g, aa, ar, start, end, carry, out, write_from):
    """Steps start..end-1 of the recursion from the carry s[start-1] (start 0:
    s[0] = 0), each fma(alpha, s, f32((1-alpha)*g)) rounded to float32;
    stores s[i] for i >= write_from. Returns the last state."""
    one_a, one_r = _f32(1.0 - aa), _f32(1.0 - ar)
    s = carry
    for i in range(start, end):
        if i == 0:
            s = 0.0
        elif g[i] < s:
            s = _f32(aa * s + _f32(one_a * g[i]))
        else:
            s = _f32(ar * s + _f32(one_r * g[i]))
        if i >= write_from:
            out[i] = s
    return s


def _chunked_model(g, aa, ar, chunk, decays=24.0, w_max=65536):
    """A plain model of st_smoother_chunked on one row. Phase 1: chunk k runs
    from a guessed carry 0 at max(0, kL - W), writes its own L outputs and
    keeps its state at kL - 1 as spec[k]. Phase 2: from the first chunk whose
    spec is not bit-equal to the output before it, walk the tiles in order,
    re-running a chunk from the exact carry until its state at a tile's end
    equals the speculated one or the chunk ends, and skipping the chunks that
    verify. Returns (s, W, steps re-run)."""
    g = [float(v) for v in g]
    length, nch = len(g), -(-len(g) // chunk)
    w = _warmup(aa, ar, decays, w_max)
    out, spec = [0.0] * length, [0.0] * nch
    for k in range(nch):
        write, end = k * chunk, min((k + 1) * chunk, length)
        spec[k] = _run(g, aa, ar, max(0, write - w), write, 0.0, out, length)
        _run(g, aa, ar, write, end, spec[k], out, write)
    first = next((k for k in range(1, nch) if not _same_bits(spec[k], out[k * chunk - 1])), nch)
    steps = 0
    if first < nch:
        tile, carry = first * chunk // TILE, out[first * chunk - 1]
        while True:
            t0 = tile * TILE
            t1 = min(t0 + TILE, length)
            spec_end = out[t1 - 1]
            carry = _run(g, aa, ar, t0, t1, carry, out, t0)
            steps += t1 - t0
            k = t0 // chunk
            chunk_end = min((k + 1) * chunk, length)
            if t1 == chunk_end or _same_bits(carry, spec_end):
                c = carry if t1 == chunk_end else out[chunk_end - 1]
                k += 1
                while k < nch and _same_bits(spec[k], c):
                    c = out[min((k + 1) * chunk, length) - 1]
                    k += 1
                if k == nch:
                    break
                tile, carry = k * chunk // TILE, c
            else:
                tile += 1
    return np.asarray(out, np.float32), w, steps


def _randn(length, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=length) * scale).astype(np.float32)


def _silence_after_step(length):
    g = np.zeros(length, np.float32)
    g[:1000] = -20.0
    return g


# (name, g, alpha_a, alpha_r, chunk, warm-up constant, warm-up cap, re-runs expected)
_SCHEDULE_CASES = {
    "serving_curve": lambda: (*_serving_gain_curve(3.0), 512, 24.0, 65536, False),
    "serving_curve_short_warmup": lambda: (*_serving_gain_curve(3.0), 512, 4.0, 65536, True),
    "step_to_silence": lambda: (_silence_after_step(12_000), 0.99, 0.9999, 512, 24.0, 2048, True),
    "alpha_9999": lambda: (_randn(12_000, 1), 0.9999, 0.9999, 512, 24.0, 2048, True),
    "alphas_equal": lambda: (_randn(20_000, 2, 10.0), 0.99, 0.99, 512, 24.0, 65536, None),
    "n_not_multiple_of_chunk": lambda: (_randn(10 * 512 + 137, 3, 5.0), 0.97, 0.9, 512, 24.0,
                                        65536, None),
    "n_below_warmup": lambda: (_randn(3000, 4), 0.999, 0.995, 512, 24.0, 65536, False),
}


@pytest.mark.parametrize("case", sorted(_SCHEDULE_CASES))
def test_chunked_schedule_model_is_bit_equal_to_plain(case):
    g, aa, ar, chunk, decays, w_max, reruns = _SCHEDULE_CASES[case]()
    aa, ar = float(np.float32(aa)), float(np.float32(ar))  # the kernel's float32 coefficients
    got, w, steps = _chunked_model(g, aa, ar, chunk, decays, w_max)
    want = n(iir.switched_one_pole(t(g), aa, ar))
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert w % TILE == 0 and TILE <= w <= w_max
    if reruns is not None:
        assert (steps > 0) == reruns, f"{steps} steps re-run"
    if case == "n_below_warmup":
        assert len(g) < w


def test_warmup_rule_at_the_serving_knobs():
    _, aa, ar = _serving_gain_curve(0.1)
    assert (round(aa, 5), round(ar, 5)) == (0.99008, 0.99751)
    assert _warmup(aa, ar, 24.0, 65536) == 9728  # ceil(24 / (1 - 0.99751)) = 9,647, to a tile
    assert _warmup(0.9999, 0.5, 24.0, 65536) == 65536
    assert _warmup(1.0, 1.0, 24.0, 65536) == 65536


@pytest.mark.parametrize("b,length,chunked", [
    (1, 1_323_000, True),       # go_wc on the 30 s serving clip
    (1, 65_536, True), (1, 65_535, False),  # either side of the length threshold
    (64, 65_536, True), (65, 65_536, False),  # either side of the 4,096 chunks
    (3, 1_323_000, True),
    (645, 8192, False), (200, 8192, False), (1, 8192, False),  # calc_ct, training, tails
])
def test_dispatch_rule(b, length, chunked):
    assert cuda_kernels.uses_chunks(b, length) == chunked


def test_plain_smoother_matches_scan_on_a_serving_row():
    g, aa, ar = _serving_gain_curve(3.0)
    assert g.size >= 100_000
    got = n(cuda_kernels.switched_one_pole_batched(t(g[None]), t(np.float32([aa])),
                                                   t(np.float32([ar]))))
    want = np.asarray(jiir.switched_one_pole(jnp.asarray(g), np.float32(aa), np.float32(ar)))
    np.testing.assert_allclose(got[0], want, atol=1e-6)
