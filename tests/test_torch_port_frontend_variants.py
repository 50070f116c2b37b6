"""The port's DCT and FNN front-ends (ops/dct_frontend.py, ops/frontend.py)
and ``framing.undo_sliding_window`` against the JAX package's, on the CPU.

Each module gets the JAX module's parameters (its init, perturbed so that a
layout error cannot hide) through ``checkpoint.frontend_params_to_state_dict``
and the same seeded numpy input, at ft 64 / w 128 / hop 64:

* float32 outputs within atol 1e-4 (tests/test_dct_fnn.py:40,78);
* bfloat16 (the JAX ``compute_dtype=jnp.bfloat16`` result): the same
  bf16-rounded operands and float32 sums on both sides, so only the order
  of the float32 sums differs: atol 1e-5 + rtol 1e-5, the tolerance of the
  bf16 gemm policy itself (tests/test_torch_port_bf16.py);
* the gradients of <out, cotangent> with respect to the input and every
  parameter against ``jax.grad``, within 5e-4, in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.ops import dct_frontend as jdct
from signaltrain_tpu.ops import framing as jframing
from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu_torch.ops import dct_frontend, framing, frontend
from signaltrain_tpu_torch.training import checkpoint
from tests.torch_port_util import n, t

FT, W, HOP, L, B, T = 64, 128, 64, 1024, 3, 5
HALF = FT // 2 + 1
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=1e-5, rtol=1e-5)}
GRAD_TOL = 5e-4


def _inputs(kind: str, rng):
    """The module's seeded numpy inputs."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    if kind == "dct_analysis":
        return (0.5 * f32(B, L),)
    if kind in ("dct_synthesis", "tied"):
        return (f32(B, 17, FT),)  # the frames DCTAnalysis gives a (B, 1024) signal
    if kind == "fnn_analysis":
        return (f32(B, T, FT),)
    return f32(B, T, HALF), f32(B, T, HALF)


def _modules(kind: str, jdtype, pdtype):
    """(the JAX params, perturbed; jfn(params, *inputs); the port's module
    holding those params; pfn(*inputs), the port's function; the inputs)."""
    rng = np.random.default_rng(1)
    if kind == "dct_analysis":
        jm = jdct.DCTAnalysis(ft_size=FT, w_size=W, hop_size=HOP, compute_dtype=jdtype)
        pm = dct_frontend.DCTAnalysis(FT, W, HOP, device="cpu", compute_dtype=pdtype)
    elif kind in ("dct_synthesis", "tied"):
        jm = jdct.DCTSynthesis(ft_size=FT, w_size=W, hop_size=HOP, compute_dtype=jdtype)
        pm = dct_frontend.DCTSynthesis(FT, W, HOP, device="cpu", compute_dtype=pdtype)
    elif kind == "fnn_analysis":
        jm = jfrontend.FNNAnalysis(ft_size=FT, compute_dtype=jdtype)
        pm = frontend.FNNAnalysis(FT, device="cpu", compute_dtype=pdtype)
    else:
        random_init = kind == "fnn_synthesis_random"
        jm = jfrontend.FNNSynthesis(ft_size=FT, random_init=random_init, compute_dtype=jdtype)
        pm = frontend.FNNSynthesis(FT, random_init=random_init, device="cpu",
                                   compute_dtype=pdtype)
    inputs = _inputs(kind, np.random.default_rng(0))
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), *map(jnp.asarray, inputs)))
    params = {"params": {k: (v + 0.1 * np.abs(v).mean() * rng.normal(size=v.shape)).astype(
        np.float32) if k != "bias" else rng.normal(size=v.shape).astype(np.float32) * 0.1
        for k, v in params["params"].items()}}
    pm.load_state_dict(checkpoint.frontend_params_to_state_dict(params), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    if kind == "tied":
        def jfn(p, x):
            return jdct.tied_transform(p["params"]["weight"], x, HOP, FT, compute_dtype=jdtype)

        def pfn(x):
            return dct_frontend.tied_transform(pm.weight, x, HOP, FT, compute_dtype=pdtype)
    else:
        def jfn(p, *xs):
            return jm.apply(p, *xs)

        pfn = pm
    return params, jfn, pm, pfn, inputs


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


KINDS = ["dct_analysis", "dct_synthesis", "tied", "fnn_analysis", "fnn_synthesis",
         "fnn_synthesis_random"]


def test_core_modulation_equals_jax():
    for k, wsz in ((32, 64), (FT, W), (1024, 2048)):
        np.testing.assert_allclose(dct_frontend.core_modulation(k, wsz),
                                   jdct.core_modulation(k, wsz), atol=1e-6)
    np.testing.assert_array_equal(dct_frontend.cosine_window(W), jdct.cosine_window(W))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(kind, dtype):
    params, jfn, pm, pfn, inputs = _modules(kind, *DTYPES[dtype])
    want = _flat(jfn(params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = _flat(pfn(*map(t, inputs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(n(g), np.asarray(w), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(kind, dtype):
    params, jfn, pm, pfn, inputs = _modules(kind, *DTYPES[dtype])
    rng = np.random.default_rng(2)
    outs = _flat(jfn(params, *map(jnp.asarray, inputs)))
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def jloss(p, *xs):
        return sum(jnp.sum(o * c) for o, c in zip(_flat(jfn(p, *xs)), cots))

    argnums = tuple(range(len(inputs) + 1))
    jgrads = jax.grad(jloss, argnums=argnums)(params, *map(jnp.asarray, inputs))
    xs = [t(a).requires_grad_(True) for a in inputs]
    loss = sum((o * t(c)).sum() for o, c in zip(_flat(pfn(*xs)), cots))
    loss.backward()
    for x, jg in zip(xs, jgrads[1:]):
        np.testing.assert_allclose(n(x.grad), np.asarray(jg), atol=GRAD_TOL, rtol=0)
    named = dict(pm.named_parameters())
    for name, jg in jgrads[0]["params"].items():
        got = named[name].grad
        if kind == "tied":  # the tied transform reads the synthesis module's weight only
            assert name == "weight"
        np.testing.assert_allclose(n(got), np.asarray(jg), atol=GRAD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("length,ft,w,hop", [(L, FT, W, HOP), (8192, 1024, 2048, 1024)])
def test_dct_frame_count_is_jaxs(length, ft, w, hop):
    """DCTAnalysis pads by ft_size (cls_fe_dct_bases.py:116-135), not w_size."""
    want = jax.eval_shape(
        lambda x: jframing.frame_signal(x, w, hop, pad=ft), jnp.zeros((1, length))).shape
    assert framing.frame_signal(torch.zeros(1, length), w, hop, pad=ft).shape == want
    assert want[1] == jframing.num_frames(length, w, hop, ft) == framing.num_frames(
        length, w, hop, ft)
    ana = dct_frontend.DCTAnalysis(ft, w, hop, device="cpu")
    with torch.no_grad():
        assert ana(torch.zeros(1, length)).shape == (1, want[1], ft)


def test_dct_round_trip_near_identity():
    """Analysis then synthesis with w = 2 ft, hop = ft reconstructs the
    interior (tests/test_dct_fnn.py's check), and the FNN pair is exact."""
    x = np.random.default_rng(1).normal(size=(1, 4096)).astype(np.float32)
    ana = dct_frontend.DCTAnalysis(FT, W, HOP, use_bias=False, device="cpu")
    syn = dct_frontend.DCTSynthesis(FT, W, HOP, device="cpu")
    with torch.no_grad():
        rec = n(syn(ana(t(x))))
    a = rec[0, 256:-256]
    assert np.corrcoef(a, x[0, 256:-256][: a.shape[0]])[0, 1] > 0.95
    frames = t(np.random.default_rng(2).normal(size=(2, T, FT)).astype(np.float32))
    with torch.no_grad():
        re, im = frontend.FNNAnalysis(FT, device="cpu")(frames)
        rec = frontend.FNNSynthesis(FT, device="cpu")(re, im)
    np.testing.assert_allclose(n(rec), n(frames), atol=1e-4)


def test_fnn_random_init_is_glorot_uniform_from_the_generator():
    a = frontend.FNNSynthesis(FT, random_init=True, device="cpu",
                              generator=torch.Generator().manual_seed(5))
    b = frontend.FNNSynthesis(FT, random_init=True, device="cpu",
                              generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.w_real, b.w_real) and not torch.equal(a.w_real, a.w_imag)
    limit = (6.0 / (2 * FT)) ** 0.5
    w = n(a.w_real.detach())
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert abs(w.var() - limit**2 / 3) < 0.1 * limit**2 / 3  # U(-l, l) has variance l^2 / 3


@pytest.mark.parametrize("length,size,overlap", [(10, 5, 2), (1000, 128, 32), (4096, 512, 0)])
def test_undo_sliding_window_equals_jax(length, size, overlap):
    x = np.random.default_rng(length).normal(size=length).astype(np.float32)
    win = framing.sliding_window(t(x), size, overlap)
    np.testing.assert_array_equal(n(win), np.asarray(jframing.sliding_window(jnp.asarray(x),
                                                                              size, overlap)))
    for flat in (None, length):
        got = framing.undo_sliding_window(win, overlap, flat)
        want = jframing.undo_sliding_window(jnp.asarray(n(win)), overlap, flat)
        np.testing.assert_array_equal(n(got), np.asarray(want))
    if overlap:
        np.testing.assert_array_equal(n(framing.undo_sliding_window(win, overlap, length)), x)
