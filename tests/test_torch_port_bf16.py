"""The port's bfloat16 compute dtype against the JAX package's, on the CPU.

The same numpy inputs go through the JAX package with
``compute_dtype=jnp.bfloat16`` (the Pallas kernels in interpret mode) and
through the port with ``compute_dtype=torch.bfloat16`` and ``device="cpu"``
(the kernels' plain versions, which round exactly the operands the JAX
kernels cast and multiply in float32).

Both round the same operands to bf16, so their results differ by the order of
float32 sums only, and the float32 tolerances the repo already uses hold:
kernel A magnitude 2e-5 and phase 2e-4 on bins of magnitude >= 1e-2
(assert_analysis_close), kernel B 3e-4 + 3e-4*|wave|, the bf16 gemm policy
1e-5, the autoencoder 1e-5. Each of these tests also asserts that the JAX
package's own bf16 result is at least 10x the tolerance away from its
float32 one, so that a port that forgot to round cannot pass.

Gradients of kernels D and E: each package's against a float64 plain
version of the same bf16-rounded computation (the port's plain version on
float64 tensors), the port's error at most twice JAX's plus 1e-3 * max|g|
of the leaf (two results that round a quantity to bf16 cannot be compared
element by element: a float32-level difference flips a rounding by one bf16
ulp, 2^-8 relative).

The whole model (gemm against JAX's xla front-end, fused against pallas):
5e-5 on y, measured 1.2e-7 at the tiny spec and 1.3e-5 at the flagship
geometry (batch 2), against a bf16-versus-float32 gap of 8.6e-4 and 5.2e-3.

One train step: the loss to rtol 1e-5. Adam's first step moves each
parameter by lr * g / (|g| + 1e-8), about lr * sign(g), with g the clipped
gradient. So each element must move as JAX's does (2e-7) wherever JAX's g is
at least 2% of its leaf's largest (the bf16 gradients of the two packages
differ by up to 1.7% of it, so a smaller one may change sign) and at least
1000 x Adam's eps (so eps moves the step by under 0.1%), and within twice
the learning rate elsewhere.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.models import autoencoder as jae
from signaltrain_tpu.models import st_model as jst
from signaltrain_tpu.ops import frontend as jfrontend
from signaltrain_tpu.ops import pallas_frontend as pf
from signaltrain_tpu.training import checkpoint as jcheckpoint
from signaltrain_tpu.training import loss as jloss
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models import autoencoder, st_model
from signaltrain_tpu_torch.ops import _cuda, cuda_frontend, frontend
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.torch_port_util import (BWD_GEOMS, BWD_IDS, analysis_bwd_inputs,
                                   assert_analysis_close, jax_params, model_inputs, n,
                                   regular_phase_cotangent, synthesis_bwd_inputs, t, tiny_spec)

BF16 = torch.bfloat16
GEOMS = pytest.mark.parametrize("ft,hop,chunk,b", BWD_GEOMS, ids=BWD_IDS)


def _gap_at_least(bf16, f32, tol):
    """The JAX package's bf16-versus-float32 gap is >= 10x the tolerance."""
    gap = float(np.abs(np.asarray(bf16, np.float64) - np.asarray(f32, np.float64)).max())
    assert gap >= 10 * tol, (gap, tol)


def _float64_rule(got, want_jax, exact, name):
    """The port's error against the float64 result at most twice JAX's plus
    1e-3 * max|g| of the leaf."""
    exact = n(exact).astype(np.float64)
    err = float(np.abs(n(got).astype(np.float64) - exact).max())
    jax_err = float(np.abs(np.asarray(want_jax, np.float64) - exact).max())
    assert err <= 2 * jax_err + 1e-3 * float(np.abs(exact).max()), (name, err, jax_err)


def _tensor(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------- kernel A, B

@GEOMS
def test_analysis_bf16_matches_jax_pallas(ft, hop, chunk, b):
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    half = ft // 2 + 1
    xp = np.pad(inp["x"], ((0, 0), (ft, ft)))
    w = pf.stack_analysis_weights(jnp.asarray(inp["wr"]), jnp.asarray(inp["wi"]), half)
    jmag, jphs = pf.fused_analysis(jnp.asarray(xp), w, ft, hop, half, jnp.bfloat16, True)
    jmag32, _ = pf.fused_analysis(jnp.asarray(xp), w, ft, hop, half, jnp.float32, True)
    _cuda.reset_counts()
    mag, phs = cuda_frontend.fused_analysis(
        t(xp), cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half), ft, hop,
        BF16)
    assert cuda_frontend.ANALYSIS_BF16.plain_calls == 1 and cuda_frontend.ANALYSIS.plain_calls == 0
    assert mag.dtype == phs.dtype == torch.float32
    assert_analysis_close(mag, phs, jmag, jphs)
    _gap_at_least(jmag, jmag32, 2e-5)


@GEOMS
def test_synthesis_bf16_matches_jax_pallas(ft, hop, chunk, b):
    inp = synthesis_bwd_inputs(ft, hop, b)
    half = ft // 2 + 1
    wr_eff, wi_eff = jfrontend.fold_synthesis_weights(jnp.asarray(inp["wr"]),
                                                      jnp.asarray(inp["wi"]), half)
    w = pf.stack_synthesis_weights(wr_eff, wi_eff, half)
    args = (jnp.asarray(inp["mag"]), jnp.asarray(inp["phs"]), w, ft, hop, half)
    want = pf.fused_synthesis(*args, jnp.bfloat16, True)
    want32 = pf.fused_synthesis(*args, jnp.float32, True)
    _cuda.reset_counts()
    pw = cuda_frontend.stack_synthesis_weights(
        *frontend.fold_synthesis_weights(t(inp["wr"]), t(inp["wi"]), half))
    got = cuda_frontend.fused_synthesis(t(inp["mag"]), t(inp["phs"]), pw, ft, hop, BF16)
    assert cuda_frontend.SYNTHESIS_BF16.plain_calls == 1
    assert cuda_frontend.SYNTHESIS.plain_calls == 0
    np.testing.assert_allclose(n(got), np.asarray(want), atol=3e-4, rtol=3e-4)
    _gap_at_least(want, want32, 3e-4)


# ---------------------------------------------------------------- kernel D, E

def _analysis_grads(inp, ft, hop, dtype):
    """Gradients of sum(mag*a) + sum(phs*c) w.r.t. (x, w_real, w_imag)
    through the port's bf16 fused_analysis, on tensors of ``dtype``."""
    half = ft // 2 + 1
    x, wr, wi = (_tensor(inp[k], dtype).requires_grad_() for k in ("x", "wr", "wi"))
    xp = torch.nn.functional.pad(x, (ft, ft))
    mag, phs = cuda_frontend.fused_analysis(
        xp, cuda_frontend.stack_analysis_weights(wr, wi, half), ft, hop, BF16)
    loss = (mag * _tensor(inp["a"], dtype)).sum() + (phs * _tensor(inp["c"], dtype)).sum()
    return torch.autograd.grad(loss, (x, wr, wi))


@pytest.mark.parametrize("cot", ["full", "regular"])
@GEOMS
def test_analysis_bf16_grads_match_jax_pallas(ft, hop, chunk, b, cot):
    inp = analysis_bwd_inputs(ft, hop, chunk, b)
    if cot == "regular":
        inp["c"] = regular_phase_cotangent(inp, ft, hop)
    half = ft // 2 + 1
    a, c = jnp.asarray(inp["a"]), jnp.asarray(inp["c"])

    def loss(x, wr, wi):
        w = pf.stack_analysis_weights(wr, wi, half)
        xp = jnp.pad(x, ((0, 0), (ft, ft)))
        mag, phs = pf.fused_analysis(xp, w, ft, hop, half, jnp.bfloat16, True)
        return jnp.sum(mag * a) + jnp.sum(phs * c)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(inp[k]) for k in ("x", "wr", "wi")))
    _cuda.reset_counts()
    got = _analysis_grads(inp, ft, hop, torch.float32)
    assert cuda_frontend.ANALYSIS_BWD_BF16.plain_calls == 1
    assert cuda_frontend.ANALYSIS_BWD.plain_calls == 0
    exact = _analysis_grads(inp, ft, hop, torch.float64)
    for g, w_, x_, name in zip(got, want, exact, ("dx", "dwr", "dwi")):
        assert g.dtype == torch.float32
        _float64_rule(g, w_, x_, name)
    assert np.all(n(got[1])[half:] == 0) and np.all(n(got[2])[half:] == 0)


def _synthesis_grads(inp, ft, hop, dtype):
    half = ft // 2 + 1
    mag, phs, wr, wi = (_tensor(inp[k], dtype).requires_grad_()
                        for k in ("mag", "phs", "wr", "wi"))
    w = cuda_frontend.stack_synthesis_weights(*frontend.fold_synthesis_weights(wr, wi, half))
    wave = cuda_frontend.fused_synthesis(mag, phs, w, ft, hop, BF16)
    return torch.autograd.grad((wave * _tensor(inp["a"], dtype)).sum(), (mag, phs, wr, wi))


@GEOMS
def test_synthesis_bf16_grads_match_jax_pallas(ft, hop, chunk, b):
    inp = synthesis_bwd_inputs(ft, hop, b)
    half = ft // 2 + 1
    a = jnp.asarray(inp["a"])

    def loss(mag, phs, wr, wi):
        wr_eff, wi_eff = jfrontend.fold_synthesis_weights(wr, wi, half)
        w = pf.stack_synthesis_weights(wr_eff, wi_eff, half)
        return jnp.sum(pf.fused_synthesis(mag, phs, w, ft, hop, half, jnp.bfloat16, True) * a)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(inp[k]) for k in ("mag", "phs", "wr", "wi")))
    _cuda.reset_counts()
    got = _synthesis_grads(inp, ft, hop, torch.float32)
    assert cuda_frontend.SYNTHESIS_BWD_BF16.plain_calls == 1
    assert cuda_frontend.SYNTHESIS_BWD.plain_calls == 0
    exact = _synthesis_grads(inp, ft, hop, torch.float64)
    for g, w_, x_, name in zip(got, want, exact, ("dmag", "dphs", "dwr", "dwi")):
        _float64_rule(g, w_, x_, name)
    for g in got[:2]:  # the first and last frame lie wholly in the trimmed margin
        assert np.all(n(g)[0] == 0) and np.all(n(g)[-1] == 0)


# ------------------------------------------------------- the gemm front-end

@pytest.mark.parametrize("shape", [(3, 7, 64), (5, 66)])
def test_bf16_gemm_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=(shape[-1], 33)).astype(np.float32)
    g = rng.normal(size=shape[:-1] + (33,)).astype(np.float32)
    want, vjp = jax.vjp(lambda x, y: jfrontend._gemm(x, y, jnp.bfloat16), jnp.asarray(a),
                        jnp.asarray(b))
    want_da, want_db = vjp(jnp.asarray(g))
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    got = frontend.gemm(ta, tb, BF16)
    da, db = torch.autograd.grad((got * t(g)).sum(), (ta, tb))
    assert got.dtype == da.dtype == db.dtype == torch.float32
    for x, y, name in ((got, want, "out"), (da, want_da, "da"), (db, want_db, "db")):
        np.testing.assert_allclose(n(x), np.asarray(y), atol=1e-5, rtol=1e-5, err_msg=name)
    _gap_at_least(want, jfrontend._gemm(jnp.asarray(a), jnp.asarray(b), jnp.float32), 1e-5)
    # float32 stays plain matmul, numbers unchanged
    assert torch.equal(frontend.gemm(t(a), t(b), torch.float32), t(a) @ t(b))
    with pytest.raises(TypeError):
        frontend.gemm(t(a), t(b), torch.float16)


# ------------------------------------------------------------ the autoencoder

@pytest.mark.parametrize("skip", ["res", "sf", ""])
def test_bf16_autoencoder_both_layouts_match_jax(skip):
    rng = np.random.default_rng(6)
    b, tf, f, k, ot = 2, 25, 7, 4, 9
    x = rng.normal(size=(b, tf, f)).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=(b, k)).astype(np.float32)
    jmod = jae.AsymAutoEncoder(time_frames=tf, n_knobs=k, output_frames=ot,
                               compute_dtype=jnp.bfloat16)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(knobs)))
    for node in params["params"].values():  # non-zero biases: the two roundings show
        node["bias"] = (rng.normal(size=node["bias"].shape) * 0.1).astype(np.float32)
    want, _ = jmod.apply(params, jnp.asarray(x), jnp.asarray(knobs), skip_connections=skip)
    want32, _ = jae.AsymAutoEncoder(time_frames=tf, n_knobs=k, output_frames=ot).apply(
        params, jnp.asarray(x), jnp.asarray(knobs), skip_connections=skip)
    ae = autoencoder.AsymAutoEncoder(tf, 64, k, ot, device="cpu", compute_dtype=BF16)
    ae.load_state_dict({f"{name}.{p}": t(np.asarray(node["kernel"]).T if p == "weight"
                                         else node["bias"])
                        for name, node in params["params"].items() for p in ("weight", "bias")},
                       strict=True)
    assert all(p.dtype == torch.float32 for p in ae.parameters())
    with torch.no_grad():
        got = ae(t(x), t(knobs), skip_connections=skip)
        got_fm = ae.frame_major(t(x).transpose(0, 1).contiguous(), t(knobs), skip_connections=skip)
    # the skip tail stays float32: 'res' and 'sf' promote, '' stays bf16 as in JAX
    assert got.dtype == (BF16 if skip == "" else torch.float32)
    assert str(np.asarray(want).dtype) == ("bfloat16" if skip == "" else "float32")
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got.float()), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(n(got_fm.transpose(0, 1).float()), want, atol=1e-5, rtol=1e-5)
    _gap_at_least(want, want32, 1e-5)


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("which", ["tiny", "flagship"])
@pytest.mark.parametrize("frontend_", ["gemm", "fused"])
def test_bf16_model_matches_jax(which, frontend_):
    spec = tiny_spec() if which == "tiny" else jst.compute_spec()
    _, params = jax_params(spec, seed=1)
    x, knobs = model_inputs(spec, 3 if which == "tiny" else 2, seed=2)
    jfe = "xla" if frontend_ == "gemm" else "pallas"
    outs = {}
    for dt in (jnp.bfloat16, jnp.float32):
        mod = jst.STModel(spec, compute_dtype=dt).module.clone(frontend=jfe)
        outs[dt] = mod.apply(params, jnp.asarray(x), jnp.asarray(knobs))
    model = st_model.STModel(st_model.ModelSpec(**dataclasses.asdict(spec)), frontend=frontend_,
                             device="cpu", compute_dtype=BF16)
    model.load_state_dict(checkpoint.params_to_state_dict(params), strict=True)
    _cuda.reset_counts()
    with torch.no_grad():
        y, mag, mag_hat = model(t(x), t(knobs))
    ran = {k: c.plain_calls for k, c in _cuda.COUNTERS.items() if c.plain_calls}
    assert ran == ({"bf16_fused_analysis": 1, "bf16_fused_synthesis": 1}
                   if frontend_ == "fused" else {}), ran
    jy, jmag, jmag_hat = outs[jnp.bfloat16]
    assert y.dtype == mag.dtype == mag_hat.dtype == torch.float32
    np.testing.assert_allclose(n(y), np.asarray(jy), atol=5e-5, rtol=0)
    np.testing.assert_allclose(n(mag), np.asarray(jmag), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(n(mag_hat), np.asarray(jmag_hat), atol=2e-4, rtol=2e-4)
    _gap_at_least(jy, outs[jnp.float32][0], 5e-5)


def _jax_loss_fn(jm):
    module = jm.module.clone(frontend="pallas")
    scale = jloss.freq_scale(jm.spec.ft_size // 2 + 1)

    def loss_fn(p, x, y, knobs):
        y_hat, _, mag_hat = module.apply(p, x, knobs)
        return jloss.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale)

    return loss_fn


@pytest.mark.parametrize("frontend_", ["fused", "gemm"])
def test_bf16_train_step_matches_jax(frontend_):
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=6, compute_dtype=jnp.bfloat16)
    cfg = dict(lr_max=2e-4, n_data_points=40, epochs=1, batch_size=8)
    x, knobs = model_inputs(spec, 8, seed=10)
    y = (np.random.default_rng(110).normal(size=(8, spec.out_chunk_size)) * 0.3).astype(np.float32)
    batch = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(knobs))
    before = checkpoint.params_to_state_dict(jax.device_get(params))
    jgrads = checkpoint.params_to_state_dict(jax.device_get(
        jtrain.clip_frontend_grads(jax.grad(_jax_loss_fn(jm))(params, *batch), 1.0)))
    tx, _ = jtrain.make_optimizer(**cfg)
    jp, _, jl = jtrain.make_train_step_from_arrays(jm, tx, frontend="pallas")(
        params, tx.init(params), *batch)  # donates params
    after = checkpoint.params_to_state_dict(jax.device_get(jp))

    model = st_model.STModel(st_model.ModelSpec(**dataclasses.asdict(spec)), frontend=frontend_,
                             device="cpu", compute_dtype=BF16)
    model.load_state_dict(before, strict=True)
    model.train()
    opt, lr_fn = train_mod.make_optimizer(model, **cfg)
    _cuda.reset_counts()
    l = train_mod.train_step_from_arrays(model, opt, lr_fn, 0, t(x), t(y), t(knobs))
    if frontend_ == "fused":
        for c in ("fused_analysis", "fused_synthesis", "fused_analysis_bwd", "fused_synthesis_bwd"):
            assert _cuda.COUNTERS["bf16_" + c].plain_calls == 1, c
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    lr = lr_fn(0)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and opt.state[p]["exp_avg"].dtype == torch.float32
        moved, want_moved = n(p) - n(before[name]), n(after[name]) - n(before[name])
        g = np.abs(n(jgrads[name]))
        sure = (g >= 0.02 * g.max()) & (g >= 1000 * 1e-8)  # sign(g) certain, eps negligible
        np.testing.assert_allclose(moved[sure], want_moved[sure], atol=2e-7, err_msg=name)
        assert np.abs(moved - want_moved).max() <= 2 * lr + 2e-7, name
        assert np.abs(moved).max() <= lr + 2e-7, name


# --------------------------------------------------- train(), run_train, load

def test_train_bf16_checkpoint_round_trip(tmp_path, monkeypatch, capsys):
    """train() in bf16 (its default) leaves float32 parameters and optimizer
    state; its checkpoint reloads bit for bit in both packages and serves in
    bf16 through load_model(compute_dtype=) and predict_long."""
    monkeypatch.chdir(tmp_path)
    effect = effects.Compressor_4c(device="cpu")
    model, hist = train_mod.train(effect, epochs=1, n_data_points=16, batch_size=8, lr_max=1e-3,
                                  scale_factor=512 / 8192.0, device="cpu", make_plots=False)
    assert "compute_dtype = bfloat16" in capsys.readouterr().out
    assert model.compute_dtype == BF16 and np.all(np.isfinite(hist["train_loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    served, rv = load_model("modelcheckpoint.tar", device="cpu", compute_dtype=BF16)
    assert served.compute_dtype == BF16 and rv["optax_step"] == 2
    for a, b in zip(served.state_dict().values(), model.state_dict().values()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    jparams, _ = jcheckpoint.load_checkpoint("modelcheckpoint.tar")
    want = checkpoint.params_to_state_dict(jparams)
    for name, p in model.named_parameters():
        assert torch.equal(want[name], p.detach()), name
    clip = np.random.default_rng(0).normal(size=2000).astype(np.float32) * 0.3
    y = pl.predict_long(clip, np.zeros(4, np.float32), served)
    assert y.shape == (len(clip) - (512 - 128),) and np.all(np.isfinite(y))
    assert load_model("modelcheckpoint.tar", device="cpu")[0].compute_dtype == torch.float32


def test_run_train_bf16_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--epochs", "1", "-n", "16", "-b", "8", "--scale", "0.0625", "--device", "cpu"]
    run_train.main(argv + ["--dtype", "bfloat16"])
    out = capsys.readouterr().out
    assert "compute_dtype = bfloat16" in out and "Execution completed" in out
    first = load_model("modelcheckpoint.tar", device="cpu", compute_dtype=BF16)[0]
    os.rename("modelcheckpoint.tar", "bf16.tar")
    run_train.main(argv)  # the default is bfloat16, as the JAX CLI's
    assert "compute_dtype = bfloat16" in capsys.readouterr().out
    run_train.main(argv + ["--dtype", "f32", "--checkpoint", "f32.tar"])
    assert "compute_dtype = float32" in capsys.readouterr().out
    # the same seed and data: the bf16 and float32 runs differ, the two bf16 runs do not
    bf16_again = load_model("modelcheckpoint.tar", device="cpu")[0].state_dict()
    f32 = load_model("f32.tar", device="cpu")[0].state_dict()
    for name, p in first.state_dict().items():
        assert torch.equal(p, bf16_again[name]), name
    assert any(not torch.equal(p, f32[name]) for name, p in first.state_dict().items())
