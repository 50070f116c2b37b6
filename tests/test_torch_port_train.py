"""The port's training step (signaltrain_tpu_torch.training) against the JAX package.

loss / clip: rtol 1e-6 against signaltrain_tpu.training.{loss, train}.
schedule: rtol 1e-4 (the JAX side takes its cosine in float32). Adam: 5 steps
on a fixed sequence of gradients against optax.adam under the same 1cycle
schedule, rtol 1e-5 (tests/test_training.py:271) with atol 1e-8: optax takes
the bias correction 1 - b2**t in float32, where it carries 1.3e-5 relative
error at t = 1, so each ~1e-5 update differs by ~1e-9 and a weight near zero
cannot meet a relative bound. The train step as a
whole: the same parameters (carried across) and the same numpy (x, y, knobs)
through the port's ``frontend="fused"`` (plain versions of A, B, D, E on the
CPU) and ``"gemm"``, against jax.value_and_grad of the loss of
``make_train_step_from_arrays`` with ``frontend="pallas"`` (interpret mode),
float32: loss rtol 1e-5, every gradient within 1e-3 * max|g| of its own leaf
with no absolute floor (the leaves' largest gradients run from 2e-5 to 3e-2,
their medians from 3e-6 to 2e-2; the measured difference is <= 5e-6 * max|g|
on every leaf); then 5 train steps of both, per-step loss rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from signaltrain_tpu.training import loss as jloss
from signaltrain_tpu.training import schedule as jschedule
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch.ops import _cuda
from signaltrain_tpu_torch.training import checkpoint, loss, schedule
from signaltrain_tpu_torch.training import train as train_mod
from tests.torch_port_util import (assert_dw_close, jax_params, model_inputs, n, port_model, t,
                                   tiny_spec)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(3, 128)).astype(np.float32)
    y_hat = (y + rng.normal(size=y.shape) * np.array([[1e-3], [0.3], [40.0]])).astype(np.float32)
    mag_hat = np.abs(rng.normal(size=(9, 3, 33))).astype(np.float32)  # frame-major
    for name in ("logcosh", "mse", "mae"):
        got = getattr(loss, name)(t(y_hat), t(y))
        want = getattr(jloss, name)(jnp.asarray(y_hat), jnp.asarray(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(n(loss.freq_scale(33)), np.asarray(jloss.freq_scale(33)), rtol=1e-6)
    for scale in (None, 33):
        got = loss.calc_loss(t(y_hat), t(y), t(mag_hat),
                             None if scale is None else loss.freq_scale(scale))
        want = jloss.calc_loss(jnp.asarray(y_hat), jnp.asarray(y), jnp.asarray(mag_hat),
                               None if scale is None else jloss.freq_scale(scale))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # batch-major mag_hat weighs the same last axis
    got_bm = loss.calc_loss(t(y_hat), t(y), t(mag_hat).transpose(0, 1), loss.freq_scale(33))
    np.testing.assert_allclose(float(got_bm), float(got), rtol=1e-6)


@pytest.mark.parametrize("cfg", [dict(lr_max=1e-3, n_data_points=8000, epochs=2, batch_size=40),
                                 dict(lr_max=2e-4, n_data_points=80, epochs=3, batch_size=8),
                                 dict(lr_max=1e-4, n_data_points=4000, epochs=3, batch_size=200)])
def test_schedule_matches_jax(cfg):
    lrs, moms = schedule.one_cycle_lut(**cfg)
    jlrs, jmoms = jschedule.one_cycle_lut(**cfg)
    np.testing.assert_array_equal(lrs, jlrs)
    np.testing.assert_array_equal(moms, jmoms)
    lr_fn, jlr_fn = schedule.one_cycle_fn(**cfg), jschedule.one_cycle_fn(**cfg)
    mcfg = {k: v for k, v in cfg.items() if k != "lr_max"}
    mom_fn, jmom_fn = schedule.momentum_fn(**mcfg), jschedule.momentum_fn(**mcfg)
    n_iter = len(lrs)
    for step in [0, 1, n_iter // 3, int(n_iter * 0.3) - 1, int(n_iter * 0.3), n_iter - 1,
                 n_iter + 5]:
        assert isinstance(lr_fn(step), float)
        np.testing.assert_allclose(lr_fn(step), float(jlr_fn(step)), rtol=1e-4)
        np.testing.assert_allclose(lr_fn(step), lrs[min(step, n_iter - 1)], rtol=1e-4)
        np.testing.assert_allclose(mom_fn(step), float(jmom_fn(step)), rtol=1e-4)


@pytest.mark.parametrize("scale", [1e-4, 3.0], ids=["below_norm", "clipped"])
def test_clip_frontend_grads_matches_jax(scale):
    spec = tiny_spec()
    _, params = jax_params(spec, seed=0)
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * scale), params)
    want = jtrain.clip_frontend_grads(grads, 1.0)
    model = port_model(spec, params, "fused")
    gsd = checkpoint.params_to_state_dict(jax.device_get(grads))
    for name, p in model.named_parameters():
        p.grad = gsd[name].clone()
    total = train_mod.clip_frontend_grads(model, 1.0)
    want_sd = checkpoint.params_to_state_dict(jax.device_get(want))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p.grad), n(want_sd[name]), rtol=1e-6, err_msg=name)
    fe = sum(float(np.abs(n(gsd[k])).sum()) for k in train_mod.FRONTEND_PARAMS)
    np.testing.assert_allclose(float(total), fe, rtol=1e-5)


def test_adam_matches_optax_under_one_cycle():
    spec = tiny_spec()
    _, params = jax_params(spec, seed=2)
    cfg = dict(lr_max=2e-4, n_data_points=80, epochs=1, batch_size=8)
    tx = optax.adam(learning_rate=jschedule.one_cycle_fn(**cfg), b1=0.9, b2=0.999, eps=1e-8)
    opt_state = tx.init(params)
    model = port_model(spec, params, "fused")
    opt, lr_fn = train_mod.make_optimizer(model, **cfg)
    rng = np.random.default_rng(3)
    jp = params
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), jp)
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        gsd = checkpoint.params_to_state_dict(jax.device_get(grads))
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        for group in opt.param_groups:
            group["lr"] = lr_fn(step)
        opt.step()
    want = checkpoint.params_to_state_dict(jax.device_get(jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p), n(want[name]), rtol=1e-5, atol=1e-8, err_msg=name)


def _jax_loss_fn(jm, frontend="pallas"):
    module = jm.module.clone(frontend=frontend)
    scale = jloss.freq_scale(jm.spec.ft_size // 2 + 1)

    def loss_fn(p, x, y, knobs):
        y_hat, _, mag_hat = module.apply(p, x, knobs)
        return jloss.calc_loss(y_hat, y, mag_hat, scale_by_freq=scale)

    return loss_fn


def _batch(spec, b, seed):
    x, knobs = model_inputs(spec, b, seed)
    y = (np.random.default_rng(seed + 100).normal(size=(b, spec.out_chunk_size)) * 0.3)
    return x, y.astype(np.float32), knobs


@pytest.mark.parametrize("frontend", ["fused", "gemm"])
def test_loss_and_grads_match_jax_pallas(frontend):
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=4)
    x, y, knobs = _batch(spec, 5, seed=5)
    jl, jg = jax.value_and_grad(_jax_loss_fn(jm))(params, jnp.asarray(x), jnp.asarray(y),
                                                  jnp.asarray(knobs))
    model = port_model(spec, params, frontend).train()
    _cuda.reset_counts()
    l = train_mod.loss_and_grads(model, t(x), t(y), t(knobs))
    # the four float32 kernels (their mma.sync schedules' counters, "..._mma",
    # count launches on the card only)
    ran = {k: c.plain_calls for k, c in _cuda.COUNTERS.items()
           if k.startswith("fused_") and not k.endswith("_mma")}
    want_calls = 1 if frontend == "fused" else 0
    assert set(ran.values()) == {want_calls} and len(ran) == 4, ran
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    want = checkpoint.params_to_state_dict(jax.device_get(jg))
    for name, p in model.named_parameters():
        assert_dw_close(n(p.grad), n(want[name]), name)


@pytest.mark.parametrize("frontend", ["fused", "gemm"])
def test_five_train_steps_match_jax(frontend):
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=6)
    cfg = dict(lr_max=2e-4, n_data_points=40, epochs=1, batch_size=8)
    tx, _ = jtrain.make_optimizer(**cfg)
    jstep = jtrain.make_train_step_from_arrays(jm, tx, frontend="pallas")
    model = port_model(spec, params, frontend).train()
    opt, lr_fn = train_mod.make_optimizer(model, **cfg)
    jp, jopt = params, tx.init(params)
    for step in range(5):
        x, y, knobs = _batch(spec, 8, seed=10 + step)
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(knobs))
        l = train_mod.train_step_from_arrays(model, opt, lr_fn, step, t(x), t(y), t(knobs))
        np.testing.assert_allclose(float(l), float(jl), rtol=1e-4, err_msg=f"step {step}")
    # the parameters moved together: lr is O(1e-5), so 5 Adam steps move a
    # weight by <= ~1e-4; held to a tenth of that
    want = checkpoint.params_to_state_dict(jax.device_get(jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p), n(want[name]), atol=1e-5, err_msg=name)


def test_eval_step_matches_jax():
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=7)
    x, y, knobs = _batch(spec, 4, seed=8)
    jl, jmae, _ = jtrain.make_eval_step_from_arrays(jm)(params, jnp.asarray(x), jnp.asarray(y),
                                                        jnp.asarray(knobs))
    model = port_model(spec, params, "fused")
    l, m, (_, _, _, y_hat, mag, mag_hat) = train_mod.eval_step_from_arrays(
        model, t(x), t(y), t(knobs))
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m), float(jmae), rtol=1e-5)
    assert y_hat.shape == (4, spec.out_chunk_size) and not y_hat.requires_grad
    assert mag.shape == (spec.time_frames, 4, 33) and mag_hat.shape == (9, 4, 33)
