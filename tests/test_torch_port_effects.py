"""The port's synthesized effects and their DSP (dsp/iir.py, dsp/compressors.py,
dsp/pitch.py, dsp/effects.py) against the JAX package, on the CPU.

Inputs are seeded numpy arrays handed to both packages; the port runs its
kernels' plain versions. Tolerances are the JAX package's own DSP tests':
butter_lowpass b 1e-6, a 1e-5 (tests/test_dsp.py:22-23); lfilter and
lfilter_zi 1e-5 (:31, :37); the 3-knob compressor 1e-4 (:108); echo 1e-5
(:130); the 4-knob compressor 1e-5 (:66), and 2e-4 for a batch with per-row
knobs (:79) where the release reaches 1 s: XLA's log10 and torch's differ by
an ulp on many samples, and at alpha near 1 such an ulp can flip the
smoother's attack/release choice, whose effect decays over ~1e4 samples. pitch_shift has no JAX test of its own: its phases reach ~2e4 rad
(ft 2048), where a float32 ulp is 2e-3 rad, and its products sum in another
order than XLA's, so it is held to 1e-4 before its last step, the division
by the Hann^2 envelope, which is near 0 at the edges (there the output
reaches hundreds, and its error 1e-2).

Denoise and TimeAlign draw from a generator: their deterministic parts
(``denoise_pair``, ``timealign_pair``) are fed the JAX effect's own draws,
re-derived from its key as tests/test_torch_port_synths.py does, and their
samplers are held to their distributions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from signaltrain_tpu.dsp import compressors as jcomp
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import iir as jiir
from signaltrain_tpu.dsp import pitch as jpitch
from signaltrain_tpu.dsp import synths as jsynths
from signaltrain_tpu.inference import predict_long as jpl
from signaltrain_tpu.utils.load_model import load_model as jload_model
from signaltrain_tpu_torch.cli import predict_long as pl_cli
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.dsp import compressors, effects, iir, pitch, synths
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils.load_model import load_model
from tests.test_torch_port_synths import _jsign, _ju, d_branch, stack
from tests.torch_port_util import EFFECT_TOL, assert_effect_close, n, t

SR = 44100.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENOISE = os.path.join(REPO, "demo", "modelcheckpoint_denoise.tar")


def _jbutter(order, wn):
    return jax.vmap(lambda w: jiir.butter_lowpass(order, w))(jnp.asarray(wn))


# ---- IIR

@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("per_row", [False, True])
def test_butter_lowpass_matches_jax(order, per_row):
    if per_row:  # 10 Hz to 0.7 Nyquist, the LowPass and Compressor cutoffs among them
        wn = np.concatenate([[10 / 22050, 2000 / 22050, 0.7],
                             10 ** np.random.default_rng(order).uniform(-3.4, -0.2, 29)])
        wn = wn.astype(np.float32)
        jb, ja = _jbutter(order, wn)
        b, a = iir.butter_lowpass(order, t(wn))
        assert b.shape == a.shape == (32, order + 1)
    else:
        jb, ja = jiir.butter_lowpass(order, 0.01)
        b, a = iir.butter_lowpass(order, 0.01)
        assert b.shape == a.shape == (order + 1,)
    np.testing.assert_allclose(n(b), np.asarray(jb), atol=1e-6)
    np.testing.assert_allclose(n(a), np.asarray(ja), atol=1e-5)
    assert np.all(n(a)[..., 0] == 1.0)


@pytest.mark.parametrize("order,with_zi,length", [(1, True, 512), (3, False, 2048), (3, True, 1024)])
def test_lfilter_matches_jax(order, with_zi, length):
    rng = np.random.default_rng(order * 10 + length)
    # per-row coefficients down to 10 Hz (poles within 1.5e-3 of z = 1)
    wn = np.array([10 / 22050, 100 / 22050, 0.003, 0.05, 0.2, 0.6], np.float32)
    jb, ja = _jbutter(order, wn)
    x = (rng.normal(size=(6, length)) * 20.0 - 30.0).astype(np.float32)
    zi = rng.normal(size=(6, order)).astype(np.float32) * 5.0 if with_zi else None
    want = jiir.lfilter(jb, ja, jnp.asarray(x), zi=None if zi is None else jnp.asarray(zi))
    before = iir.LFILTER.plain_calls
    got = iir.lfilter(t(jb), t(ja), t(x), None if zi is None else t(zi))
    assert iir.LFILTER.plain_calls == before + 1
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    # one row, shared coefficients, as a 1-D call
    one = iir.lfilter(t(jb[2]), t(ja[2]), t(x[2]), None if zi is None else t(zi[2]))
    np.testing.assert_array_equal(n(one), n(got)[2])


@pytest.mark.parametrize("order", [1, 3])
def test_lfilter_adversarial_rows_match_jax(order):
    """cli/time_lfilter.adversarial_inputs (a steady state, +-0.0, subnormals,
    a response decaying through the subnormals, poles near z = 1, a cutoff
    near Nyquist, +-1 at Nyquist, dB-sized inputs) through the plain version
    against the JAX lfilter at its 1e-5 (relative to the dB-sized row's
    scale there)."""
    from signaltrain_tpu_torch.cli import time_lfilter

    b, a, x, zi = time_lfilter.adversarial_inputs(700, order, torch.device("cpu"))
    want = np.asarray(jiir.lfilter(jnp.asarray(n(b)), jnp.asarray(n(a)), jnp.asarray(n(x)),
                                   zi=jnp.asarray(n(zi))))
    got = n(iir.lfilter(b, a, x, zi))
    scale = np.maximum(1.0, np.abs(want).max(axis=1, keepdims=True))
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    names = [name for name, _ in time_lfilter.ADVERSARIAL]
    np.testing.assert_allclose(got[names.index("steady_state")], 2.0, atol=1e-4)
    decay = np.abs(got[names.index("subnormal_decay")])
    assert np.any((decay > 0) & (decay < np.finfo(np.float32).tiny))


@pytest.mark.parametrize("order,wn", [(1, 0.003), (3, 0.2)])
def test_lfilter_zi_matches_jax(order, wn):
    # (order 3 at low cutoffs makes I - A^T near singular: two float32 solves
    # differ by percent there, so it is held where the system is well posed)
    jb, ja = jiir.butter_lowpass(order, wn)
    got = iir.lfilter_zi(t(jb), t(ja))
    np.testing.assert_allclose(n(got), np.asarray(jiir.lfilter_zi(jb, ja)), atol=1e-5)
    # a step starting from zi * x[0] stays at its steady state
    y = iir.lfilter(t(jb), t(ja), torch.full((200,), 2.0), got * 2.0)
    np.testing.assert_allclose(n(y), 2.0, atol=1e-4)


# ---- compressors

def test_compressor_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 1500)) * 0.4).astype(np.float32)
    want = jcomp.compressor(jnp.asarray(x[0]), -24.0, 2.0, 0.045, SR)
    np.testing.assert_allclose(n(compressors.compressor(t(x[0]), -24.0, 2.0, 0.045, SR)),
                               np.asarray(want), atol=1e-4)
    knobs = [np.array(v, np.float32) for v in ([-30, -12, -3, 0], [1, 2, 3.5, 5],
                                               [1e-3, 5e-3, 0.02, 4e-2])]
    want = jcomp.compressor(jnp.asarray(x), *map(jnp.asarray, knobs), sr=SR)
    got = compressors.compressor(t(x), *map(t, knobs), sr=SR)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


def test_echo_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 2000)).astype(np.float32)
    want = jcomp.echo(jnp.asarray(x[0]), 400.0, 0.6, 2.0, max_echoes=2)
    np.testing.assert_allclose(n(compressors.echo(t(x[0]), 400.0, 0.6, 2.0, max_echoes=2)),
                               np.asarray(want), atol=1e-5)
    # per-row fractional delays, ratios and echo counts, through the gather
    d, r, e = (np.array(v, np.float32) for v in ([400.0, 123.4, 999.7], [0.4, 0.7, 1.0],
                                                 [2.0, 1.0, 3.2]))
    want = jax.vmap(lambda xi, di, ri, ei: jcomp.echo(xi, di, ri, ei, max_echoes=4))(
        *map(jnp.asarray, (x, d, r, e)))
    got = compressors.echo(t(x), t(d), t(r), t(e), max_echoes=4)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


# ---- pitch

@pytest.mark.parametrize("length", [512, 4096])
def test_pitch_shift_matches_jax(length):
    rng = np.random.default_rng(length)
    x = (rng.normal(size=(5, length)) * 0.3).astype(np.float32)
    steps = np.array([-12, 12, -5, 5, 0], np.float32)
    want = np.stack([np.asarray(jpitch.pitch_shift(jnp.asarray(x[i]), SR, jnp.asarray(steps[i])))
                     for i in range(5)])
    got = pitch.pitch_shift(t(x), SR, t(steps))
    assert got.shape == x.shape
    assert_effect_close("pitch", got, want)
    one = pitch.pitch_shift(t(x[3]), SR, 5.0)  # one row, a number of steps
    assert_effect_close("pitch", one[None], want[3:4])
    short = t(x[0, :15])
    assert pitch.pitch_shift(short, SR, 12.0) is short


# ---- synths: the t0_fac override and choose_from

@pytest.mark.parametrize("chooser", [0, 1, 2, 3, 4, 6, 7])  # the branches JAX passes t0_fac to
def test_t0_fac_branches_match_jax(chooser):
    tt = np.arange(512, dtype=np.float32) / np.float32(SR)
    keys = [jax.random.PRNGKey(30 * chooser + i) for i in range(4)]
    fn = jsynths._branch_fn(chooser, jnp.asarray(tt), t0_fac=0.5)
    want = np.stack([np.asarray(fn(k)) for k in keys])
    got = synths.branch(chooser, t(tt), stack([d_branch(chooser, k, 512) for k in keys]), 0.5)
    # the branches that add pinknoise: pinknoise's own 1e-4 (test_torch_port_synths.py)
    np.testing.assert_allclose(n(got), want, atol=1e-4 if chooser in (1, 3, 7) else 1e-5)


def test_choose_from_is_uniform_over_its_set():
    ids = synths.choose_from(torch.Generator().manual_seed(0), (2, 4, 6, 7), 40000)
    assert ids.dtype == torch.int64 and set(ids.tolist()) == {2, 4, 6, 7}
    for c in (2, 4, 6, 7):
        assert abs(float((ids == c).float().mean()) - 0.25) < 0.01


# ---- the effects

DETERMINISTIC = [name for name in effects.EFFECTS if name not in ("denoise", "timealign")]


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_effect_go_batch_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    fx, jfx = effects.make_effect(name, device="cpu"), jeffects.make_effect(name)
    x = (rng.normal(size=(6, 1024)) * 0.3).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=(6, fx.num_knobs)).astype(np.float32)
    knobs[0], knobs[1] = -0.5, 0.5  # the ends of every range
    y, xo = fx.go_batch(x, knobs)
    jy, jx = jfx.go_batch(jnp.asarray(x), jnp.asarray(knobs))
    assert y.shape == xo.shape == x.shape
    assert_effect_close(name, y, np.asarray(jy))
    assert_effect_close(name, xo, np.asarray(jx))
    # go_wc on one row is go_batch on a batch of one
    wc = fx.knobs_wc(knobs[2])
    y1, x1 = fx.go_wc(x[2], wc)
    yb, xb = fx.go_batch(x[2:3], knobs[2:3])
    np.testing.assert_array_equal(n(y1), n(yb)[0])
    np.testing.assert_array_equal(n(x1), n(xb)[0])


def test_decompressor_keeps_the_44100_alpha():
    """DeCompressor_4c does not pass its sr on (as in the JAX package): at
    sr=22050 it compresses as at 44,100 Hz."""
    rng = np.random.default_rng(22050)
    x = (rng.normal(size=(3, 1500)) * 0.4).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=(3, 4)).astype(np.float32)
    fx = effects.DeCompressor_4c(sr=22050, device="cpu")
    target, inp = fx.go_batch(x, knobs)
    jt, ji = jeffects.DeCompressor_4c(sr=22050).go_batch(jnp.asarray(x), jnp.asarray(knobs))
    np.testing.assert_array_equal(n(target), x)
    np.testing.assert_allclose(n(inp), np.asarray(ji), atol=1e-5)
    at_44100, _ = effects.Compressor_4c(sr=44100, device="cpu").go_batch(x, knobs)
    at_22050, _ = effects.Compressor_4c(sr=22050, device="cpu").go_batch(x, knobs)
    np.testing.assert_array_equal(n(inp), n(at_44100))
    assert float((inp - at_22050).abs().max()) > 1e-3


def test_echo_rounds_its_delay_and_caps_its_echoes():
    """Echo rounds the delay knob and masks echoes against
    max_echoes = ceil(knob_ranges[2, 1]), as the JAX effect does."""
    x = np.random.default_rng(5).normal(size=(1, 3000)).astype(np.float32)
    fx, jfx = effects.Echo(device="cpu"), jeffects.Echo()
    for ranges in ([[400.4, 400.4], [0.5, 0.5], [2.6, 2.6]],    # 400 samples, 3 echoes
                   [[250.6, 250.6], [0.9, 0.9], [1.2, 1.2]]):   # 251 samples, 1 of at most 2
        fx.knob_ranges = jfx.knob_ranges = np.array(ranges, np.float32)
        fx._ranges_on.clear()
        y, _ = fx.go_batch(x, np.zeros((1, 3), np.float32))
        jy, _ = jfx.go_batch(jnp.asarray(x), jnp.zeros((1, 3)))
        np.testing.assert_allclose(n(y), np.asarray(jy), atol=1e-5)
        d, ratio = round(ranges[0][0]), ranges[1][0]
        echoes = min(round(ranges[2][0]), int(np.ceil(ranges[2][1])))
        want = x[0].copy()
        for i in range(1, echoes + 1):
            want[i * d:] += ratio ** i * x[0, : -i * d]
        np.testing.assert_allclose(n(y)[0], want, atol=1e-5)
    # an echoes knob past the range's ceiling gives ceil(max) echoes
    fx.knob_ranges = np.array([[400, 400], [0.5, 0.5], [1, 2]], np.float32)
    y, _ = fx.go_wc(x[0], np.array([400.0, 0.5, 5.0], np.float32))
    want = x[0].copy()
    for i in (1, 2):
        want[i * 400:] += 0.5 ** i * x[0, : -i * 400]
    np.testing.assert_allclose(n(y), want, atol=1e-5)


def test_denoise_matches_jax_on_its_draws():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(4, 700)) * 0.3).astype(np.float32)
    knobs = np.array([[-0.5], [-0.1], [0.2], [0.5]], np.float32)
    keys = [jax.random.PRNGKey(60 + i) for i in range(4)]
    jfx = jeffects.Denoise()
    want = [jfx.go(jnp.asarray(x[i]), jnp.asarray(knobs[i]), key=keys[i]) for i in range(4)]
    fx = effects.Denoise(device="cpu")
    u = np.stack([_ju(k, (700,)) for k in keys])
    y, noisy = effects.denoise_pair(t(x), fx.knobs_wc(knobs)[:, 0], t(u))
    np.testing.assert_array_equal(n(y), x)
    np.testing.assert_allclose(n(noisy), np.stack([np.asarray(w[1]) for w in want]), atol=1e-6)
    np.testing.assert_array_equal(n(y), np.stack([np.asarray(w[0]) for w in want]))


def test_denoise_sampler():
    fx = effects.Denoise(device="cpu")
    x = torch.zeros(4, 20000)
    knobs = torch.tensor([[-0.5], [-0.3], [0.0], [0.5]])
    y, noisy = fx.go_batch(x, knobs, torch.Generator().manual_seed(0))
    assert torch.equal(y, x)
    strength = fx.knobs_wc(knobs)[:, 0]  # 0, 0.1, 0.25, 0.5: uniform on [-s, s]
    assert float(noisy[0].abs().max()) == 0.0
    for row in range(1, 4):
        s = float(strength[row])
        assert float(noisy[row].abs().max()) <= s
        assert abs(float(noisy[row].mean())) < 0.01 * s
        assert abs(float(noisy[row].var()) - s * s / 3) < 0.03 * s * s / 3
    with pytest.raises(ValueError):
        fx.go_batch(x, knobs)  # no generator, as JAX raises without a key


def test_timealign_matches_jax_on_its_draws():
    nn = 512
    tt = np.arange(nn, dtype=np.float32) / np.float32(SR)
    jfx, fx = jeffects.TimeAlign(), effects.TimeAlign(device="cpu")
    jgo = jax.jit(lambda xi, ki, key: jfx.go(xi, ki, key=key))  # one compile of the 12-way switch
    knobs = np.array([[-0.5], [0.1], [0.3], [0.5], [0.45], [-0.2], [0.0], [0.25]], np.float32)
    x = np.zeros((8, nn), np.float32)
    want_y, want_x, ids, draws, signs, eps, u_shift = [], [], [], [], [], [], []
    for i in range(8):
        key = jax.random.PRNGKey(68 + i)  # keys whose choosers cover all four
        jy, jx = jgo(jnp.asarray(x[i]), jnp.asarray(knobs[i]), key)
        want_y.append(np.asarray(jy))
        want_x.append(np.asarray(jx))
        k_choose, k_shift, k_synth = jax.random.split(key, 3)
        ids.append(int(jsynths.choose_from(k_choose, effects.TIMEALIGN_CHOOSERS)))
        k_branch, k_finish = jax.random.split(k_synth)
        draws.append({c: d_branch(c, k_branch, nn) for c in effects.TIMEALIGN_CHOOSERS})
        k_sign, k_eps = jax.random.split(k_finish)
        signs.append(_jsign(k_sign))
        eps.append(_ju(k_eps, (nn,)))
        u_shift.append(_ju(k_shift))
    assert set(ids) == set(effects.TIMEALIGN_CHOOSERS)  # the rows cover every branch
    batch_draws = {c: stack([d[c] for d in draws]) for c in effects.TIMEALIGN_CHOOSERS}
    y, x_shift = effects.timealign_pair(t(tt), torch.tensor(ids), batch_draws, t(signs),
                                        t(np.stack(eps)), fx.knobs_wc(knobs)[:, 0], t(u_shift))
    np.testing.assert_allclose(n(y), np.stack(want_y), atol=1e-4)  # chooser 7's pinknoise
    np.testing.assert_allclose(n(x_shift), np.stack(want_x), atol=1e-4)


def test_timealign_sampler():
    fx = effects.TimeAlign(device="cpu")
    nn, b = 2048, 64
    knobs = torch.full((b, 1), 0.5)  # strength 0.5: shifts up to N/2 either way
    y, x_shift = fx.go_batch(torch.zeros(b, nn), knobs, torch.Generator().manual_seed(1))
    assert y.shape == x_shift.shape == (b, nn) and bool(torch.isfinite(y).all())
    shifts = []
    for row in range(b):  # x_shift is y moved by a whole number of samples, zero-filled
        for s in range(-nn // 2, nn // 2 + 1):
            lo, hi = max(0, s), min(nn, nn + s)
            if torch.equal(x_shift[row, lo:hi], y[row, lo - s : hi - s]) and bool(
                    (x_shift[row, :lo] == 0).all()) and bool((x_shift[row, hi:] == 0).all()):
                shifts.append(s)
                break
        else:
            raise AssertionError(f"row {row}: no shift explains x_shift")
    assert min(shifts) < -nn // 8 and max(shifts) > nn // 8  # both ways, far
    with pytest.raises(ValueError):
        fx.go_batch(torch.zeros(2, nn), knobs[:2])


def test_lowpass_keeps_the_jax_float32_design():
    """The JAX package designs the LowPass in float32, which at its lowest
    cutoffs rounds the third-order denominator onto the unit circle (scipy's
    float64 design keeps its poles inside): the target of a 30 Hz row grows
    far past its input. The port keeps the JAX design bit for bit."""
    wn = np.array([10 / 22050, 30 / 22050], np.float32)
    jb, ja = _jbutter(3, wn)
    b, a = iir.butter_lowpass(3, t(wn))
    np.testing.assert_array_equal(n(b), np.asarray(jb))
    np.testing.assert_array_equal(n(a), np.asarray(ja))
    assert np.abs(np.roots(np.asarray(ja[0], np.float64))).max() > 0.99999
    import scipy.signal as ss

    assert np.abs(np.roots(ss.butter(3, float(wn[0]))[1])).max() < 0.9995
    # a 29.9 Hz row: the target runs away in both packages. Their values
    # part there: one ulp of tan (XLA's float32 tan and torch's differ on a
    # few arguments) moves such a marginal pole enough.
    x = (np.random.default_rng(0).normal(size=(1, 8192)) * 0.3).astype(np.float32)
    knob = np.array([[-0.49]], np.float32)
    y, _ = effects.LowPass(device="cpu").go_batch(x, knob)
    jy, _ = jeffects.LowPass().go_batch(jnp.asarray(x), jnp.asarray(knob))
    assert np.abs(n(y)).max() > 10 * np.abs(x).max()
    assert np.abs(np.asarray(jy)).max() > 10 * np.abs(x).max()


# ---- training every effect, one eager step at the tiny geometry

@pytest.mark.parametrize("name", list(effects.EFFECTS))
def test_one_train_step_per_effect(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fx = effects.make_effect(name, device="cpu")
    model, hist = train_mod.train(fx, epochs=1, n_data_points=8, batch_size=8,
                                  scale_factor=512 / 8192.0, device="cpu",
                                  compute_dtype=torch.float32, make_plots=False)
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"][0]), name
    assert np.isfinite(hist["val_mae_mean"][0])
    _, rv = load_model("modelcheckpoint.tar", device="cpu")
    assert rv["effect_name"] == fx.name and list(rv["knob_names"]) == fx.knob_names
    np.testing.assert_array_equal(np.asarray(rv["knob_ranges"]), fx.knob_ranges)


# ---- the CLIs

def test_run_train_target_apex_and_denoise(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tiny = ["--epochs", "1", "-n", "16", "-b", "8", "--scale", "0.0625", "--device", "cpu"]
    for target in ("chunk", "stream"):
        run_train.main(tiny + ["-t", target, "--apex", "O1", "--out-checkpoint", f"{target}.tar"])
        assert os.path.exists(f"{target}.tar")
        assert "Execution completed" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        run_train.main(["-t", "bad", "--device", "cpu"])
    assert e.value.code == 1 and "invalid target type: bad" in capsys.readouterr().out
    run_train.main(tiny + ["--effect", "denoise", "--out-checkpoint", "denoise.tar"])
    _, rv = load_model("denoise.tar", device="cpu")
    assert rv["effect_name"] == "Denoise" and list(rv["knob_names"]) == ["strength"]


def test_predict_long_cli_targets_only_the_comp_effects(tmp_path, monkeypatch):
    clip = synths.music_like_clip(0.5, seed=3)[: 8192 + 2 * 2048]
    wav = str(tmp_path / "clip.wav")
    wavfile.write(wav, 44100, clip)
    monkeypatch.chdir(tmp_path)
    pl_cli.main([DENOISE, wav, "-e", "denoise", "--knobs=0.25", "--device", "cpu"])
    assert (tmp_path / "pl_pred__0.25.wav").exists()
    assert not list(tmp_path.glob("pl_st*")) and not list(tmp_path.glob("pl_ct*"))
    demo = os.path.join(REPO, "demo", "model_comp4c_demo.tar")
    pl_cli.main([demo, wav, "-e", "decomp_4c", "--knobs=-25,4,0.005,0.02", "--device", "cpu"])
    tag = "__-25.0__4.0__0.005__0.02"
    _, st = wavfile.read(str(tmp_path / f"pl_st{tag}.wav"))
    assert (tmp_path / f"pl_ct{tag}.wav").exists()
    np.testing.assert_array_equal(st, clip)  # the inverse effect's target is its input


# ---- the shipped Denoise checkpoint

def test_denoise_checkpoint_loads_and_serves_as_jax_does():
    model, rv = load_model(DENOISE, device="cpu")  # strict inside
    assert rv["knob_names"] == ["strength"] and model.spec.num_knobs == 1
    assert (model.spec.in_chunk_size, model.spec.out_chunk_size) == (8192, 2048)
    assert sum(p.numel() for p in model.parameters()) == 4_210_994
    jm, jparams, _ = jload_model(DENOISE, compute_dtype=jnp.float32)
    clean = synths.music_like_clip(1.0, seed=0)[: 8192 + 4 * 2048 + 300]
    noisy = (clean + 0.25 * (2.0 * np.random.RandomState(0).rand(len(clean)) - 1.0)).astype(
        np.float32)
    knobs = np.array([0.25 / 0.5 - 0.5], np.float32)
    want = jpl.predict_long(noisy, knobs, jm, jparams)
    got = pl.predict_long(noisy, knobs, model)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)
    lookback = 8192 - 2048
    err = np.abs(got - clean[lookback : lookback + len(got)]).mean()
    assert err < 0.3 * np.abs(noisy - clean)[lookback : lookback + len(got)].mean()
