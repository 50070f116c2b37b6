"""The port's synthetic data (dsp/synths.py, data/synth_data.py) against the JAX package.

torch and jax.random give different numbers from one seed, so every
generator's deterministic part is fed the JAX function's own draws (re-derived
here with the same jax.random.split calls) and compared with the JAX function:
atol 1e-5; branches that add pinknoise 1e-4, as pinknoise itself against the
JAX cosine-matrix product at Precision.HIGHEST (an FFT sums in another
order). The samplers are held to
their distributions: ranges, moments, exact per-batch chooser counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.data import synth_data as jsynth_data
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import synths as jsynths
from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import effects, synths
from tests.torch_port_util import n, t

SR = 44100.0
N = 512


def _ju(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape), np.float32)


def _jsign(key):
    return np.float32(np.sign(np.asarray(jax.random.rademacher(key, ()))))


# ---- the draws of each JAX generator, by the same key splits as its body

def d_pink(key, nn):
    return {"u": _ju(key, (nn // 2 + 1,))}


def d_randsine(key, max_tones=2):
    k_n, k_norm, k_tones = jax.random.split(key, 3)
    per = [jax.random.split(jax.random.fold_in(k_n, i), 3) for i in range(max_tones)]
    return {"n_tones": np.int64(jax.random.randint(k_tones, (), 1, max_tones + 1)),
            "amp": np.stack([_ju(p[0]) for p in per]), "freq": np.stack([_ju(p[1]) for p in per]),
            "t0": np.stack([_ju(p[2]) for p in per]), "norm": _ju(k_norm)}


def d_box(key):
    return dict(zip(("bgn", "mid", "end", "up", "dn"), map(_ju, jax.random.split(key, 5))))


def d_expdecay(key):
    return dict(zip(("t0", "high", "low", "decay"), map(_ju, jax.random.split(key, 4))))


def d_pluck(key, max_tones=3):
    k_n, k_env, k_norm, k_tones = jax.random.split(key, 4)
    per = [jax.random.split(jax.random.fold_in(k_n, i), 4) for i in range(max_tones)]
    return {"n_tones": np.int64(jax.random.randint(k_tones, (), 1, max_tones + 1)),
            "amp": np.stack([_ju(p[0]) for p in per]), "sign": np.stack([_jsign(p[1]) for p in per]),
            "t0": np.stack([_ju(p[2]) for p in per]), "freq": np.stack([_ju(p[3]) for p in per]),
            "env": d_expdecay(k_env), "norm": _ju(k_norm)}


def d_step(key):
    k_f, k_norm = jax.random.split(key)
    return {"freq": _ju(k_f), "norm": _ju(k_norm)}


def d_sweep(key):
    k_a, k_norm = jax.random.split(key)
    return {"amp": _ju(k_a), "norm": _ju(k_norm)}


def d_spikes(key, nn):
    k_loc, k_h, k_amp, k_noise = jax.random.split(key, 4)
    return {"loc": _ju(k_loc, (50,)), "height": _ju(k_h, (50,)), "amp": _ju(k_amp),
            "noise": np.asarray(jax.random.normal(k_noise, (nn,)), np.float32)}


def d_triangle(key, nn):
    k_h, k_s, k_w, k_t, k_a, k_p = jax.random.split(key, 6)
    return {"height": _ju(k_h), "sign": _jsign(k_s), "width": _ju(k_w), "t0": _ju(k_t),
            "amp": _ju(k_a), "pink": d_pink(k_p, nn)}


def d_branch(c, key, nn):
    ks = lambda m: jax.random.split(key, m)
    if c == 0:
        return {"sine": d_randsine(key)}
    if c == 1:
        k = ks(5)
        return {"sine": d_randsine(k[0]), "pink_amp": _ju(k[1]), "pink": d_pink(k[2], nn),
                "white_amp": _ju(k[3]), "white": _ju(k[4], (nn,))}
    if c == 2:
        return {"pluck": d_pluck(key)}
    if c == 3:
        return {"triangle": d_triangle(key, nn)}
    if c == 4:
        return {"box": d_box(key)}
    if c == 5:
        return {"spikes": d_spikes(key, nn)}
    if c == 6:
        k = ks(2)
        return {"box": d_box(k[0]), "white": _ju(k[1], (nn,))}
    if c == 7:
        k = ks(3)
        return {"pluck": d_pluck(k[0]), "pink_amp": _ju(k[1]), "pink": d_pink(k[2], nn)}
    if c == 8:
        return {"step": d_step(key)}
    if c == 9:
        k = ks(4)
        return {"f_low": np.int64(jax.random.randint(k[0], (), 20, 1000)),
                "f_high": np.int64(jax.random.randint(k[1], (), 1000, 20000)),
                "amp_too": np.bool_(jax.random.randint(k[2], (), 0, 3) == 2), "sweep": d_sweep(k[3])}
    if c == 10:
        k = ks(5)
        return {"box": d_box(k[0]), "white_amp": _ju(k[1]), "white": _ju(k[2], (nn,)),
                "pink_amp": _ju(k[3]), "pink": d_pink(k[4], nn)}
    k = ks(2)
    return {"pink_amp": _ju(k[0]), "pink": d_pink(k[1], nn)}


def stack(dicts):
    """Per-example draw dicts -> one dict of tensors with a leading batch axis."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: stack([d[k] for d in dicts]) for k in first}
    return torch.from_numpy(np.stack([np.asarray(d) for d in dicts]))


def _spike_keys(count, nn):
    """Keys whose 50 spike locations are distinct (where two spikes share a
    sample, which one stays is unspecified in both packages)."""
    keys, seed = [], 0
    tt = np.arange(nn, dtype=np.float32) / np.float32(SR)
    while len(keys) < count:
        key = jax.random.PRNGKey(1000 + seed)
        seed += 1
        u = d_spikes(key, nn)["loc"]
        loc = np.trunc(np.trunc(u * nn - 2.0) + tt[-1]).astype(np.int64) % nn
        if len(set(loc.tolist())) == 50:
            keys.append(key)
    return keys


TOL = {c: 1e-4 for c in (1, 3, 7, 10, 11)}  # the branches that add pinknoise


@pytest.mark.parametrize("chooser", range(12))
def test_branch_matches_jax_on_its_draws(chooser):
    nn = 8192 if chooser == 5 else N  # spikes: room for 50 distinct locations
    tt = np.arange(nn, dtype=np.float32) / np.float32(SR)
    keys = (_spike_keys(3, nn) if chooser == 5
            else [jax.random.PRNGKey(100 * chooser + i) for i in range(4)])
    fn = jsynths._branch_fn(chooser, jnp.asarray(tt))
    want = np.stack([np.asarray(fn(k)) for k in keys])
    got = synths.branch(chooser, t(tt), stack([d_branch(chooser, k, nn) for k in keys]))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), want, atol=TOL.get(chooser, 1e-5))


def test_pinknoise_matches_jax_cosine_gemm():
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    want = np.stack([np.asarray(jsynths.pinknoise(k, N, precision=jax.lax.Precision.HIGHEST))
                     for k in keys])
    got = synths.pinknoise(N, stack([d_pink(k, N) for k in keys]))
    np.testing.assert_allclose(n(got), want, atol=1e-4)
    np.testing.assert_allclose(np.abs(n(got)).max(axis=1), 1.0, rtol=1e-6)


def test_normish_and_finish_match_jax():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(3, N)).astype(np.float32)
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    want = np.stack([np.asarray(jsynths.normish(k, jnp.asarray(r))) for k, r in zip(keys, y)])
    np.testing.assert_allclose(n(synths.normish(t(y), t([_ju(k) for k in keys]))), want, atol=1e-6)
    signs, eps = [], []
    for k in keys:
        k_sign, k_eps = jax.random.split(k)
        signs.append(_jsign(k_sign))
        eps.append(_ju(k_eps, (N,)))
    want = np.stack([np.asarray(jsynths._finish(k, jnp.asarray(r), N)) for k, r in zip(keys, y)])
    np.testing.assert_allclose(n(synths._finish(t(y), t(signs), t(np.stack(eps)))), want, atol=1e-7)


def test_random_ends_is_beta_08_08():
    g = torch.Generator().manual_seed(0)
    b = synths.random_ends(g, 40000)
    assert b.shape == (40000,) and float(b.min()) > 0.0 and float(b.max()) < 1.0
    # Beta(a, a): mean 1/2, variance 1/(4(2a+1)) = 0.09615 at a = 0.8
    assert abs(float(b.mean()) - 0.5) < 0.01
    assert abs(float(b.var()) - 1.0 / (4 * 2.6)) < 0.003
    # more mass at the ends than a uniform: P(x < 0.1) = 0.1366 for Beta(0.8, 0.8)
    assert abs(float((b < 0.1).float().mean()) - 0.1366) < 0.01
    jb = np.asarray(jsynths.random_ends(jax.random.PRNGKey(0), (40000,)))
    assert abs(float(b.var()) - float(jb.var())) < 0.004
    # Johnk's rule on given uniforms: the first accepted candidate is taken
    u = torch.tensor([[0.9], [0.2]])
    v = torch.tensor([[0.9], [0.3]])
    x, y = 0.2 ** 1.25, 0.3 ** 1.25
    np.testing.assert_allclose(float(synths.beta_from_uniforms(u, v, 0.8, 0.8)), x / (x + y),
                               rtol=1e-6)


@pytest.mark.parametrize("name,draw,lo,hi", [
    ("box", lambda g: synths.box(t(np.arange(N) / SR), synths.draw_box(g, 64)), 0.0, 0.95),
    ("expdecay", lambda g: synths.expdecay(t(np.arange(N) / SR), synths.draw_expdecay(g, 64)),
     0.0, 0.95),
    ("randsine", lambda g: synths.randsine(t(np.arange(N) / SR), synths.draw_randsine(g, 64)),
     -0.9, 0.9),
    ("pluck", lambda g: synths.pluck(t(np.arange(N) / SR), synths.draw_pluck(g, 64)), -0.9, 0.9),
])
def test_samplers_stay_in_range(name, draw, lo, hi):
    y = draw(torch.Generator().manual_seed(1))
    assert y.shape == (64, N) and bool(torch.isfinite(y).all())
    assert float(y.min()) >= lo - 1e-6 and float(y.max()) <= hi + 1e-6


def test_sampler_draws_have_the_jax_shapes_and_ranges():
    """Every sampler draws what the JAX generator draws: the same names and
    per-example shapes as the key-split re-derivation above, uniforms in
    [0, 1), signs in {-1, 1}, tone counts and sweep ends in the JAX ranges."""
    g = torch.Generator().manual_seed(2)
    for c in range(12):
        got = synths.draw_branch(c, g, 5, N)
        want = stack([d_branch(c, jax.random.PRNGKey(i), N) for i in range(5)])

        def walk(a, b, path):
            assert set(a) == set(b), (c, path, set(a) ^ set(b))
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k], path + (k,))
                    continue
                assert tuple(a[k].shape) == tuple(b[k].shape), (c, path, k)
                if k == "sign":
                    assert set(a[k].flatten().tolist()) <= {-1.0, 1.0}
                elif k == "n_tones":
                    assert int(a[k].min()) >= 1 and int(a[k].max()) <= (3 if "env" in a else 2)
                elif k == "f_low":
                    assert int(a[k].min()) >= 20 and int(a[k].max()) < 1000
                elif k == "f_high":
                    assert int(a[k].min()) >= 1000 and int(a[k].max()) < 20000
                elif k == "amp_too":
                    assert a[k].dtype == torch.bool
                elif k != "noise":
                    assert float(a[k].min()) >= 0.0 and float(a[k].max()) < 1.0

        walk(got, want, ())


@pytest.mark.parametrize("batch", [12, 13, 4, 200])
def test_stratified_batch_has_exact_chooser_counts(batch):
    g = torch.Generator().manual_seed(batch)
    tt = t(np.arange(128) / SR)
    x, ids = synths.stratified_synth_batch(g, tt, synths.DEFAULT_CHOOSERS, batch,
                                           return_choosers=True)
    assert x.shape == (batch, 128) and bool(torch.isfinite(x).all())
    counts = synths.stratified_counts(batch, 6)
    assert sum(counts) == batch and max(counts) - min(counts) <= 1
    for c, cnt in zip(synths.DEFAULT_CHOOSERS, counts):
        assert int((ids == c).sum()) == cnt
    assert synths.DEFAULT_CHOOSERS == jsynths.DEFAULT_CHOOSERS
    # the JAX generator gives the same shape and per-branch shares
    jx = jsynths.stratified_synth_batch(jax.random.PRNGKey(0), jnp.asarray(n(tt)),
                                        jsynths.DEFAULT_CHOOSERS, batch)
    assert jx.shape == tuple(x.shape)
    if batch > 6:  # permuted: the branches are not in order
        assert not torch.equal(ids, torch.sort(ids).values)


def test_make_synth_batch_fn_semantics():
    chunk, y_size, b = 512, 128, 12
    eff = effects.Compressor_4c(device="cpu")
    g = torch.Generator().manual_seed(3)
    plain = synth_data.make_synth_batch_fn(eff, chunk, y_size, augment=False)
    x, y, knobs = plain(b, synth_data.step_generator(g, 5, 0))
    assert x.shape == (b, chunk) and y.shape == (b, y_size) and knobs.shape == (b, 4)
    assert x.dtype == y.dtype == knobs.dtype == torch.float32
    assert float(knobs.min()) >= -0.5 and float(knobs.max()) <= 0.5
    # y is the last y_size samples of the effect over the whole batch
    full, _ = eff.go_batch(x, knobs)
    np.testing.assert_array_equal(n(y), n(full[:, -y_size:]))
    # ... and agrees with the JAX effect on the same inputs (smoother: 1e-6)
    jy, _ = jeffects.Compressor_4c().go_batch(jnp.asarray(n(x)), jnp.asarray(n(knobs)))
    np.testing.assert_allclose(n(y), np.asarray(jy)[:, -y_size:], atol=2e-6)
    # the same (seed, step) gives the same batch; another step another one
    x2, y2, k2 = plain(b, synth_data.step_generator(g, 5, 0))
    assert torch.equal(x, x2) and torch.equal(y, y2) and torch.equal(knobs, k2)
    x3, _, _ = plain(b, synth_data.step_generator(g, 5, 1))
    assert not torch.equal(x, x3)
    # the frozen validation stream repeats
    xv, _, _ = plain(b, synth_data.val_step_generator(g, 2))
    plain(b, synth_data.step_generator(g, 5, 7))
    xv2, _, _ = plain(b, synth_data.val_step_generator(g, 2))
    assert torch.equal(xv, xv2)
    # augmentation flips x and y of an example together, and only by sign
    aug = synth_data.make_synth_batch_fn(eff, chunk, y_size, augment=True)
    xa, ya, ka = aug(b, synth_data.step_generator(g, 5, 0))
    assert torch.equal(ka, knobs)
    sign = torch.sign((xa * x).sum(dim=1))
    assert set(sign.tolist()) == {-1.0, 1.0}  # 12 examples: both occur at this seed
    assert torch.equal(xa, x * sign[:, None]) and torch.equal(ya, y * sign[:, None])
    fx, fy = synth_data.polarity_flip(x, y, torch.tensor([True] + [False] * (b - 1)))
    assert torch.equal(fx[0], -x[0]) and torch.equal(fy[0], -y[0]) and torch.equal(fx[1:], x[1:])
    # the JAX batch function has the same output contract
    jgen = jsynth_data.make_synth_batch_fn(jeffects.Compressor_4c(), chunk, y_size)
    jx, jy2, jk = jgen(jsynth_data.batch_keys(jax.random.PRNGKey(0), 0, b))
    assert (jx.shape, jy2.shape, jk.shape) == (tuple(x.shape), tuple(y.shape), tuple(knobs.shape))
