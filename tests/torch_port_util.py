"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; the JAX
package runs on the CPU, the port with device="cpu" (its kernels' plain
versions).
"""

import numpy as np
import torch

# flagship and small front-end geometries (tests/test_pallas_frontend.py)
SMALL = dict(ft=64, hop=24, chunk=512)
FLAGSHIP = dict(ft=1024, hop=384, chunk=8192)


# (ft, hop, chunk, batch) of the backward-kernel cases: the small geometry of
# tests/test_pallas_frontend.py, one with hop not dividing ft and a batch
# that fills no tile, and the flagship geometry at batch 2
BWD_GEOMS = [(64, 24, 512, 5), (100, 30, 700, 7), (1024, 384, 8192, 2)]
BWD_IDS = ["small", "ragged", "flagship"]


def analysis_bwd_inputs(ft: int, hop: int, chunk: int, b: int, seed: int = 0) -> dict:
    """Seeded numpy inputs and cotangents for kernel D: signal x (b, chunk),
    full (ft, ft) analysis matrices wr, wi (the windowed-DFT init plus 1%
    noise), cotangents a (of mag) and c (of phs), frame-major (T, b, half):
    unit normals at ft 64 (as tests/test_pallas_frontend.py draws them),
    scaled by 64/ft so that the gradients, which grow with the frame length,
    stay O(1-10) and the absolute tolerances keep their meaning."""
    from signaltrain_tpu_torch.ops import windows

    rng = np.random.default_rng(seed + ft + b)
    half, frames = ft // 2 + 1, (chunk + ft) // hop + 1
    wr, wi = (np.asarray(m, np.float32) for m in windows.analysis_init(ft))
    f32 = lambda *shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)
    return dict(x=f32(b, chunk, scale=0.3), wr=wr + f32(ft, ft, scale=0.01 * np.abs(wr).max()),
                wi=wi + f32(ft, ft, scale=0.01 * np.abs(wr).max()),
                a=f32(frames, b, half, scale=64.0 / ft), c=f32(frames, b, half, scale=64.0 / ft))


def synthesis_bwd_inputs(ft: int, hop: int, b: int, ot: int = 9, seed: int = 0) -> dict:
    """Seeded numpy inputs and cotangent for kernel E: mag (softplus of a
    normal), phs, frame-major (ot, b, half); full (ft, ft) synthesis matrices
    (init plus 1% noise); cotangent a of the trimmed wave (b, out_len)."""
    from signaltrain_tpu_torch.ops import windows

    rng = np.random.default_rng(seed + ft + b + 1)
    half = ft // 2 + 1
    wr, wi = (np.asarray(m, np.float32) for m in windows.synthesis_init(ft, hop))
    f32 = lambda *shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)
    return dict(mag=np.log1p(np.exp(f32(ot, b, half))), phs=f32(ot, b, half, scale=2.0),
                wr=wr + f32(ft, ft, scale=0.01 * np.abs(wr).max()),
                wi=wi + f32(ft, ft, scale=0.01 * np.abs(wr).max()),
                a=f32(b, (ot - 1) * hop - ft))


def regular_phase_cotangent(inp: dict, ft: int, hop: int) -> np.ndarray:
    """The phase cotangent c of analysis_bwd_inputs, zeroed where the bin's
    magnitude is under a quarter of the median magnitude (about 12% of the
    bins, the all-padding frames among them). The adjoint of atan2 is
    dphs / |spec|, so what is left is well conditioned: dW has a median of
    0.5-12 and a maximum of 7-100 at the shapes used here, float32 summation
    order moves it by < 6e-5, and every element of dx and dW can be held to
    5e-4 + 5e-4*|g|, a thousandth of a typical element."""
    from signaltrain_tpu_torch.ops import cuda_frontend

    half = ft // 2 + 1
    xp = torch.nn.functional.pad(t(inp["x"]), (ft, ft))
    w = cuda_frontend.stack_analysis_weights(t(inp["wr"]), t(inp["wi"]), half)
    mag = cuda_frontend.fused_analysis_reference(xp, w, ft, hop)[0].numpy()
    return inp["c"] * (mag >= 0.25 * np.median(mag))


def assert_dw_close(got, want, name: str = "dw"):
    """A gradient within 1e-3 * max|want| of the wanted one, with no absolute
    floor (the gradients of a mean loss are ~1e-4 and smaller; a zeroed leaf
    fails). This is the bound for the unconditioned analysis dW: the atan2
    adjoint dphs / |spec| is heavy-tailed over bins whose magnitude is near
    zero, so max|dW| is 50-800 against a median of 0.7-18 and the order of
    the float32 sums moves the large elements by up to ~1.5e-4 of the largest
    (tests/test_pallas_frontend.py:104-114). The well-conditioned case
    (regular_phase_cotangent) is held element by element instead. For the
    whole model's gradients the measured difference between the packages is
    <= 5e-6 * max|g| on every leaf."""
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= 1e-3 * scale, (name, err, scale)


def assert_close_where_conditioned(got, exact, slack, tol: float = 5e-4, name: str = ""):
    """Every element of `got` within tol + tol*|exact| + slack of the float64
    result `exact`, where `slack` says, element by element, how far the result
    moves under a perturbation that no f32 computation can avoid
    (cuda_frontend.fused_analysis_bwd_conditioning). For kernel D's gradients
    under a unit-normal phase cotangent on every bin: dphs / |spec| amplifies
    the ~5e-7 by which any two f32 spectra differ, so two f32 results cannot
    be compared with each other (the plain version itself is off the float64
    one by ~1e-2 in dx)."""
    got, exact, slack = (np.asarray(n(a), np.float64) for a in (got, exact, slack))
    excess = np.abs(got - exact) - (tol + tol * np.abs(exact) + slack)
    worst = int(np.argmax(excess))
    assert excess.flat[worst] <= 0, (name, got.flat[worst], exact.flat[worst], slack.flat[worst])


# Each effect's tolerance (atol, rtol) against the JAX effect, and on the card
# against the CPU (tests/test_torch_port_effects.py says where each comes
# from): the 4-knob compressor 1e-5, 2e-4 where its release reaches 1 s
# (comp_t, comp_large: alpha near 1); the 3-knob one 1e-4; echo and lowpass
# (lfilter) 1e-5; pitch 1e-4 before the division by its window envelope;
# Denoise's noisy input 1e-6;
# TimeAlign 1e-4 (the pinknoise of its chooser 7).
EFFECT_TOL = {"comp": (1e-4, 0.0), "comp_4c": (1e-5, 0.0), "comp_4c_large": (2e-4, 0.0),
              "comp_large": (2e-4, 0.0), "comp_t": (2e-4, 0.0), "comp_one": (1e-5, 0.0),
              "echo": (1e-5, 0.0), "pitch": (1e-4, 0.0), "denoise": (1e-6, 0.0),
              "decomp_4c": (1e-5, 0.0), "timealign": (1e-4, 0.0), "lowpass": (1e-5, 0.0)}


def assert_effect_close(name: str, got, want) -> None:
    """``got`` within effect ``name``'s EFFECT_TOL of ``want``. For pitch the
    difference is taken before the division by the window envelope
    (``pitch.envelope``, near 0 at the edges, where the output is large): it
    is multiplied by min(envelope, 1)."""
    atol, rtol = EFFECT_TOL[name]
    got, want = n(got), n(want)
    if name == "pitch":
        from signaltrain_tpu_torch.dsp import pitch

        weight = np.minimum(n(pitch.envelope(got.shape[-1]))[: got.shape[-1]], 1.0)
        got, want = got * weight, want * weight
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)


def t(a) -> torch.Tensor:
    """numpy/JAX array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def n(a) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_phase_close(got, want, atol: float, rtol: float):
    """Phases compared as the wrapped difference ((d + pi) mod 2pi) - pi,
    held to atol + rtol*|want| like assert_allclose. Where im ~ 0 and
    re + 1e-7 < 0, a 1-ulp difference in im flips atan2 between +pi and -pi:
    the same angle, 2pi apart in raw value."""
    want = np.asarray(want, np.float64)
    d = np.asarray(got, np.float64) - want
    wrapped = np.abs(np.mod(d + np.pi, 2 * np.pi) - np.pi)
    excess = wrapped - (atol + rtol * np.abs(want))
    assert excess.max() <= 0, (wrapped.max(), excess.max())


def assert_analysis_close(mag, phs, want_mag, want_phs) -> dict:
    """Kernel A's rule, for any way of adding up the spectrum's products.
    Every magnitude within 2e-5 + 2e-5*|mag|. The phase atan2(im, re + 1e-7)
    turns an error e of the spectrum into e / mag, so it is held in two
    classes: bins whose wanted magnitude is >= 1e-2 to the wrapped 2e-4 +
    2e-4*|phs| (an f32 product's own error is ~5e-7: a 4x margin at 1e-2),
    smaller ones to 2e-6 / mag (four times the f32 product's largest error
    against a float64 one). Returns the count and the worst of each class."""
    mag, phs, want_mag, want_phs = (np.asarray(n(a), np.float64)
                                    for a in (mag, phs, want_mag, want_phs))
    d_mag = np.abs(mag - want_mag)
    assert (d_mag - (2e-5 + 2e-5 * np.abs(want_mag))).max() <= 0, ("magnitude", d_mag.max())
    d_phs = np.abs(np.mod(phs - want_phs + np.pi, 2 * np.pi) - np.pi)
    big = want_mag >= 1e-2
    limit = np.where(big, 2e-4 + 2e-4 * np.abs(want_phs), 2e-6 / want_mag)
    worst = int(np.argmax(d_phs - limit))
    assert d_phs.flat[worst] <= limit.flat[worst], (
        "phase", d_phs.flat[worst], limit.flat[worst], want_mag.flat[worst])
    return dict(max_mag_err=float(d_mag.max()), regular_bins=int(big.sum()),
                regular_max_phase_err=float(d_phs[big].max(initial=0.0)),
                small_bins=int((~big).sum()),
                small_max_phase_err=float(d_phs[~big].max(initial=0.0)))


# ---- a model of both packages holding the same weights (JAX imported here,
# not at the top: the card-only tests import this module where JAX is absent)

def tiny_spec():
    """The small model geometry (ft 64, hop 24, 512 -> 128), as a JAX ModelSpec."""
    from signaltrain_tpu.models import st_model as jst

    return jst.ModelSpec(
        scale_factor=512 / 8192.0, shrink_factor=4.0, num_knobs=4, sr=44100,
        in_chunk_size=512, out_chunk_size=128, ft_size=64, hop_size=24,
        time_frames=25, output_time_frames=9,
    )


def jax_params(spec, seed: int, compute_dtype=None):
    """(JAX STModel, its parameters) with the front-end matrices perturbed
    off their DFT init, so a layout error cannot hide. The model computes in
    ``compute_dtype`` (a JAX dtype; float32 when None)."""
    import jax
    import jax.numpy as jnp
    from signaltrain_tpu.models import st_model as jst

    jm = jst.STModel(spec) if compute_dtype is None else jst.STModel(spec, compute_dtype)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    p = params["params"]
    for side in ("dft_analysis", "dft_synthesis"):
        for k in ("w_real", "w_imag"):
            w = np.asarray(p[side][k])
            p[side][k] = (w + rng.normal(size=w.shape) * 0.3 * np.abs(w).mean()).astype(np.float32)
    return jm, jax.tree_util.tree_map(jnp.asarray, params)


def port_model(spec, params, frontend: str):
    """The port's model on the CPU with the JAX parameters carried across."""
    import dataclasses

    from signaltrain_tpu_torch.models import st_model
    from signaltrain_tpu_torch.training import checkpoint

    m = st_model.STModel(st_model.ModelSpec(**dataclasses.asdict(spec)), frontend=frontend,
                         device="cpu")
    m.load_state_dict(checkpoint.params_to_state_dict(params), strict=True)
    return m.eval()


def model_inputs(spec, b: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, spec.in_chunk_size)) * 0.4).astype(np.float32)
    knobs = rng.uniform(-0.5, 0.5, size=(b, spec.num_knobs)).astype(np.float32)
    return x, knobs
