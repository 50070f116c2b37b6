"""The port's visualization and demo tools on the CPU, against the JAX package.

* ``cli.viz`` headless on demo/model_comp4c_demo.tar with ``--device cpu``:
  its input, 30 activations and output within atol 1e-3 of the JAX model's
  ``return_acts`` at that checkpoint on the same input (the model-output
  tolerance, tests/test_torch_cross_parity.py:146-150), and the PNG of the
  expected size: one tile an activation and one a front-end matrix, each
  with its rule.
* ``cli.knob_sweep --frames 3 --device cpu --movie``: each frame's
  prediction within atol 1e-3 of the JAX model's on the same input and
  knobs, its target the JAX effect's on the same input (EFFECT_TOL), three
  PNGs, and ffmpeg (a stand-in on PATH that records its argv) called as the
  JAX tool calls it.
* ``cli.bokeh_sliders.DemoState`` as tests/test_demo.py holds the JAX one.
* ``cli.soxeffect``: the range parser against the JAX tool's for the same
  seeded draws, and a run with a stand-in ``sox`` whose argv and
  effect_info.ini stanza equal the JAX tool's (run in a subprocess).
"""

import os
import stat
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from cli import soxeffect as jsoxeffect
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.utils.load_model import load_model as jload_model
from signaltrain_tpu_torch.cli import bokeh_sliders, knob_sweep, soxeffect, viz
from tests.torch_port_util import assert_effect_close, n

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "demo", "model_comp4c_demo.tar")
ATOL = 1e-3


def _stand_in(bindir, name: str) -> str:
    """An executable ``name`` in bindir that appends its argv to name.argv."""
    path = bindir / name
    log = bindir / f"{name}.argv"
    path.write_text(f"#!/bin/sh\nprintf '%s\\n' \"$*\" >> '{log}'\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(log)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's viz and knob_sweep runs, and the JAX model's return_acts on
    their inputs in one batch: (viz result, sweep result, JAX outputs, dirs)."""
    root = tmp_path_factory.mktemp("tools")
    bindir = root / "bin"
    bindir.mkdir()
    log = _stand_in(bindir, "ffmpeg")
    cwd, path = os.getcwd(), os.environ["PATH"]
    os.chdir(root)
    os.environ["PATH"] = f"{bindir}{os.pathsep}{path}"
    try:
        vz = viz.main([CKPT, "--device", "cpu", "--out", "viz.png"])
        sw = knob_sweep.main([CKPT, "--frames", "3", "--device", "cpu", "--movie"])
    finally:
        os.chdir(cwd)
        os.environ["PATH"] = path
    model, params, _ = jload_model(CKPT)
    x = np.stack([n(vz["x"])] + [f["x_in"] for f in sw["frames"]])
    knobs = np.stack([vz["knobs"]] + [f["knobs_nn"] for f in sw["frames"]])
    fwd = jax.jit(lambda p, xb, kb: model.apply(p, xb, kb, return_acts=True))
    jy, _, _, jacts = fwd(params, jnp.asarray(x), jnp.asarray(knobs))
    return vz, sw, (jy, jacts), root, log


def test_viz_activations_match_jax(runs):
    vz, _, (jy, jacts), _, _ = runs
    acts = vz["acts"]
    assert len(acts) == 1 + 30 + 1
    np.testing.assert_array_equal(n(acts[0]), n(vz["x"]))
    for i, (a, ja) in enumerate(zip(acts[1:-1], jacts)):
        ja = np.asarray(ja, np.float32)[:1]
        assert tuple(a.shape) == ja.shape, i
        np.testing.assert_allclose(n(a), ja, atol=ATOL, err_msg=str(i))
    np.testing.assert_allclose(n(acts[-1]), np.asarray(jy)[:1], atol=ATOL)


def test_viz_png_has_a_tile_each(runs):
    vz, _, _, root, _ = runs
    img = np.asarray(Image.open(root / "viz.png"))
    heights = viz.tile_heights(vz["acts"]) + [viz.WEIGHT_TILE] * len(viz.WEIGHTS)
    assert vz["tiles"] == len(heights) == 36
    assert img.shape == (sum(heights) + viz.RULE * len(heights), 1600, 3)
    assert np.array_equal(img, vz["image"])
    rules = np.cumsum(np.array(heights) + viz.RULE) - 1  # each tile's last rule row
    assert np.all(img[rules] == 255)


def test_viz_interactive_needs_opencv_and_a_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setitem(sys.modules, "cv2", None)  # as if OpenCV were absent
    with pytest.raises(RuntimeError, match="OpenCV"):
        viz._interactive(lambda kn: None, ["a"])
    monkeypatch.setitem(sys.modules, "cv2", object())
    with pytest.raises(RuntimeError, match="display"):
        viz._interactive(lambda kn: None, ["a"])


def test_knob_sweep_frames_match_jax(runs):
    _, sw, (jy, _), root, _ = runs
    assert len(sw["frames"]) == 3
    assert [f["knobs_nn"][0] for f in sw["frames"]] == [-0.5, 0.0, 0.5]
    jfx = jeffects.Compressor_4c()
    for k, f in enumerate(sw["frames"]):
        np.testing.assert_allclose(f["pred"], np.asarray(jy)[1 + k], atol=ATOL)
        want, _ = jfx.go(jnp.asarray(f["x_in"]), jnp.asarray(f["knobs_nn"]))
        assert_effect_close("comp_4c", f["target"], np.asarray(want))
    assert sorted(os.listdir(root / "knob_sweep")) == [f"sweep_{i:04d}.png" for i in range(3)]


def test_knob_sweep_movie_calls_ffmpeg(runs):
    _, sw, _, _, log = runs
    assert sw["movie"] == "knob_sweep.mp4"
    assert open(log).read().split() == [
        "-y", "-framerate", "10", "-i", os.path.join("knob_sweep", "sweep_%04d.png"),
        "-c:v", "libx264", "-vf", "format=yuv420p", "knob_sweep.mp4"]


def test_demo_state_comp4c(monkeypatch):
    monkeypatch.setitem(bokeh_sliders.EFFECT_CHECKPOINTS, "comp_4c", CKPT)
    state = bokeh_sliders.DemoState("comp_4c", device="cpu")
    assert state.chunk == state.model.spec.in_chunk_size
    x, y_t, y_p = state.run([-30.0, 5.0, 0.002, 0.002])  # heavy compression
    assert x.shape == (state.chunk,) and y_p.shape == (state.out_chunk,)
    assert np.all(np.isfinite(x)) and np.all(np.isfinite(y_t)) and np.all(np.isfinite(y_p))
    assert not np.allclose(y_t[-state.out_chunk:], x[-state.out_chunk:], atol=1e-3)
    err = np.mean(np.abs(y_p - y_t[-state.out_chunk:]))
    assert err < np.mean(np.abs(y_t[-state.out_chunk:])), err
    x0 = n(state.x)
    state.new_input("sweep")
    assert not np.array_equal(n(state.x), x0)
    for name in bokeh_sliders.SIGNAL_CHOICES:
        state.new_input(name)
        assert np.all(np.isfinite(n(state.x)))


def test_demo_state_denoise():
    den = bokeh_sliders.DemoState("denoise", device="cpu")  # demo/modelcheckpoint_denoise.tar
    x, y_t, y_p = den.run([float((lo + hi) / 2) for lo, hi in den.effect.knob_ranges])
    assert np.all(np.isfinite(y_p)) and y_p.shape == (den.out_chunk,)


def test_soxeffect_ranges_match_jax():
    s = "0.7,0.9 0.5,0.9 40.0,60.0 0.2,0.5 0.1,.4 1.0,3.0 -s"
    for seed in range(3):
        np.random.seed(seed)
        want = jsoxeffect.ranges_to_vals(s)
        np.random.seed(seed)
        assert soxeffect.ranges_to_vals(s) == want
    assert soxeffect.ranges_to_vals("0.5 -s") == jsoxeffect.ranges_to_vals("0.5 -s")


@pytest.mark.parametrize("params", ["0.7,0.9 0.5,0.9 40.0,60.0 -s", "0.5 -s"])
def test_soxeffect_run_is_the_jax_tools(tmp_path, monkeypatch, capsys, params):
    """One input file (the JAX tool draws in its pool's one worker, from the
    parent's state): the same sox argv and stanza for the same seed."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = _stand_in(bindir, "sox")
    env_path = f"{bindir}{os.pathsep}{os.environ['PATH']}"
    code = ("import sys, numpy as np; np.random.seed(3); from cli import soxeffect; "
            f"sys.argv = ['soxeffect.py', 'chorus', {params!r}, 'input_0_.wav']; soxeffect.main()")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PATH": env_path, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    want_argv = open(log).read()
    want_ini = out.stdout.split("effect_info.ini file:\n")[1].strip()
    os.remove(log)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", env_path)
    np.random.seed(3)
    soxeffect.main(["chorus", params, "input_0_.wav"])
    assert open(log).read() == want_argv and want_argv.startswith("--multi-threaded input_0_.wav")
    assert capsys.readouterr().out.split("effect_info.ini file:\n")[1].strip() == want_ini
