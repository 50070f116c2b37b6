"""The port's host backend of the dataset tool, on the CPU: the C++
compressors (utils/native.py over csrc/host/compressor_oracle.cpp), the synth
generators' ``freq`` / ``amp`` overrides, and ``cli.gen_dataset --backend
host`` with and without a pool of workers.

* The port's C++ library is built from its own copy of the JAX package's
  source with the same compiler and flags, so its outputs are bit-equal to
  ``signaltrain_tpu.utils.native``'s on the same inputs.
* The port's plain compressors (float32) against the C++ ones (float64)
  within the JAX package's tolerances for its own (tests/test_native_oracle.py:
  2e-5, 2e-4, 5e-5).
* ``ampexpstepup(freq=)`` and ``sweep(amp=)`` against the JAX functions on
  the JAX functions' own draws, atol 1e-5 (tests/test_torch_port_synths.py).
* gen_dataset: the JAX tool's host backend runs once in a subprocess; the
  port's names, knobs and ``effect_info.ini`` equal it, with one worker and
  with two, the two runs' files are byte-identical, and every target is the
  C++ compressor on its written input, bit for bit.
"""

import filecmp
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.dsp import synths as jsynths
from signaltrain_tpu.utils import native as jnative
from signaltrain_tpu_torch.cli import gen_dataset
from signaltrain_tpu_torch.data import audio_io
from signaltrain_tpu_torch.dsp import compressors, iir, synths
from signaltrain_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["hd", "--dur", "0.1", "-n", "6", "-e", "comp_4c", "--device-batch", "2",
        "--backend", "host"]
KNOB_SETS = [(-24, 2, 0.01, 0.01), (-5, 5, 1e-3, 4e-2), (-30, 1.2, 0.04, 0.002)]


def _signal(seed, n=8192, scale=0.4):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def test_cpp_compressors_bit_equal_the_jax_binding():
    x = _signal(0)
    for th, r, at, rt in KNOB_SETS:
        np.testing.assert_array_equal(native.compressor_4controls(x, th, r, at, rt),
                                      jnative.compressor_4controls(x, th, r, at, rt))
    np.testing.assert_array_equal(native.compressor_3knob(x, -24.0, 2.0, 0.045),
                                  jnative.compressor_3knob(x, -24.0, 2.0, 0.045))
    g = _signal(2, 5000, 8.0)
    np.testing.assert_array_equal(native.switched_one_pole(g, 0.93, 0.997),
                                  jnative.switched_one_pole(g, 0.93, 0.997))


def test_cpp_compressors_against_the_plain_ones():
    x = _signal(0)
    for th, r, at, rt in KNOB_SETS:
        ours = compressors.compressor_4controls(torch.from_numpy(x), th, r, at, rt).numpy()
        np.testing.assert_allclose(ours, native.compressor_4controls(x, th, r, at, rt),
                                   atol=2e-5)
    x = _signal(1)
    ours = compressors.compressor(torch.from_numpy(x), -24.0, 2.0, 0.045).numpy()
    np.testing.assert_allclose(ours, native.compressor_3knob(x, -24.0, 2.0, 0.045), atol=2e-4)
    g = _signal(2, 5000, 8.0)
    ours = iir.switched_one_pole(torch.from_numpy(g), 0.93, 0.997).numpy()
    np.testing.assert_allclose(ours, native.switched_one_pole(g, 0.93, 0.997), atol=5e-5)


def test_build_rebuilds_a_stale_library(tmp_path, monkeypatch):
    """A library older than its source is rebuilt, through a temporary file."""
    lib = tmp_path / "libcompressor_oracle.so"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIBRARY", lib)
    assert native.build() == lib and lib.stat().st_size > 0
    built = lib.stat().st_mtime_ns
    assert native.build() == lib and lib.stat().st_mtime_ns == built  # fresh: kept
    os.utime(lib, (0, 0))
    native.build()
    assert lib.stat().st_mtime_ns > 0 and os.listdir(tmp_path) == [lib.name]


def _ju(key):
    return np.float32(jax.random.uniform(key, ()))


def test_ampexpstepup_freq_override_matches_jax():
    tt = np.arange(512, dtype=np.float32) / np.float32(44100.0)
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    draws = {k: torch.tensor([_ju(jax.random.split(key)[j]) for key in keys])
             for j, k in enumerate(("freq", "norm"))}
    freqs = [1000.0, 2000.0, 3500.0]
    for freq in (1000.0, torch.tensor(freqs)):
        got = synths.ampexpstepup(torch.from_numpy(tt), draws, start_db=-30.0, freq=freq)
        per_row = freqs if isinstance(freq, torch.Tensor) else [freq] * 3
        want = np.stack([np.asarray(jsynths.ampexpstepup(key, jnp.asarray(tt), freq=f,
                                                         start_db=-30.0))
                         for key, f in zip(keys, per_row)])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # without the override the drawn frequency stands
    got = synths.ampexpstepup(torch.from_numpy(tt), draws)
    want = np.stack([np.asarray(jsynths.ampexpstepup(key, jnp.asarray(tt))) for key in keys])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_sweep_amp_override_matches_jax():
    tt = np.arange(512, dtype=np.float32) / np.float32(44100.0)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    draws = {k: torch.tensor([_ju(jax.random.split(key)[j]) for key in keys])
             for j, k in enumerate(("amp", "norm"))}
    amps = [0.2, 0.5, 0.7]
    amp_too = torch.tensor([False, True, False])
    for amp in (0.5, torch.tensor(amps)):
        got = synths.sweep(torch.from_numpy(tt), draws, 100.0, 5000.0, amp_too, amp=amp)
        per_row = amps if isinstance(amp, torch.Tensor) else [amp] * 3
        want = np.stack([np.asarray(jsynths.sweep(key, jnp.asarray(tt), freq_range=(100.0, 5000.0),
                                                  amp=a, amp_too=bool(at)))
                         for key, a, at in zip(keys, per_row, amp_too)])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---- cli.gen_dataset --backend host

def knobs_of(name: str) -> list[float]:
    """The knob values of a target's name as the tool passed them: float64
    (``file_data.parse_knob_string`` rounds them to float32)."""
    return [float(v) for v in name[: -len(".wav")].split("__")[1:]]


def listing(root):
    return {sub: sorted(os.listdir(os.path.join(root, sub))) for sub in ("Train", "Val")}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """The JAX tool's host backend, and the port's with 1 and 2 workers, on
    the same arguments: {name: dataset root}."""
    jroot = tmp_path_factory.mktemp("jax")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, os.path.join(REPO, "cli", "gen_dataset.py"), *ARGS,
                          "--workers", "1"], cwd=jroot, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    roots = {"jax": str(jroot / "hd")}
    for workers, extra in (("1", []), ("2", ["--device", "cpu"])):
        root = tmp_path_factory.mktemp(f"w{workers}")
        cwd = os.getcwd()
        os.chdir(root)
        try:
            stats = gen_dataset.main(ARGS + ["--workers", workers] + extra)
        finally:
            os.chdir(cwd)
        assert stats["backend"] == "host" and stats["files"] == 6
        assert stats["workers"] == int(workers) and stats["card_ms_per_batch"] is None
        roots[f"w{workers}"] = str(root / "hd")
    return roots


@pytest.mark.parametrize("which", ["w1", "w2"])
def test_host_backend_names_knobs_and_ini_are_the_jax_tools(made, which):
    got, want = listing(made[which]), listing(made["jax"])
    assert got == want and len(got["Train"]) == 2 * 5 and len(got["Val"]) == 2
    assert open(os.path.join(made[which], "effect_info.ini")).read() == open(
        os.path.join(made["jax"], "effect_info.ini")).read()


def test_host_backend_output_does_not_depend_on_the_workers(made):
    for sub in ("Train", "Val"):
        names = listing(made["w1"])[sub]
        match, mismatch, errors = filecmp.cmpfiles(os.path.join(made["w1"], sub),
                                                   os.path.join(made["w2"], sub), names,
                                                   shallow=False)
        assert match == names and not mismatch and not errors


def test_host_backend_targets_are_the_cpp_compressor_on_the_inputs(made):
    root = made["w2"]
    for sub in ("Train", "Val"):
        for name in [f for f in listing(root)[sub] if f.startswith("target_")]:
            i = name.split("_")[1]
            x, _ = audio_io.read_audio_file(os.path.join(root, sub, f"input_{i}_.wav"))
            y, _ = audio_io.read_audio_file(os.path.join(root, sub, name))
            assert x.shape == y.shape == (2 * 4096,) and np.all(np.abs(x) <= 1.0)
            np.testing.assert_array_equal(y, native.compressor_4controls(x, *knobs_of(name)))


def test_host_synthesis_is_seeded_by_the_first_file():
    """A worker's batch: db files of num_clips clips, every peak at most 1,
    the same for the same (seed, first file) and another for another."""
    payload = dict(effect_cli="comp_4c", sr=44100, seed=3, pcm16=False, num_clips=2,
                   signal_length=2 * 4096, db=4, synth=True)
    gen = gen_dataset.HostGen(payload)
    x = gen.synth(8)
    assert x.shape == (4, 2 * 4096) and np.abs(x).max() <= 1.0
    np.testing.assert_array_equal(x, gen.synth(8))
    assert not np.array_equal(x, gen.synth(10))


def test_host_backend_pcm16_inpath_and_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    gen_dataset.main(["p", "--dur", "0.1", "-n", "3", "-e", "comp", "--pcm16", "--backend",
                      "host", "--workers", "1", "--seed", "4"])
    from scipy.io import wavfile

    for f in [f for f in os.listdir("p/Train") if f.startswith("target_")]:
        assert wavfile.read(f"p/Train/{f}")[1].dtype == np.int16
        x, _ = audio_io.read_audio_file(f"p/Train/input_{f.split('_')[1]}_.wav")
        y, _ = audio_io.read_audio_file(f"p/Train/{f}")
        # the target was rounded after the effect ran on the unrounded input
        np.testing.assert_allclose(y, native.compressor_3knob(x, *knobs_of(f)), atol=2 / 32767)
    os.makedirs("src/Train")
    rng = np.random.default_rng(0)
    for i in range(3):
        audio_io.write_audio_file(f"src/Train/clip{i}.wav",
                                  (0.5 * rng.standard_normal(6000 + 4000 * i)).astype(np.float32))
    gen_dataset.main(["q", "--dur", "0.1", "--inpath", "src", "-n", "3", "--backend", "host",
                      "--workers", "1", "--device-batch", "2", "--seed", "5"])
    names = sorted(f for f in os.listdir("q/Train") if f.startswith("target_"))
    assert len(names) == 3
    infiles = glob.glob("src/*.wav") + glob.glob("src/*/*.wav")  # the tool's order
    for b0 in (0, 2):  # each batch crops from default_rng(seed + b0)
        crop = np.random.default_rng(5 + b0)
        for i in range(b0, min(b0 + 2, 3)):
            sig, _ = audio_io.read_audio_file(infiles[i % 3])
            x, _ = audio_io.read_audio_file(f"q/Train/input_{i}_.wav")
            if len(sig) > 8192:
                ri = int(crop.integers(0, len(sig) - 8192))
                np.testing.assert_array_equal(x, sig[ri : ri + 8192])
            else:
                np.testing.assert_array_equal(x[: len(sig)], sig)
    with pytest.raises(SystemExit) as e:
        gen_dataset.main(["e", "-n", "2", "--dur", "0.1", "--backend", "host", "-e", "echo"])
    assert e.value.code == 1 and "not set up" in capsys.readouterr().out
