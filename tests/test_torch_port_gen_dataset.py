"""The port's dataset tools on the CPU, against the JAX package's:
``cli.gen_dataset --device cpu`` (the file names and ``effect_info.ini`` of
the JAX tool for the same arguments, the targets equal to the JAX effect on
the port's inputs within tests/torch_port_util.EFFECT_TOL, --pcm16,
numbering that continues, its refusals), ``cli.check_dataset``,
``cli.resample_dataset`` and ``cli.reshuffle_testval`` on the port's output,
and ``cli.predict_long -e files`` on a dataset's input.

The JAX tool runs once, in a subprocess on the CPU (a module fixture); the
port's tool runs in this process.
"""

import os
import random
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cli import reshuffle_testval as jreshuffle
from signaltrain_tpu.data import audio_io as jaudio_io
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu_torch.cli import check_dataset, gen_dataset, predict_long, resample_dataset
from signaltrain_tpu_torch.cli import reshuffle_testval, run_train
from signaltrain_tpu_torch.data import audio_io, file_data
from signaltrain_tpu_torch.dsp import synths
from tests.torch_port_util import EFFECT_TOL, assert_effect_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["mydata", "--dur", "0.2", "--sp", "2", "-e", "comp_4c", "--device-batch", "8"]


def listing(root):
    return {sub: sorted(os.listdir(os.path.join(root, sub))) for sub in ("Train", "Val")}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """(JAX dataset, port dataset) from the same arguments."""
    jroot, root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, os.path.join(REPO, "cli", "gen_dataset.py"), *ARGS],
                         cwd=jroot, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        stats = gen_dataset.main(ARGS + ["--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert stats["files"] == 20 and stats["card_ms_per_batch"] is None
    return str(jroot / "mydata"), str(root / "mydata")


def test_names_and_ini_are_the_jax_tools(made):
    jpath, path = made
    got, want = listing(path), listing(jpath)
    assert got == want
    assert len(got["Train"]) == 2 * 17 and len(got["Val"]) == 2 * 3  # i / 20 > 0.8 -> Val
    assert open(os.path.join(path, "effect_info.ini")).read() == open(
        os.path.join(jpath, "effect_info.ini")).read()
    # the grid's first corner and a random file beyond the grid (i = 16)
    assert "target_0_Compressor_4c__-30.0__1.0__0.001__0.001.wav" in got["Train"]
    assert any(f.startswith("target_16_Compressor_4c__") for f in got["Train"])


def test_targets_are_the_jax_effect_on_the_ports_inputs(made):
    _, path = made
    jfx = jeffects.Compressor_4c()
    for sub in ("Train", "Val"):
        for name in [f for f in listing(path)[sub] if f.startswith("target_")]:
            i = name.split("_")[1]
            x, _ = audio_io.read_audio_file(os.path.join(path, sub, f"input_{i}_.wav"))
            y, _ = audio_io.read_audio_file(os.path.join(path, sub, name))
            assert x.shape == y.shape == (3 * 4096,) and np.all(np.abs(x) <= 1.0)
            want, _ = jfx.go_wc(jnp.asarray(x), jnp.asarray(file_data.parse_knob_string(name)))
            assert_effect_close("comp_4c", y, np.asarray(want))


def test_synth_files_cover_the_branches_and_normalize_each_clip():
    g = torch.Generator().manual_seed(0)
    t = torch.arange(4096, dtype=torch.float32) / 44100.0
    x = gen_dataset.synth_files(g, 40, 3, t)
    assert x.shape == (40, 3 * 4096) and bool(torch.isfinite(x).all())
    clips = x.reshape(120, 4096)
    assert float(clips.abs().amax()) <= 1.0
    g.manual_seed(0)
    ids = synths.choose_from(g, gen_dataset.CHOOSERS, 120)
    counts = np.bincount(ids.numpy(), minlength=10)[list(gen_dataset.CHOOSERS)]
    assert np.all(counts > 0) and counts.sum() == 120
    assert torch.equal(gen_dataset.synth_files(g.manual_seed(0), 40, 3, t), x)


def test_pcm16_numbering_and_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for _ in range(2):  # the second run numbers on from the first
        gen_dataset.main(["d", "--dur", "0.1", "-n", "5", "-e", "comp", "--pcm16", "--device",
                          "cpu", "--seed", "3"])
    names = sorted(os.listdir("d/Train")) + sorted(os.listdir("d/Val"))
    inputs = sorted(int(f.split("_")[1]) for f in names if f.startswith("input_"))
    assert inputs == list(range(10))
    jfx = jeffects.Compressor()
    for f in [f for f in os.listdir("d/Train") if f.startswith("target_")][:3]:
        i = f.split("_")[1]
        x, _ = audio_io.read_audio_file(f"d/Train/input_{i}_.wav")
        y, _ = audio_io.read_audio_file(f"d/Train/{f}")
        from scipy.io import wavfile

        assert wavfile.read(f"d/Train/{f}")[1].dtype == np.int16
        want = np.asarray(jfx.go_wc(jnp.asarray(x), jnp.asarray(file_data.parse_knob_string(f)))[0])
        # the target was rounded to 16 bits after the effect ran on the float input
        np.testing.assert_allclose(y, np.clip(want, -1, 1), atol=EFFECT_TOL["comp"][0] + 1 / 32767)
    # the host backend and --workers run (auto picks the device backend on
    # the CPU, where --workers has no pool to size); an effect outside the
    # compressor family is refused
    for name, argv, backend in (("h", ["--backend", "host", "--workers", "1"], "host"),
                                ("w", ["--workers", "2"], "device")):
        stats = gen_dataset.main([name, "-n", "2", "--dur", "0.1", "--device", "cpu"] + argv)
        assert stats["backend"] == backend and stats["files"] == 2
        assert len(os.listdir(f"{name}/Train")) + len(os.listdir(f"{name}/Val")) == 4
    with pytest.raises(SystemExit) as e:
        gen_dataset.main(["e", "-n", "2", "--dur", "0.1", "--device", "cpu", "-e", "echo"])
    assert e.value.code == 1 and "not set up" in capsys.readouterr().out


def test_inpath_crops_real_audio(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("src/Train")
    rng = np.random.default_rng(0)
    for i in range(3):
        audio_io.write_audio_file(f"src/Train/clip{i}.wav",
                                  (0.5 * rng.standard_normal(6000 + 2000 * i)).astype(np.float32))
    gen_dataset.main(["d", "--dur", "0.1", "--inpath", "src", "-n", "3", "--device", "cpu",
                      "--device-batch", "2"])
    inputs = [f for f in os.listdir("d/Train") if f.startswith("input_")]
    assert len(inputs) == 3
    x, _ = audio_io.read_audio_file(f"d/Train/{inputs[0]}")
    assert x.shape == (4096 * 2,)


def test_dataset_tools_on_the_ports_output(made, tmp_path, monkeypatch):
    _, path = made
    work = str(tmp_path / "copy")
    shutil.copytree(path, work)
    with pytest.raises(SystemExit) as e:
        check_dataset.main([work])
    assert e.value.code == 0
    # a broken pair (target 30 samples late and longer, stereo) and an extra input are fixed
    x, _ = audio_io.read_audio_file(os.path.join(work, "Train", "input_0_.wav"))
    bad = np.concatenate([np.zeros(30, np.float32), 0.5 * x])
    tname = [f for f in os.listdir(os.path.join(work, "Train")) if f.startswith("target_0_")][0]
    audio_io.write_audio_file(os.path.join(work, "Train", tname), np.stack([bad, bad], axis=1))
    audio_io.write_audio_file(os.path.join(work, "Train", "input_99_.wav"), x)
    with pytest.raises(SystemExit) as e:
        check_dataset.main([work])
    assert e.value.code == 1
    with pytest.raises(SystemExit):
        check_dataset.main([work, "--fix"])
    assert not os.path.exists(os.path.join(work, "Train", "input_99_.wav"))
    with pytest.raises(SystemExit) as e:
        check_dataset.main([work])
    assert e.value.code == 0
    assert check_dataset.is_acceptable("input_3_.aiff") and not check_dataset.is_acceptable("a.txt")

    monkeypatch.chdir(tmp_path)
    resample_dataset.main([path, "--sr", "22050", "--suffix", "_half"])
    half = path + "_half"
    assert listing(half) == listing(path)
    assert open(os.path.join(half, "effect_info.ini")).read() == open(
        os.path.join(path, "effect_info.ini")).read()
    got, sr = audio_io.read_audio_file(os.path.join(half, "Val", "input_19_.wav"), sr=22050)
    want, _ = jaudio_io.read_audio_file(os.path.join(path, "Val", "input_19_.wav"), sr=22050)
    assert sr == 22050 and got.shape == (6144,)
    np.testing.assert_array_equal(got, want)


def test_reshuffle_testval_splits_as_the_jax_tool(made, tmp_path, monkeypatch):
    _, path = made
    splits = {}
    for who, tool in (("port", reshuffle_testval), ("jax", jreshuffle)):
        flat = tmp_path / who
        os.makedirs(flat)
        for sub in ("Train", "Val"):
            for f in os.listdir(os.path.join(path, sub)):
                shutil.copy(os.path.join(path, sub, f), flat / f)
        if who == "port":
            tool.main(["--path", str(flat), "--seed", "5"])
        else:
            random.seed(5)
            monkeypatch.setattr(sys, "argv", ["reshuffle_testval.py", "--path", str(flat)])
            tool.main()
        splits[who] = listing(str(flat))
    assert splits["port"] == splits["jax"]
    got = splits["port"]
    assert len(got["Train"]) + len(got["Val"]) == 40
    for lst in got.values():
        assert {f.split("_")[1] for f in lst if f.startswith("input")} == {
            f.split("_")[1] for f in lst if f.startswith("target")}


def test_predict_long_reads_the_target_beside_a_dataset_input(made, tmp_path, monkeypatch,
                                                             capsys):
    _, path = made
    monkeypatch.chdir(tmp_path)
    run_train.main(["--epochs", "1", "-n", "16", "-b", "8", "--scale", "0.0625", "--device",
                    "cpu", "--path", path, "-e", "files", "--out-checkpoint", "files.tar"])
    wav = os.path.join(path, "Val", "input_17_.wav")
    tname = [f for f in os.listdir(os.path.join(path, "Val")) if f.startswith("target_17_")][0]
    knobs = file_data.parse_knob_string(tname)
    tag = "".join("__" + str(k) for k in np.array([float(v) for v in tname[:-4].split("__")[1:]]))
    predict_long.main(["files.tar", wav, "-e", "files",
                       "--knobs=" + ",".join(str(v) for v in knobs), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "inferred knobs_wc" in out and "Effect name = Compressor_4c(files)" in out
    for stem in ("pl_input", "pl_pred", "pl_st"):
        assert (tmp_path / f"{stem}{tag}.wav").exists(), stem
    target, _ = audio_io.read_audio_file(os.path.join(path, "Val", tname))
    st, _ = audio_io.read_audio_file(str(tmp_path / f"pl_st{tag}.wav"))
    pred, _ = audio_io.read_audio_file(str(tmp_path / f"pl_pred{tag}.wav"))
    np.testing.assert_array_equal(st, target)
    assert pred.shape == target.shape and np.all(np.isfinite(pred))
