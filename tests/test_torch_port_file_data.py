"""The port's file datasets (data/file_data.py, data/audio_io.py,
dsp/knobs.py, FileEffect, config.py, train(datapath=)) against the JAX
package, on the CPU.

The datasets are written here with numpy and the JAX package's wav writer.
Bit for bit: FileDataset's arrays in each tier (x, y, lengths, knobs_nn, the
int16 copies), with align_end, the inverse swap and compand; a crop of the
f32 tier at given (file, start) against ``jax.lax.dynamic_slice``; the crop
start arithmetic; ``host_batch`` for the same ``default_rng``; the
prefetcher against synchronous sampling; the int16 tier against the f32 tier
on 16-bit files; train() on a file dataset against stepping by hand in each
tier. XLA divides the int16 tier by 32767 as a multiplication by the
reciprocal, an ulp off true division on 1,536 of the 65,536 values, so there
the port's crop is held to the JAX crop's 16-bit content and to 1 ulp. The
streams of torch and jax.random differ, so the device sampler's file,
crop-start and polarity draws are held to their distributions. ``-t
chunk`` batches are held to the JAX effect within
tests/torch_port_util.EFFECT_TOL. One train step on a file batch: loss rtol
1e-5, weights atol 1e-5 (tests/test_torch_port_train.py).
"""

import concurrent.futures
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu import config as jconfig
from signaltrain_tpu.data import audio_io as jaudio_io
from signaltrain_tpu.data import file_data as jfile_data
from signaltrain_tpu.dsp import effects as jeffects
from signaltrain_tpu.dsp import knobs as jknobs
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch import config
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.data import audio_io, file_data
from signaltrain_tpu_torch.dsp import effects, knobs
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from tests.torch_port_util import assert_effect_close, jax_params, n, port_model, tiny_spec

CHUNK, Y_SIZE = 512, 128  # tiny_spec's geometry
KNOBS_WC = [(-10.5, 3.25, 0.005, 0.02), (-20.0, 2.0, 0.01, 0.03), (-5.25, 4.5, 0.002, 0.0101)]
INI = ("[effect]\nname = Compressor_4c\nknob_names = ['threshold', 'ratio', 'attackTime', "
       "'releaseTime']\nknob_ranges = [[-30.0, 0.0], [1.0, 5.0], [0.001, 0.04], [0.001, 0.04]]\n")


def write_dataset(root, n_train: int = 5, n_val: int = 2, pcm16: bool = False, seed: int = 0,
                  ini: str = INI):
    """A small dataset: Train/ and Val/ pairs of 1,500-2,300 samples, each
    odd target 40 samples longer than its input (align_end), knobs in the
    target's name, and an effect_info.ini."""
    rng = np.random.default_rng(seed)
    for sub, count in (("Train", n_train), ("Val", n_val)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(count):
            nx = 1500 + 97 * i
            x = rng.uniform(-0.9, 0.9, size=nx).astype(np.float32)
            y = np.tanh(2.0 * rng.uniform(-0.9, 0.9, size=nx + 40 * (i % 2))).astype(np.float32)
            if pcm16:
                x, y = audio_io.to_pcm16(x), audio_io.to_pcm16(y)
            kw = "".join(f"__{v}" for v in KNOBS_WC[i % len(KNOBS_WC)])
            jaudio_io.write_audio_file(os.path.join(root, sub, f"input_{i}_.wav"), x)
            jaudio_io.write_audio_file(os.path.join(root, sub, f"target_{i}_Compressor_4c{kw}.wav"),
                                       y)
    with open(os.path.join(root, "effect_info.ini"), "w") as f:
        f.write(ini)
    return str(root)


def f32_bytes(ds) -> int:
    return 2 * len(ds.lengths) * int(ds.lengths.max()) * 4


TIERS = {"f32": lambda b: 4 << 30, "int16": lambda b: b - 1, "host": lambda b: 1}


def both(path, effect_name: str, tier: str, **kw):
    """The port's (CPU) and the JAX package's FileDataset on path, in tier."""
    probe = file_data.FileDataset(path, effects.make_effect(effect_name, device="cpu"), CHUNK,
                                  Y_SIZE, device_resident_limit_bytes=0, **kw)
    limit = TIERS[tier](f32_bytes(probe))
    ds = file_data.FileDataset(path, effects.make_effect(effect_name, device="cpu"), CHUNK,
                               Y_SIZE, device_resident_limit_bytes=limit, **kw)
    jds = jfile_data.FileDataset(path, jeffects.make_effect(effect_name), CHUNK, Y_SIZE,
                                 device_resident_limit_bytes=limit, **kw)
    return ds, jds


# ------------------------------------------------------------------ FileDataset

@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("case", ["comp_4c", "decomp_4c", "compand"])
def test_file_dataset_arrays_match_jax(tmp_path, case, tier):
    path = os.path.join(write_dataset(tmp_path), "Train")
    name = "decomp_4c" if case == "decomp_4c" else "comp_4c"
    ds, jds = both(path, name, tier, compand=case == "compand")
    assert (ds.device_resident, ds.device_resident_int16) == (jds.device_resident,
                                                             jds.device_resident_int16)
    assert ds.device_resident == (tier != "host") and ds.device_resident_int16 == (tier == "int16")
    np.testing.assert_array_equal(ds.lengths, jds.lengths)
    assert ds.lengths.dtype == jds.lengths.dtype == np.int32
    np.testing.assert_array_equal(ds.knobs_nn, jds.knobs_nn)
    assert ds.knobs_nn.dtype == np.float32
    for got, want in ((ds.x, jds.x), (ds.y, jds.y)):
        got = n(got)
        assert got.dtype == np.asarray(want).dtype == (np.int16 if tier == "int16" else np.float32)
        np.testing.assert_array_equal(got, np.asarray(want))
    # the swap and the alignment: an inverse effect's input is the file target
    raw_x, _ = audio_io.read_audio_file(ds.input_filenames[1], warn=False)
    raw_y, _ = audio_io.read_audio_file(ds.target_filenames[1], warn=False)
    assert len(raw_y) == len(raw_x) + 40 and ds.lengths[1] == len(raw_x)
    if tier == "f32" and case != "compand":
        first = raw_y[-len(raw_x):] if case == "decomp_4c" else raw_x
        np.testing.assert_array_equal(n(ds.x)[1, : len(raw_x)], first)


def test_crop_matches_dynamic_slice_and_the_start_arithmetic(tmp_path):
    path = os.path.join(write_dataset(tmp_path), "Train")
    rng = np.random.default_rng(1)
    for tier in ("f32", "int16"):
        ds, jds = both(path, "comp_4c", tier)
        i = rng.integers(0, len(ds.lengths), size=9).astype(np.int32)
        start = np.array([rng.integers(0, ds.lengths[k] - CHUNK) for k in i], np.int32)
        x, y = ds.crop(torch.from_numpy(i), torch.from_numpy(start))
        for got, arr in ((x, jds.x), (y, jds.y)):
            want = np.stack([np.asarray(jax.lax.dynamic_slice(arr, (int(a), int(b)), (1, CHUNK))[0])
                             for a, b in zip(i, start)])
            if tier == "int16":  # dequantized by JAX as a reciprocal multiplication
                want_f = want.astype(np.float32) * np.float32(1.0 / 32767.0)
                np.testing.assert_array_equal(np.round(n(got) * 32767.0), want.astype(np.float32))
                np.testing.assert_allclose(n(got), want_f, rtol=1.2e-7, atol=0)
                np.testing.assert_array_equal(n(got), want.astype(np.float32) / np.float32(32767.0))
            else:
                np.testing.assert_array_equal(n(got), want)
    # the start: min(int32(float32(u) * float32(limit)), limit - 1)
    u = np.concatenate([rng.random(200, np.float32), np.nextafter(np.float32(1), 0)[None]])
    ii = rng.integers(0, len(ds.lengths), size=u.size).astype(np.int32)
    got = ds.crop_starts(torch.from_numpy(ii), torch.from_numpy(u))
    limit = jnp.asarray(ds.lengths)[ii] - CHUNK
    want = jnp.minimum((jnp.asarray(u) * limit).astype(jnp.int32), limit - 1)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.max()) <= int(ds.lengths.max()) - CHUNK - 1


def test_int16_tier_gives_the_f32_tiers_batches_on_16_bit_files(tmp_path):
    path = os.path.join(write_dataset(tmp_path, pcm16=True), "Train")
    ds32 = file_data.FileDataset(path, effects.Compressor_4c(device="cpu"), CHUNK, Y_SIZE)
    ds16 = file_data.FileDataset(path, effects.Compressor_4c(device="cpu"), CHUNK, Y_SIZE,
                                 device_resident_limit_bytes=f32_bytes(ds32) - 1)
    assert ds16.device_resident_int16 and ds16.x.dtype == torch.int16
    g = torch.Generator()
    for step in (0, 1, 19):
        a = ds32.batch_fn(7, g.manual_seed(step))
        b = ds16.batch_fn(7, g.manual_seed(step))
        for u, v in zip(a, b):
            assert torch.equal(u, v), step


def test_batch_fn_draws_and_their_distributions(tmp_path):
    """batch_fn is crop(i, start) times the polarity, with i, u and the flip
    drawn from the generator in that order; the files, the crop starts
    (start / limit ~ U(0, 1)) and the flips are uniform."""
    path = os.path.join(write_dataset(tmp_path, n_train=6), "Train")
    ds = file_data.FileDataset(path, effects.Compressor_4c(device="cpu"), CHUNK, Y_SIZE)
    b, g = 6000, torch.Generator()
    x, y, k = ds.batch_fn(b, g.manual_seed(3))
    g.manual_seed(3)
    i = torch.randint(0, 6, (b,), generator=g)
    u = torch.rand(b, generator=g)
    start = ds.crop_starts(i, u)
    flip = torch.rand(b, generator=g) < 0.5
    cx, cy = ds.crop(i, start)
    sign = torch.where(flip, -1.0, 1.0)[:, None]
    assert torch.equal(x, cx * sign) and torch.equal(y, (cy * sign)[:, -Y_SIZE:])
    assert torch.equal(k, torch.from_numpy(ds.knobs_nn)[i]) and y.shape == (b, Y_SIZE)
    counts = np.bincount(n(i), minlength=6)
    assert np.all(np.abs(counts - b / 6) < 5 * np.sqrt(b / 6))
    frac = np.sort(n(start) / (ds.lengths[n(i)] - CHUNK))
    assert frac.min() >= 0 and frac.max() < 1
    assert np.abs(frac - (np.arange(b) + 0.5) / b).max() < 0.03  # Kolmogorov-Smirnov
    assert abs(float(flip.float().mean()) - 0.5) < 0.03


def test_host_batch_matches_jax_for_the_same_rng(tmp_path):
    path = os.path.join(write_dataset(tmp_path), "Train")
    for augment in (True, False):
        ds, jds = both(path, "comp_4c", "host", augment=augment)
        rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            for got, want in zip(ds.host_batch(6, rng), jds.host_batch(6, jrng)):
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_prefetcher_matches_synchronous_sampling_and_closes(tmp_path):
    path = os.path.join(write_dataset(tmp_path), "Train")
    ds, _ = both(path, "comp_4c", "host")
    pf = ds.prefetch_batches(4, np.random.default_rng(0))
    rng = np.random.default_rng(0)
    try:
        for _ in range(7):  # more batches than the ring has slots
            got = pf.next().take("cpu")
            for a, want in zip(got, ds.host_batch(4, rng)):
                np.testing.assert_array_equal(n(a), want)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_reraises_a_dead_producers_error_every_time():
    calls = []

    def make():
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk gone")
        return len(calls)

    pf = file_data._Prefetcher(make, n_slots=2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # a hang fails, it does not stall
        assert pool.submit(pf.next).result(timeout=10) == 1
        assert pool.submit(pf.next).result(timeout=10) == 2
        for _ in range(3):
            with pytest.raises(OSError, match="disk gone"):
                pool.submit(pf.next).result(timeout=10)
    pf.close()
    assert not pf._thread.is_alive() and len(calls) == 3


def test_rerun_batches_within_the_effect_tolerance(tmp_path):
    path = write_dataset(tmp_path)
    ds = file_data.FileDataset(os.path.join(path, "Train"), effects.Compressor_4c(device="cpu"),
                               CHUNK, Y_SIZE, rerun=True, augment=False)
    x, y, k = ds.batch_fn(6, torch.Generator().manual_seed(2))
    jy, jx = jeffects.Compressor_4c().go_batch(jnp.asarray(n(x)), jnp.asarray(n(k)))
    np.testing.assert_array_equal(n(x), np.asarray(jx))
    assert_effect_close("comp_4c", y, np.asarray(jy)[:, -Y_SIZE:])
    with pytest.raises(ValueError, match="signal path"):
        file_data.FileDataset(os.path.join(path, "Train"),
                              effects.make_effect("files", path=path, device="cpu"), CHUNK,
                              rerun=True)


# ------------------------------------------------------------ FileEffect, knobs

@pytest.mark.parametrize("inverse", [None, "True"])
def test_file_effect_matches_jax(tmp_path, inverse):
    ini = INI + (f"inverse = {inverse}\n" if inverse else "")
    path = write_dataset(tmp_path, ini=ini)
    fx = effects.make_effect("files", path=path, device="cpu")
    jfx = jeffects.make_effect("files", path=path)
    assert isinstance(fx, effects.FileEffect)
    assert fx.name == jfx.name == ("De-" if inverse else "") + "Compressor_4c(files)"
    assert fx.knob_names == jfx.knob_names and fx.is_inverse == jfx.is_inverse == bool(inverse)
    np.testing.assert_array_equal(fx.knob_ranges, jfx.knob_ranges)
    assert fx.knob_ranges.dtype == np.float32
    np.testing.assert_array_equal(n(fx.knob_ranges_on(torch.device("cpu"))), jfx.knob_ranges)
    np.testing.assert_array_equal(n(fx.knobs_wc(np.zeros(4, np.float32))),
                                  np.asarray(jfx.knobs_wc(np.zeros(4, np.float32))))
    with pytest.raises(NotImplementedError):
        fx.go_wc(np.zeros(64, np.float32), KNOBS_WC[0])
    os.remove(os.path.join(path, "effect_info.ini"))
    for make in (lambda: effects.make_effect("files", path=path, device="cpu"),
                 lambda: jeffects.make_effect("files", path=path)):
        with pytest.raises(FileNotFoundError):
            make()


def test_knob_utilities_match_jax():
    examples = [(12345, [[-0.5, 0.5]] * 4, 12), (100, [[1, 6]] * 3, 6), (1234, [[0, 9]] * 4, 10)]
    np.testing.assert_allclose(knobs.int2knobs(*examples[0]),
                               [0.136363636, -0.409090909, 0.227272727, 0.318181818], rtol=1e-8)
    assert knobs.int2knobs(*examples[1]) == [3.0, 5.0, 5.0]
    assert knobs.int2knobs(*examples[2]) == [1.0, 2.0, 3.0, 4.0]
    kr = effects.Compressor_4c(device="cpu").knob_ranges
    cases = examples + [(idx, kr, 3) for idx in range(81)] + [(idx, kr[:1], 7) for idx in range(7)]
    for case in cases:
        got, want = knobs.int2knobs(*case), jknobs.int2knobs(*case)
        assert [float(v) for v in got] == [float(v) for v in want], case
    with pytest.raises(AssertionError):
        knobs.int2knobs(81, kr, 3)
    np.testing.assert_array_equal(knobs.random_ends_np(50, np.random.default_rng(4)),
                                  jknobs.random_ends_np(50, np.random.default_rng(4)))
    wc = np.array([[-10.0, 2.0, 0.01, 0.02], [-30.0, 5.0, 0.001, 0.04]], np.float32)
    np.testing.assert_array_equal(knobs.knobs_nn_from_wc(wc, kr), jknobs.knobs_nn_from_wc(wc, kr))


# ---------------------------------------------------------------- audio_io

def _write_aiff(path, samples_int, sr, sampwidth, n_ch=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # aifc is deprecated
        import aifc

    frames = bytearray()
    for frame in np.asarray(samples_int).reshape(-1, n_ch):
        for s in frame:
            frames += int(s).to_bytes(sampwidth, "big", signed=True)
    w = aifc.open(path, "wb")
    w.setnchannels(n_ch)
    w.setsampwidth(sampwidth)
    w.setframerate(sr)
    w.writeframes(bytes(frames))
    w.close()


def _sowt(path, samples, sr=44100):
    mant, exp = int(sr), 16383 + 63
    while mant < (1 << 63):
        mant, exp = mant << 1, exp - 1
    comm = struct.pack(">hIh", 1, len(samples), 16) + struct.pack(">HQ", exp, mant) + b"sowt\x00"
    comm += b"\x00" * (len(comm) % 2)
    ssnd = struct.pack(">II", 0, 0) + samples.astype("<i2").tobytes()
    body = b"AIFC"
    for cid, chunk in ((b"COMM", comm), (b"SSND", ssnd)):
        body += cid + struct.pack(">I", len(chunk)) + chunk + b"\x00" * (len(chunk) % 2)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def test_aiff_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    tone = np.round(0.5 * np.sin(np.arange(2048) * 0.06) * 32767).astype(np.int32)
    stereo = rng.integers(-(2**23) + 1, 2**23 - 1, size=(256, 2))
    cases = {"a16.aiff": (tone, 44100, 2, 1), "a24.aif": (stereo, 44100, 3, 2),
             "low.aiff": (tone[:1000], 22050, 2, 1)}
    for fname, (s, sr, width, ch) in cases.items():
        _write_aiff(str(tmp_path / fname), s, sr, width, ch)
    _sowt(str(tmp_path / "s.aifc"), np.array([0, 1000, -1000, 32767, -32768, 12345], np.int16))
    for fname in list(cases) + ["s.aifc"]:
        p = str(tmp_path / fname)
        for kw in (dict(sr=44100), dict(sr=44100, mono=False), dict(sr=44100, norm=True),
                   dict(sr=22050, warn=False, dtype=np.float64)):
            got, got_sr = audio_io.read_audio_file(p, **kw)
            want, want_sr = jaudio_io.read_audio_file(p, **kw)
            assert got_sr == want_sr and got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{fname} {kw}")
    y, _ = audio_io.read_audio_file(str(tmp_path / "a24.aif"))  # mono: the first channel
    np.testing.assert_allclose(y, stereo[:, 0] / float(2**23 - 1), atol=1e-7)
    assert audio_io.read_audio_file(str(tmp_path / "low.aiff"), warn=False)[0].shape == (2000,)
    raw = struct.pack(">HQ", 16383 + 15, 44100 << 48)
    assert audio_io._float80(raw) == jaudio_io._float80(raw) == 44100.0
    with pytest.raises(ValueError, match="not an AIFF"):
        (tmp_path / "bad.aiff").write_bytes(b"RIFF" + b"\x00" * 20)
        audio_io.read_audio_file(str(tmp_path / "bad.aiff"))


def test_fix_and_overwrite_writes_the_resampled_file(tmp_path):
    p = str(tmp_path / "lo.wav")
    audio_io.write_audio_file(p, (np.sin(np.arange(900) * 0.03) * 0.5).astype(np.float32), 22050)
    y, _ = audio_io.read_audio_file(p, sr=44100, fix_and_overwrite=True, warn=False)
    again, _ = jaudio_io.read_audio_file(p, sr=44100)
    assert y.shape == (1800,)
    np.testing.assert_array_equal(again, y)


class _FakeProc:
    def __init__(self, stdout=b"", stderr=b"", returncode=0):
        self.stdout, self.stderr, self.returncode = stdout, stderr, returncode


def _stand_in_ffmpeg(monkeypatch, decoded: np.ndarray, n_ch: int, have_ffprobe: bool,
                     fail: bool = False):
    """subprocess.run and shutil.which replaced, so that the ffmpeg branch
    runs without an ffmpeg binary; returns the commands it was given."""
    import shutil
    import subprocess

    calls = []

    def which(name):
        found = {"ffmpeg": "/bin/ffmpeg", "ffprobe": "/bin/ffprobe" if have_ffprobe else None}
        return found.get(name)

    def run(cmd, capture_output=False, **kw):
        calls.append(cmd)
        if cmd[0] == "ffprobe":
            return _FakeProc(stdout=f"{n_ch}\n".encode())
        if fail:
            return _FakeProc(stderr=b"Invalid data", returncode=1)
        out = decoded
        if "-ac" in cmd and int(cmd[cmd.index("-ac") + 1]) == 1 and n_ch > 1:
            out = decoded.reshape(-1, n_ch).mean(axis=1)
        return _FakeProc(stdout=out.astype(np.float32).tobytes())

    monkeypatch.setattr(shutil, "which", which)
    monkeypatch.setattr(subprocess, "run", run)
    return calls


@pytest.mark.parametrize("case", ["mono", "stereo", "no_ffprobe", "fails", "missing"])
def test_ffmpeg_branch_with_a_stand_in(tmp_path, monkeypatch, case):
    frames = np.array([[0.1, -0.1], [0.2, -0.2], [0.3, -0.3], [0.4, -0.4]], np.float32)
    path = str(tmp_path / "song.mp3")
    open(path, "wb").write(b"\xff\xfb" + b"\x00" * 16)
    if case == "missing":
        import shutil

        monkeypatch.setattr(shutil, "which", lambda name: None)
        for read in (audio_io.read_audio_file, jaudio_io.read_audio_file):
            with pytest.raises(ValueError, match="ffmpeg"):
                read(path)
        return
    calls = _stand_in_ffmpeg(monkeypatch, frames.reshape(-1), 2, case != "no_ffprobe",
                             fail=case == "fails")
    mono = case == "mono"
    if case == "fails":
        with pytest.raises(ValueError, match="Invalid data"):
            audio_io.read_audio_file(path, mono=mono)
        return
    got, sr = audio_io.read_audio_file(path, sr=22050, mono=mono)
    want, _ = jaudio_io.read_audio_file(path, sr=22050, mono=mono)
    assert sr == 22050 and got.shape == want.shape == ((4,) if mono else (4, 2))
    np.testing.assert_array_equal(got, want)
    ffmpeg = [c for c in calls if c[0] == "ffmpeg"]
    assert ffmpeg[0] == ffmpeg[1] and ffmpeg[0][ffmpeg[0].index("-ar") + 1] == "22050"
    if case == "no_ffprobe":
        assert ffmpeg[0][ffmpeg[0].index("-ac") + 1] == "2"


def test_readaudio_generator_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for i in range(3):
        audio_io.write_audio_file(str(tmp_path / f"v{i}.wav"),
                                  rng.uniform(-1, 1, 3000 + 100 * i).astype(np.float32))
    prefix = str(tmp_path) + "/"
    for random_every in (True, False):
        np.random.seed(11)
        gen = audio_io.readaudio_generator(256, path=prefix, random_every=random_every)
        got = [next(gen) for _ in range(3)] + [gen.send(True), next(gen)]
        np.random.seed(11)
        jgen = jaudio_io.readaudio_generator(256, path=prefix, random_every=random_every)
        want = [next(jgen) for _ in range(3)] + [jgen.send(True), next(jgen)]
        for a, b in zip(got, want):
            assert a.shape == (256,)
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- RunConfig

def test_run_config_from_args_round_trip():
    argv = ["--path", "d", "-e", "files", "-t", "chunk", "-c", "--epochs", "3", "-n", "64", "-b",
            "8", "--lrmax", "2e-3", "--sr", "22050", "--scale", "0.5", "--shrink", "2", "--dtype",
            "float32", "--seed", "9", "--checkpoint", "in.tar", "--out-checkpoint", "out.tar",
            "--cp-every", "2", "--device", "cpu"]
    args = run_train.build_parser().parse_args(argv)
    cfg, jcfg = config.RunConfig.from_args(args), jconfig.RunConfig.from_args(args)
    # nproc: the data-parallel ranks run_train spawns; model_kind and tcn: the TCN (JAX has none)
    port_only = {"device", "nproc", "model_kind", "tcn"}
    fields = set(jconfig.RunConfig.__dataclass_fields__)
    assert set(config.RunConfig.__dataclass_fields__) == fields | port_only
    for field in fields - {"cp_every"}:  # the JAX CLI has no --cp-every
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert (cfg.datapath, cfg.target_type, cfg.compand, cfg.effect_name) == (
        "d", "chunk", True, "files")
    assert (cfg.device, cfg.cp_every, cfg.out_checkpointname) == ("cpu", 2, "out.tar")
    assert cfg.compute_dtype() == torch.float32
    assert cfg.replace(dtype="bf16").compute_dtype() == torch.bfloat16
    assert config.RunConfig().compute_dtype() == torch.bfloat16  # the JAX default
    assert cfg.replace(epochs=5).epochs == 5 and cfg.epochs == 3
    assert cfg.model_spec(4) == config.RunConfig(scale_factor=0.5, shrink_factor=2,
                                                 sr=22050).model_spec(4)
    spec, jspec = cfg.model_spec(4), jcfg.model_spec(4)
    assert (spec.in_chunk_size, spec.out_chunk_size, spec.ft_size) == (
        jspec.in_chunk_size, jspec.out_chunk_size, jspec.ft_size)


# ------------------------------------------------------------------ training

def test_train_step_on_a_file_batch_matches_jax(tmp_path):
    path = os.path.join(write_dataset(tmp_path), "Train")
    ds, jds = both(path, "comp_4c", "f32")
    i = torch.tensor([0, 3, 1, 4, 2, 0, 3, 1])
    x, y = ds.crop(i, ds.crop_starts(i, torch.linspace(0, 0.95, 8)))
    k = torch.from_numpy(ds.knobs_nn)[i]
    y = y[:, -Y_SIZE:]
    spec = tiny_spec()
    jm, params = jax_params(spec, seed=3)
    cfg = dict(lr_max=2e-4, n_data_points=40, epochs=1, batch_size=8)
    tx, _ = jtrain.make_optimizer(**cfg)
    model = port_model(spec, params, "fused").train()  # before the JAX step donates params
    jp, _, jl = jtrain.make_train_step_from_arrays(jm, tx, frontend="pallas")(
        params, tx.init(params), *(jnp.asarray(n(a)) for a in (x, y, k)))
    opt, lr_fn = train_mod.make_optimizer(model, **cfg)
    l = train_mod.train_step_from_arrays(model, opt, lr_fn, 0, x, y.contiguous(), k)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    want = checkpoint.params_to_state_dict(jax.device_get(jp))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(n(p), n(want[name]), atol=1e-5, err_msg=name)


TRAIN_KW = dict(n_data_points=16, batch_size=8, lr_max=1e-3, scale_factor=512 / 8192.0,
                device="cpu", compute_dtype=torch.float32, seed=4, cp_every=2, make_plots=False)


def _by_hand(path, tier_limit, epochs):
    """train()'s run on the file dataset at path, stepped by hand: the losses
    and mean validation MAEs, and the model."""
    from signaltrain_tpu_torch.models.st_model import st_model

    fx = effects.make_effect("files", path=path, device="cpu")
    model = st_model(scale_factor=TRAIN_KW["scale_factor"], device="cpu", num_knobs=4,
                     generator=torch.Generator().manual_seed(TRAIN_KW["seed"]),
                     compute_dtype=torch.float32).train()
    opt, lr_fn = train_mod.make_optimizer(model, 1e-3, 16, epochs, 8)
    ds = file_data.FileDataset(path + "/Train/", fx, CHUNK, Y_SIZE,
                               device_resident_limit_bytes=tier_limit)
    host = not ds.device_resident
    val = file_data.FileDataset(path + "/Val/", fx, CHUNK, Y_SIZE, augment=False,
                                device_resident_limit_bytes=0 if host else tier_limit)
    rng, g, losses, maes = np.random.default_rng(TRAIN_KW["seed"]), torch.Generator(), [], []
    for epoch in range(epochs):
        for s in range(2 * epoch, 2 * epoch + 2):
            batch = (tuple(torch.from_numpy(a) for a in ds.host_batch(8, rng)) if host
                     else ds.batch_fn(8, train_mod.synth_data.step_generator(g, 4, s)))
            losses.append(float(train_mod.train_step_from_arrays(model, opt, lr_fn, s, *batch)))
        model.eval()
        if host:
            vb = val.host_batch(8, np.random.default_rng(7))
            vb = [torch.from_numpy(a) for a in vb]
            maes.append(float(train_mod.eval_step_from_arrays(model, *vb)[1]))
        else:
            maes.append(float(train_mod.eager_validation(model, val.batch_fn, 8, g, 1)[1][0]))
        model.train()
    return losses, maes, model


@pytest.mark.parametrize("tier", list(TIERS))
def test_train_on_a_file_dataset_matches_stepping_by_hand(tmp_path, monkeypatch, tier):
    path = write_dataset(tmp_path / "ds", n_train=4, n_val=1)
    monkeypatch.chdir(tmp_path)
    probe = file_data.FileDataset(path + "/Train/", effects.Compressor_4c(device="cpu"), CHUNK,
                                  device_resident_limit_bytes=0)
    limit = TIERS[tier](f32_bytes(probe))
    fx = effects.make_effect("files", path=path, device="cpu")
    model, hist = train_mod.train(fx, epochs=2, datapath=path, device_resident_limit_bytes=limit,
                                  **TRAIN_KW)
    losses, maes, ref = _by_hand(path, limit, 2)
    assert hist["train_loss"] == losses and hist["val_mae_mean"] == maes and hist["step"] == 4
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    assert len(open("vl_avg_out.dat").read().splitlines()) == 2
    assert len(open("val_err_mae.dat").read().splitlines()) == 2
    _, rv = checkpoint.load_checkpoint("modelcheckpoint.tar")
    assert rv["effect_name"] == "Compressor_4c(files)" and rv["optax_step"] == 4
    if tier == "host":  # resume: the optimizer's step and the logs go on
        _, hist2 = train_mod.train(fx, epochs=2, datapath=path, device_resident_limit_bytes=limit,
                                   **TRAIN_KW)
        assert hist2["step"] == 8 and len(hist2["train_loss"]) == 4
        assert len(open("val_err_mae.dat").read().splitlines()) == 4
        assert checkpoint.load_checkpoint("modelcheckpoint.tar")[1]["optax_step"] == 8


def test_train_closes_the_prefetcher_when_a_step_raises(tmp_path, monkeypatch):
    path = write_dataset(tmp_path / "ds", n_train=3, n_val=1)
    monkeypatch.chdir(tmp_path)
    made = []
    real = file_data.FileDataset.prefetch_batches

    def spy(self, *a, **kw):
        made.append(real(self, *a, **kw))
        return made[-1]

    def boom(*a, **kw):
        raise RuntimeError("step failed")

    monkeypatch.setattr(file_data.FileDataset, "prefetch_batches", spy)
    monkeypatch.setattr(train_mod, "host_steps", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        train_mod.train(effects.make_effect("files", path=path, device="cpu"), epochs=1,
                        datapath=path, device_resident_limit_bytes=1, **TRAIN_KW)
    assert len(made) == 1 and not made[0]._thread.is_alive()


def test_run_train_on_a_file_dataset(tmp_path, monkeypatch, capsys):
    path = write_dataset(tmp_path / "ds", n_train=3, n_val=1)
    monkeypatch.chdir(tmp_path)
    tiny = ["--epochs", "1", "-n", "16", "-b", "8", "--scale", "0.0625", "--device", "cpu",
            "--path", path]
    for extra, out in ((["-e", "files"], "files.tar"), (["-e", "files", "--compand"], "c.tar"),
                       (["--effect", "comp_4c", "-t", "chunk"], "chunk.tar")):
        run_train.main(tiny + extra + ["--out-checkpoint", out])
        assert "Execution completed" in capsys.readouterr().out
        assert os.path.exists(out)
    assert checkpoint.load_checkpoint("files.tar")[1]["effect_name"] == "Compressor_4c(files)"
    assert checkpoint.load_checkpoint("chunk.tar")[1]["effect_name"] == "Compressor_4c"
    os.remove(os.path.join(path, "Val", "input_0_.wav"))
    for argv, said in ((["-e", "files"], "no input files under"),
                       (["-e", "files", "-t", "chunk"], "no signal path"),
                       (["-e", "files", "-t", "sideways"], "invalid target type")):
        with pytest.raises(SystemExit) as e:
            run_train.main(tiny + argv)
        assert e.value.code == 1 and said in capsys.readouterr().out
