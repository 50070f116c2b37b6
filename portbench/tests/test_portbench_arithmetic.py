"""The yardstick's arithmetic against counts made by hand at the flagship
geometry (ft 1024, hop 384, 25 frames in, 9 out, rank 64, batch 200)."""

import json

import numpy as np
import pytest

from portbench import counts, run, trace
from portbench.drivers import serve

CFG = json.loads((run.HERE / "configs" / "comp4c-8k2k.json").read_text())
CFG4K = json.loads((run.HERE / "configs" / "comp4c-4k.json").read_text())


def test_model_flops_by_hand():
    analysis = 2 * 25 * 1024 * 1026
    synthesis = 2 * 9 * 1026 * 1024
    dims = 25 * 64 + 64 * 32 + 32 * 16 + 16 * 16 + 20 * 16 + 16 * 16 + 16 * 32 + 32 * 64 + 64 * 9
    aenc = 2 * 513 * dims
    assert counts.aenc_flops(CFG) == aenc == 8_339_328
    assert counts.forward_flops(CFG) == analysis + synthesis + 2 * aenc == 88_121_088
    assert counts.train_step_flops(CFG) == 264_363_264


def test_front_end_calls_by_hand():
    flops, nbytes = counts.analysis_call(CFG, 200)
    assert flops == 2 * 200 * 25 * 1024 * 1026
    assert nbytes == 4 * (200 * (8192 + 2048) + 1024 * 1026 + 2 * 25 * 200 * 513)
    assert counts.bound_s(flops, nbytes, "bfloat16") == pytest.approx(flops / 989e12)
    assert counts.bound_s(flops, nbytes, "float32") == pytest.approx(flops / 165e12)
    # B: of the 9 frames, 7 reach the trimmed 2048 samples, covering 5376 samples
    assert counts.live(CFG) == (384 + 768 + 3 * 1024 + 768 + 384, 7)
    flops, nbytes = counts.synthesis_call(CFG, 200)
    assert flops == 2 * 200 * 1026 * 5376
    assert nbytes == 4 * (2 * 7 * 200 * 513 + 1026 * 1024 + 200 * 2048)
    assert counts.bound_s(flops, nbytes, "bfloat16") == pytest.approx(nbytes / 3.35e12)
    assert counts.analysis_bwd_call(CFG, 200)[0] == 2 * counts.analysis_call(CFG, 200)[0]
    assert counts.synthesis_bwd_call(CFG, 200)[0] == 2 * counts.synthesis_call(CFG, 200)[0]


def test_audio_seconds_and_windows():
    # one step of the training cells: 200 examples of 2048 output samples
    assert 200 * CFG["out_chunk_size"] / CFG["sr"] == pytest.approx(9.2880, abs=1e-4)
    # a 10 s song at 4k: windows of 4096 every 3968, the tail padded
    n = 441_000
    assert counts.n_windows(n, 4096, 3968) == -(-(n - 4096) // 3968) + 1 == 112
    assert counts.super_batches(2500) == [1024, 1024, 452]
    # 4k: 14 frames, the 12 inner ones reach the trimmed 3968 samples
    assert counts.live(CFG4K) == (384 + 768 + 8 * 1024 + 768 + 384, 12)


def test_p95_is_over_every_request():
    lat = list(np.linspace(0.001, 0.1, 1000))
    assert serve.p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert serve.p95([0.01] * 99 + [1.0]) == pytest.approx(0.01)
    assert serve.p95([0.01] * 90 + [1.0] * 10) == pytest.approx(1.0)


def test_union_and_busy():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert trace.union_s([]) == 0.0
    assert trace.kernel_base("void (anonymous namespace)::product<128, true>(float*)") == "product"
