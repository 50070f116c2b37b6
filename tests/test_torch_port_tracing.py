"""The port's own spans and counts (``utils/profiling.py``), on the CPU.

* an inactive span is one shared no-op and records nothing, and neither
  ``predict_long`` nor ``train.eager_steps`` then calls ``record_function``;
* active spans nest with their parents' ``seq``, share one id a request or
  step, take their counts, and reach a ``torch.profiler`` trace;
* ``predict_long``'s request holds one ``super_batch`` span a super-batch
  between its upload and its join and pull, and counts its ``device_allocs``
  (none on the CPU), on lengths down to one under the lookback;
* an eager step's phase spans come in the order synthesis, forward, loss,
  backward, update (the middle three once a slice under microbatching), and
  a step called outside any span, under two profiler sessions in turn,
  leaves no phase span open;
* ``ST_TPU_TIMING``'s line keeps its six buckets and ``other``, each bucket
  a self time, and ``train()`` prints it from its spans.

The one ``cuda`` case captures a ``TrainGraph`` on the card: five
nondecreasing phase marks below the graph's device nodes, and replays
bit-equal to the same graph captured without marks. This file imports no
JAX, so the card runs it as ``python -m pytest
tests/test_torch_port_tracing.py --noconftest -q``.
"""

import json
import re

import numpy as np
import pytest
import torch

from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models.st_model import st_model
from signaltrain_tpu_torch.training import train as train_mod
from signaltrain_tpu_torch.utils import profiling

SCALE = 512 / 8192.0  # chunk 512, out 128: a lookback of 384


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.take()
    yield
    profiling.take()


@pytest.fixture(scope="module")
def tiny():
    """A float32 model at chunk 512 and the comp_4c effect, on the CPU."""
    model = st_model(scale_factor=SCALE, device="cpu", compute_dtype=torch.float32,
                     generator=torch.Generator().manual_seed(3))
    return model, effects.Compressor_4c(device="cpu")


def _counting_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return calls


def _eager(model, effect, n=2, micro=1, step0=0):
    opt, lr_fn = train_mod.make_optimizer(model, 1e-4, 64, 2, 4)
    spec = model.spec
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)
    return train_mod.eager_steps(model, opt, lr_fn, batch_fn, 4, torch.Generator(), 7, step0, n,
                                 micro=micro)


def test_an_inactive_span_is_the_shared_no_op():
    assert not profiling.active()
    a, b = profiling.span("train.step", 3), profiling.span("predict_long")
    assert a is b
    with a as inside:
        profiling.count("device_allocs", 5)
        profiling.phase("forward")
    assert inside is a
    assert profiling.take() == ([], 0)


@pytest.mark.parametrize("path", ["predict_long", "eager_steps"])
def test_no_record_function_call_while_inactive(tiny, monkeypatch, path):
    calls = _counting_record_function(monkeypatch)
    model, effect = tiny
    if path == "predict_long":
        y = pl.predict_long(np.ones(2000, np.float32) * 0.1, np.zeros(4, np.float32), model)
        assert y.shape == (2000 - 384,)
    else:
        model.train()
        assert _eager(model, effect).shape == (2,)
    assert calls == [] and profiling.take() == ([], 0)


def test_active_spans_nest_with_their_parents_and_share_one_id():
    with profiling.recording(True):
        with profiling.span("train.step", 41) as step:
            with profiling.span("train.reseed"):
                profiling.count("device_allocs", 2)
            profiling.count("device_allocs", 1)
            profiling.count("device_allocs", 3)
        with profiling.span("predict_long"):
            with profiling.span("predict_long.upload"):
                pass
        with profiling.span("predict_long"):
            pass
    assert not profiling.active()
    records, dropped = profiling.take()
    assert dropped == 0
    assert [r.name for r in records] == ["train.reseed", "train.step", "predict_long.upload",
                                         "predict_long", "predict_long"]
    reseed, step_r, upload, req1, req2 = records
    assert step_r.seq == step.seq and reseed.parent == step_r.seq and step_r.parent is None
    assert reseed.id == step_r.id == 41
    assert reseed.counts == {"device_allocs": 2} and step_r.counts == {"device_allocs": 4}
    assert upload.parent == req1.seq and upload.id == req1.id and req1.id != req2.id
    for r in records:
        assert 0 < r.start_ns <= r.end_ns
    assert step_r.start_ns <= reseed.start_ns <= reseed.end_ns <= step_r.end_ns


def test_the_buffer_keeps_at_most_its_capacity(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.recording(True):
        for _ in range(5):
            with profiling.span("train.block"):
                pass
    records, dropped = profiling.take()
    assert len(records) == 3 and dropped == 2


def test_spans_under_the_profiler_reach_the_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.active()
        with profiling.span("predict_long"):
            with profiling.span("predict_long.pull"):
                torch.ones(8).sum()
    assert not profiling.active()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"predict_long", "predict_long.pull"} <= names
    records, _ = profiling.take()
    assert [r.name for r in records] == ["predict_long.pull", "predict_long"]


@pytest.mark.parametrize("length,super_batch", [(300, 1024), (450, 1024), (2000, 1024),
                                                (5000, 1024), (5000, 8)])
def test_predict_long_counts_its_request(tiny, monkeypatch, length, super_batch):
    model, _ = tiny
    model.eval()
    monkeypatch.setattr(pl, "SUPER_BATCH", super_batch)
    sig = np.random.default_rng(length).uniform(-0.5, 0.5, length).astype(np.float32)
    with profiling.recording(True):
        for n in (length, length // 2):
            pl.predict_long(sig[:n], np.zeros(4, np.float32), model)
    records, _ = profiling.take()
    requests = [r for r in records if r.name == "predict_long"]
    assert len(requests) == 2 and requests[0].id != requests[1].id
    assert all(r.counts == {"device_allocs": 0} for r in requests)
    for req, n in zip(requests, (length, length // 2)):
        windows = pl._num_windows(n, 512, 384)
        windows = windows if windows >= 1 else pl.MIN_BUCKET
        inner = [r for r in records if r.parent == req.seq]
        assert [r.name for r in inner] == (["predict_long.upload"]
                                           + ["predict_long.super_batch"]
                                           * -(-windows // super_batch)
                                           + ["predict_long.join", "predict_long.pull"])
        assert all(r.id == req.id and r.counts is None for r in inner)


@pytest.mark.parametrize("micro", [1, 2])
def test_an_eager_steps_phases_come_in_order(tiny, micro):
    model, effect = tiny
    model.train()
    with profiling.recording(True):
        _eager(model, effect, n=2, micro=micro, step0=5)
    records, _ = profiling.take()
    steps = sorted((r for r in records if r.name == "train.step"), key=lambda r: r.start_ns)
    assert [r.id for r in steps] == [5, 6]
    want = (["train.synthesis"] + ["train.forward", "train.loss", "train.backward"] * micro
            + ["train.update"])
    for step in steps:
        phases = sorted((r for r in records if r.parent == step.seq), key=lambda r: r.start_ns)
        assert [r.name for r in phases] == want
        assert all(r.id == step.id for r in phases)
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        assert step.start_ns <= phases[0].start_ns and phases[-1].end_ns <= step.end_ns


def test_a_phase_outside_any_span_records_nothing(tiny):
    """A step called bare inside two profiler sessions in turn: no phase span
    is left open across them (its end would come in the next session)."""
    from torch.profiler import ProfilerActivity, profile

    model, effect = tiny
    model.train()
    opt, lr_fn = train_mod.make_optimizer(model, 1e-4, 64, 2, 4)
    spec = model.spec
    batch = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)(
        4, torch.Generator().manual_seed(2))
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            train_mod.train_step_from_arrays(model, opt, lr_fn, 0, *batch)
        assert getattr(profiling._local, "phase", None) is None
    assert profiling.take() == ([], 0)


def _rec(name, start, end, seq, parent=None):
    return profiling.Record(name, int(start * 1e9), int(end * 1e9), seq, parent, 0, None)


def test_the_timing_line_gives_each_bucket_its_self_time():
    records = [
        _rec("train.fetch", 2.0, 3.0, 3, 2),  # inside dispatch, through a train.step
        _rec("train.step", 1.5, 4.0, 2, 1),
        _rec("train.dispatch", 1.0, 5.0, 1, 0),
        _rec("train.block", 1.0, 6.0, 0),
        _rec("train.pending", 5.0, 5.5, 4, 0),
        _rec("train.eval", 6.0, 8.0, 5),
        _rec("train.evproc", 8.0, 8.25, 6),
        _rec("train.cp", 8.5, 9.0, 7),
        _rec("train.pending", 9.0, 9.5, 8),
    ]
    line = train_mod.timing_line(2, 10.0, records)
    m = re.fullmatch(r"\[timing\] epoch 3: total=([\d.]+)s (.*)", line)
    assert m and float(m.group(1)) == 10.0
    got = {k: float(v) for k, v in (kv.split("=") for kv in m.group(2).split())}
    assert list(got) == ["dispatch", "pending", "eval", "evproc", "cp", "fetch", "other"]
    assert got == {"dispatch": 3.0, "pending": 1.0, "eval": 2.0, "evproc": 0.25, "cp": 0.5,
                   "fetch": 1.0, "other": 2.25}


def test_train_prints_its_timing_line_from_its_spans(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ST_TPU_TIMING", "1")
    train_mod.train(effects.Compressor_4c(device="cpu"), epochs=2, n_data_points=16,
                    batch_size=8, scale_factor=SCALE, device="cpu",
                    compute_dtype=torch.float32, make_plots=False)
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[timing]")]
    assert [ln.split(":")[0] for ln in lines] == ["[timing] epoch 1", "[timing] epoch 2"]
    for ln in lines:
        got = dict(kv.split("=") for kv in ln.split(": ", 1)[1].split())
        assert list(got) == ["total", "dispatch", "pending", "eval", "evproc", "cp", "fetch",
                             "other"]
        total = float(got.pop("total").rstrip("s"))
        assert float(got["dispatch"]) > 0 and float(got["eval"]) > 0
        assert all(float(v) >= 0 for k, v in got.items() if k != "other")
        assert sum(float(v) for v in got.values()) == pytest.approx(total, abs=1e-3)
    assert not profiling.active()


@pytest.mark.cuda
def test_a_captured_train_graph_marks_its_phases_and_replays_as_before(monkeypatch):
    """The flagship bf16 step captured twice from the same weights: with the
    phase marks, and with ``profiling.phase`` a no-op (the step as it was
    captured before the marks). Five nondecreasing marks below the graph's
    device nodes, published as ``graph_phases("train")``; 6 steps (the
    warm-up and 5 replays) of each bit-equal, losses and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from signaltrain_tpu_torch.models.st_model import STModel, compute_spec
    from signaltrain_tpu_torch.training import graphs

    dev = torch.device("cuda", 0)
    effect = effects.make_effect("comp_4c", device=dev)
    spec = compute_spec(num_knobs=effect.num_knobs)
    batch_fn = synth_data.make_synth_batch_fn(effect, spec.in_chunk_size, spec.out_chunk_size)

    def run():
        model = STModel(spec, device=dev, compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(1)).train()
        opt, lr_fn = train_mod.make_optimizer(model, 2e-4, 4000, 3, 200)
        graph = graphs.TrainGraph(model, opt, lr_fn, batch_fn, 8, torch.Generator(device=dev),
                                  218, capacity=6)
        losses = graph(0, 6)
        return graph, losses, [p.detach().clone() for p in model.parameters()]

    _, losses, weights = run()
    phases = profiling.graph_phases("train")
    assert [name for name, _ in phases.marks] == ["synthesis", "forward", "loss", "backward",
                                                  "update"]
    at = [n for _, n in phases.marks]
    assert at == sorted(at) and at[-1] < phases.total
    assert at[0] < at[1] < at[2] < at[3] < at[4]  # every phase holds device work
    monkeypatch.setattr(profiling, "phase", lambda name: None)
    _, plain_losses, plain_weights = run()
    assert torch.equal(losses, plain_losses)
    for a, b in zip(weights, plain_weights):
        assert torch.equal(a, b)
