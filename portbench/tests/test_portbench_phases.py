"""The readers of the program's own marks (``portbench/phases.py`` and the
metrics that use it) on traces and records made by hand: a phase split, a
replay whose device events do not match the graph's node count, the host's
launch calls and own time a step, the idle time inside and outside request
spans and its parts; and None for a program without the marks and for a
run on the CPU."""

import json
import types

import pytest
import torch

from portbench import phases, run as prun
from portbench.trace import Trace
from signaltrain_tpu_torch.utils import profiling

# each replay: (start, end) of its device events, marked synthesis at node 0,
# forward 2, loss 3, backward 4, update 5, 6 nodes in all
REPLAY = [(100, 110), (112, 120), (120, 130), (131, 140), (140, 160), (165, 170)]
PHASES = profiling.GraphPhases((("synthesis", 0), ("forward", 2), ("loss", 3), ("backward", 4),
                                ("update", 5)), 6)
CARD = types.SimpleNamespace(device=torch.device("cuda", 0), start_time=lambda: 1.0)


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    window = _x("portbench_window", "user_annotation", 0, 1000)
    path.write_text(json.dumps({"traceEvents": [window] + events}))
    return Trace(str(path))


def _train_trace(tmp_path, replay=REPLAY, second=None):
    events = [_x("train_block", "user_annotation", 10, 500)]
    for corr, shift in ((1, 0), (2, 200)):
        if corr == 2 and second is not None:
            replay = second
        # a step: two fills and the lr's launch, then the graph's launch
        events.append(_x("train.step", "user_annotation", 11 + shift, 15))
        events += [_x(name, "cuda_runtime", 12 + shift + i, 1, correlation=50 + 4 * corr + i)
                   for i, name in enumerate(("cudaLaunchKernel", "cudaLaunchKernel",
                                             "cudaMemsetAsync"))]
        events.append(_x("cudaGraphLaunch", "cuda_runtime", 20 + shift, 5, correlation=corr))
        events += [_x(f"k{i}", "kernel", s + shift, e - s, correlation=corr)
                   for i, (s, e) in enumerate(replay)]
    events.append(_x("cudaLaunchKernelExC", "cuda_runtime", 300, 1, correlation=70))  # no step's
    events.append(_x("cudaStreamSynchronize", "cuda_runtime", 22, 1, correlation=71))
    other = _x("cudaLaunchKernel", "cuda_runtime", 16, 2, correlation=72)  # another thread's
    events.append(dict(other, tid=7))
    events.append(_x("stray", "kernel", 600, 50, correlation=9))  # not a replay's
    return _trace(tmp_path, events)


def test_the_phase_marks_split_each_replay(tmp_path, monkeypatch):
    split = phases.phase_split(_train_trace(tmp_path), PHASES)
    want = {"synthesis": 18, "forward": 10, "loss": 9, "backward": 20, "update": 5, "busy": 62,
            "idle": 8}
    assert split == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    monkeypatch.setattr(phases, "train_phases", lambda: PHASES)
    tr, out = _train_trace(tmp_path), types.SimpleNamespace(window={"steps": 2})
    read = {m: prun.load_metric(m)(tr, out, CARD) for m in (
        "synth_phase_ms.train", "forward_phase_ms.train", "backward_phase_ms.train",
        "update_phase_ms.train", "replay_idle_ms.train")}
    assert read == pytest.approx({"synth_phase_ms.train": 0.018, "forward_phase_ms.train": 0.019,
                                  "backward_phase_ms.train": 0.020,
                                  "update_phase_ms.train": 0.005, "replay_idle_ms.train": 0.008})
    four = sum(v for k, v in read.items() if k != "replay_idle_ms.train")
    assert four == pytest.approx(split["busy"] * 1e3)


def test_a_replay_that_is_not_the_captured_graph_raises(tmp_path):
    with pytest.raises(RuntimeError, match=r"\[5\] device events.*6 device nodes"):
        phases.phase_split(_train_trace(tmp_path, REPLAY[:5]), PHASES)
    with pytest.raises(RuntimeError, match=r"\[6\] device events.*5 device nodes"):
        phases.phase_split(_train_trace(tmp_path), PHASES._replace(total=5))
    more = REPLAY + [(175, 180)]
    with pytest.raises(RuntimeError, match=r"\[6, 7\] device events"):
        phases.phase_split(_train_trace(tmp_path, second=more), PHASES)


def test_a_replay_the_profiler_lost_records_of_is_left_out(tmp_path):
    """The second replay lost its loss and update events: the split is the
    first replay's alone."""
    short = REPLAY[:3] + REPLAY[4:5]
    split = phases.phase_split(_train_trace(tmp_path, second=short), PHASES)
    assert split == pytest.approx(phases.phase_split(_train_trace(tmp_path), PHASES))


def _serve_trace(tmp_path):
    ann = "user_annotation"
    events = [
        _x("serve_request", ann, 95, 210),
        _x("predict_long", ann, 100, 200),
        _x("predict_long.upload", ann, 100, 20),
        _x("predict_long.super_batch", ann, 120, 130),
        _x("predict_long.join", ann, 250, 30),
        _x("predict_long.pull", ann, 280, 20),
        _x("predict_long", ann, 600, 100),  # nothing on the card inside it
    ] + [_x("Memcpy HtoD", "gpu_memcpy", s, e - s) if i == 0 else _x(f"k{i}", "kernel", s, e - s)
         for i, (s, e) in enumerate([(110, 118), (125, 200), (205, 245), (260, 270), (285, 295),
                                     (400, 500)])]
    return _trace(tmp_path, events)


def test_the_idle_inside_requests_is_put_down_to_their_spans(tmp_path):
    idle = phases.request_idle(_serve_trace(tmp_path))
    assert idle["span_s"] == pytest.approx(300e-6)
    assert idle["idle_s"] == pytest.approx(157e-6)  # 300-400 and 500-600 lie outside requests
    assert idle["by_span"] == pytest.approx({
        "predict_long.upload": 12e-6, "predict_long.super_batch": 15e-6,
        "predict_long.join": 20e-6, "predict_long.pull": 10e-6, "predict_long": 100e-6})
    tr = _serve_trace(tmp_path)
    read = {m: prun.load_metric(m)(tr, None, CARD) for m in (
        "request_idle_pct.serve", "super_batch_idle_pct.serve", "copy_idle_pct.serve")}
    assert read == pytest.approx({"request_idle_pct.serve": 100 * 157 / 300,
                                  "super_batch_idle_pct.serve": 100 * 15 / 300,
                                  "copy_idle_pct.serve": 100 * 22 / 300})


def test_the_launch_calls_and_the_hosts_own_time_a_step(tmp_path):
    """Each 15 us step holds three launch calls of 1 us and a graph launch
    of 5 us (a sync inside it), and another thread's launch."""
    tr = _train_trace(tmp_path)
    assert phases.launches_per_step(tr) == 4.0
    assert prun.load_metric("host_launches.train")(tr, None, CARD) == 4.0
    assert phases.host_self_us(tr) == pytest.approx(15 - 3 - 5)
    assert prun.load_metric("loop_host_us.train")(tr, None, CARD) == pytest.approx(7.0)


def _rec(name, start_s, dur_us, counts=None):
    return profiling.Record(name, int(start_s * 1e9), int(start_s * 1e9 + dur_us * 1e3), 0, None,
                            0, counts)


def test_the_window_records_give_allocations_a_request(tmp_path, monkeypatch):
    records = [_rec("predict_long", 0.5, 900, {"device_allocs": 9}),  # before the window
               _rec("train.step", 1.1, 100),
               _rec("predict_long", 1.3, 40_000, {"device_allocs": 2}),
               _rec("predict_long", 1.4, 40_000, {"device_allocs": 4}),
               _rec("predict_long", 2.9, 200_000, {"device_allocs": 50})]  # past the window
    taken = []
    program = types.SimpleNamespace(take=lambda: taken.append(1) or (records, 0))
    monkeypatch.setattr(phases, "_profiling", lambda: program)
    run = types.SimpleNamespace(device=CARD.device, start_time=lambda: 1.0)
    out = types.SimpleNamespace(window={"window_s": 1.5})
    tr = _trace(tmp_path, [])
    assert prun.load_metric("allocs_per_request.serve")(tr, out, run) == pytest.approx(3.0)
    assert prun.load_metric("allocs_per_request.serve")(tr, out, run) == pytest.approx(3.0)
    assert taken == [1]  # taken once a run, however often read


def test_without_the_programs_marks_or_a_card_the_readers_give_none(tmp_path, monkeypatch):
    names = ["synth_phase_ms.train", "forward_phase_ms.train", "backward_phase_ms.train",
             "update_phase_ms.train", "replay_idle_ms.train", "loop_host_us.train",
             "request_idle_pct.serve", "allocs_per_request.serve", "host_launches.train",
             "super_batch_idle_pct.serve", "copy_idle_pct.serve"]
    out = types.SimpleNamespace(window={"window_s": 1.0, "steps": 2})
    cpu = types.SimpleNamespace(device=torch.device("cpu"), start_time=lambda: 1.0)
    monkeypatch.setattr(phases, "train_phases", lambda: PHASES)
    for name in names:
        assert prun.load_metric(name)(_train_trace(tmp_path), out, cpu) is None, name
        assert prun.load_metric(name)(_serve_trace(tmp_path), out, cpu) is None, name
    monkeypatch.undo()
    monkeypatch.setattr(phases, "_profiling", lambda: types.SimpleNamespace())  # an older program
    for name in names[:5] + names[7:8]:
        assert prun.load_metric(name)(_train_trace(tmp_path), out, CARD) is None, name
    # traces without the program's spans (an older program's runs): no
    # predict_long in a serving run, no train.step in a training one
    for name in ("request_idle_pct.serve", "super_batch_idle_pct.serve", "copy_idle_pct.serve"):
        assert prun.load_metric(name)(_train_trace(tmp_path), out, CARD) is None, name
    older = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e["name"] != "train.step"]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": older}))
    for name in ("host_launches.train", "loop_host_us.train"):
        assert prun.load_metric(name)(Trace(str(tmp_path / "trace.json")), out, CARD) is None
