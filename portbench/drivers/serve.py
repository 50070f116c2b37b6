"""Serving whole songs through ``predict_long``, one request at a time.

Set-up builds the model as ``utils/load_model.py`` does (``st_model``, the
state dict with ``strict=True``, eval mode) with the seeded weights in the
traffic's compute dtype, makes the traffic (``songs.Traffic``) and serves
the longest and the shortest song once. In the window each request hands
``predict_long`` a song as a host float32 array with its knobs and takes its
output back as a host numpy array.

The loop is closed, with one client: it sends the next song when the last
one returns, so the card serves at the rate it sustains, with no ceiling
set by the traffic; a request's latency runs from the call to the array.
Requests are sent until the window's seconds are up; the window ends when
the last one returns.

The check takes a sample drawn from the seed of the requests completed
(``sample_requests`` of them, the longest completed always among them) and
runs the reference over each song after the window, in float64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, counts, songs, weights
from ..reference import model as ref_model


def p95(latencies: list[float]) -> float:
    """The 95th percentile of all latencies (linear between order statistics)."""
    return float(np.percentile(np.asarray(latencies), 95))


def build(r):
    """(model, state): the program's model with the seeded weights, as
    ``load_model`` builds it."""
    from signaltrain_tpu_torch.models.st_model import st_model

    wl, cfg = r.workload, r.config
    state = weights.make(cfg, r.weight_seed, r.device)
    model = st_model(cfg["scale_factor"], cfg["shrink_factor"], cfg["num_knobs"], cfg["sr"],
                     device=r.device, compute_dtype=getattr(torch, wl["compute_dtype"]))
    model.load_state_dict(state, strict=True)
    model.eval()
    return model, state


def gaps(r, state: dict, served, precision: str = "f64", quantiles=()):
    """(numbers, failed) of the served (song, knobs, output) triples against
    the reference in ``precision``. ``window_gap`` is the worst request's
    ``window_quantile`` of its windows' errors (``compare.window_errors``);
    ``out_gap`` and ``out_rms_gap``, the worst request's largest and RMS
    difference over its reference's RMS, are reported beside it, and
    ``window_gap_<q>`` for each of ``quantiles``."""
    qs = {"window_gap": r.workload["window_quantile"], **{f"window_gap_{q}": q for q in quantiles}}
    numbers, failed = {**dict.fromkeys(qs, 0.0), "out_gap": 0.0, "out_rms_gap": 0.0}, 0
    for sig, knobs, y in served:
        ref = ref_model.predict_long(state, torch.from_numpy(sig).to(r.device),
                                     torch.from_numpy(knobs).to(r.device), r.config,
                                     precision).double().cpu().numpy()
        if y.shape != ref.shape or not np.isfinite(y).all():
            failed += 1
            continue
        rms = float(np.sqrt(np.mean(ref * ref)))
        d = y.astype(np.float64) - ref
        w = compare.window_errors(y, ref, r.config["out_chunk_size"])
        for k, q in qs.items():
            numbers[k] = max(numbers[k], float(np.quantile(w, q)))
        numbers["out_gap"] = max(numbers["out_gap"], float(np.abs(d).max()) / rms)
        numbers["out_rms_gap"] = max(numbers["out_rms_gap"], float(np.sqrt(np.mean(d * d))) / rms)
    return numbers, failed


def serve_window(r, model, traffic, seconds: float):
    """Serve back to back for ``seconds``. Returns (latencies, lengths,
    kept, failed, window_s): each request's seconds from the call to its
    array, its samples, the (song, knobs, output) of a sample of the
    requests drawn from the seed (the longest always kept), and the
    wrong-shaped outputs."""
    from signaltrain_tpu_torch.inference.predict_long import predict_long

    chunk, out = r.config["in_chunk_size"], r.config["out_chunk_size"]
    sample_rng = np.random.default_rng([r.data_seed, 4])
    keep_every = r.workload["sample_requests"]
    lat, lengths, kept, failed = [], [], {}, 0
    r.open_window()
    while r.elapsed() < seconds:
        sig, knobs = traffic.next()
        t = time.perf_counter()
        with r.span("serve_request"):
            y = predict_long(sig, knobs, model)
        lat.append(time.perf_counter() - t)
        lengths.append(len(sig))
        if not (isinstance(y, np.ndarray) and y.shape == (len(sig) - (chunk - out),)):
            failed += 1
        if sample_rng.random() * len(lengths) < keep_every or len(sig) == max(lengths):
            kept[len(lat) - 1] = (sig, knobs, y)
    window_s = r.close_window()
    longest = int(np.argmax(lengths))
    idx = [i for i in kept if i != longest]
    idx = [longest] + [int(i) for i in sample_rng.permutation(idx)[: keep_every - 1]]
    return lat, lengths, [kept[i] for i in idx], failed, window_s


def run(r):
    from signaltrain_tpu_torch.inference.predict_long import predict_long
    from signaltrain_tpu_torch.models import st_model  # noqa: F401  (timed as imports)

    from ..run import Outcome

    wl, cfg = r.workload, r.config
    r.note("imports")
    model, state = build(r)
    r.note("model built")
    traffic = songs.Traffic(wl, cfg, np.random.default_rng([r.data_seed, 3]))
    r.note("songs made")
    for length in (max(traffic.lengths), min(traffic.lengths)):
        predict_long(traffic.song(length), traffic.knobs(), model)
    r.synchronize()
    r.note("longest and shortest song served")
    lat, lengths, sample, failed, window_s = serve_window(
        r, model, traffic, wl["trace_seconds"] if r.trace else r.seconds)
    memory = r.memory_peak()
    del model
    r.free()

    numbers, bad = gaps(r, state, sample)
    chunk, out = cfg["in_chunk_size"], cfg["out_chunk_size"]
    return Outcome(
        attempted=len(lat), failed=failed + bad, numbers=numbers, memory_peak=memory,
        end_to_end={"serve_audio_s_per_s": sum(lengths) / cfg["sr"] / window_s},
        window={"window_s": window_s, "requests": len(lat),
                "windows": [counts.n_windows(n, chunk, out) for n in lengths],
                "audio_s": sum(lengths) / cfg["sr"], "dtype": wl["compute_dtype"],
                "sampled": len(sample), "latency_p95_ms": p95(lat) * 1e3})
