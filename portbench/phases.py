"""Reading the program's own marks: the train graph's phases, its span
records and the spans on the trace.

* ``phase_split``: a captured train step's phase marks
  (``signaltrain_tpu_torch.utils.profiling.graph_phases("train")``: the
  device nodes before each phase, and in all) split every replay of the
  window by position. A replay's device events, sorted by start, are its
  nodes in capture order. A replay with fewer events than the graph's
  nodes lost records in the profiler and is left out; a replay with more,
  or no replay with as many, raises: the marks do not describe the graph.
* ``records``: the program's span records of the window
  (``profiling.take``, taken once a run).
* ``launches_per_step`` and ``host_self_us``: the host's launch calls
  inside the trace's ``train.step`` spans, and its time there outside its
  CUDA API calls.
* ``request_idle``: the card's idle time inside the trace's ``predict_long``
  spans, by the child span it falls in.

A program without these (an older tree) gives None, and so does a run on
the CPU: its metrics are left out of the result.
"""

from __future__ import annotations

import bisect

from .trace import DEVICE_EVENTS, merged, union_s

_taken = [None, None]  # the last run, and the records taken for it
_idle = [None, None]  # the last trace, and its request_idle


def _profiling():
    try:
        from signaltrain_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def train_phases():
    """The train graph's ``GraphPhases``, or None."""
    fn = getattr(_profiling(), "graph_phases", None)
    return None if fn is None else fn("train")


def replays(trace) -> list:
    """The device events of each graph replay launched inside the window's
    ``train_block`` spans (grouped by the correlation of their
    cudaGraphLaunch), each sorted by start."""
    blocks = trace.spans("train_block")
    launches = {e["args"]["correlation"] for e in trace.events
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")
                and any(b["ts"] <= e["ts"] <= b["ts"] + b["dur"] for b in blocks)}
    by_launch = {}
    for e in trace.events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_EVENTS and c in launches:
            by_launch.setdefault(c, []).append(e)
    return [sorted(evs, key=lambda e: e["ts"]) for evs in by_launch.values()]


def phase_split(trace, phases) -> dict | None:
    """Seconds a step: each phase name's card-busy time (the union of its
    node ranges' device intervals; a phase marked more than once, as the
    slices of a microbatched step, sums its ranges), ``busy`` the replays'
    card-busy time, ``idle`` the card's idle time between a replay's first
    and last device event; over the replays whose records are whole (module
    docstring). None without phases or replays."""
    evs_list = replays(trace) if phases is not None else []
    if not evs_list:
        return None
    counts = sorted({len(evs) for evs in evs_list})
    if counts[-1] > phases.total or phases.total not in counts:
        raise RuntimeError(f"trace: replays of {counts} device events, the captured graph "
                           f"{phases.total} device nodes")
    evs_list = [evs for evs in evs_list if len(evs) == phases.total]
    starts = [n for _, n in phases.marks]
    ranges = list(zip([name for name, _ in phases.marks], starts, starts[1:] + [phases.total]))
    out = {name: 0.0 for name, _ in phases.marks}
    out.update(busy=0.0, idle=0.0)
    for evs in evs_list:
        for name, lo, hi in ranges:
            out[name] += union_s((e["ts"], e["ts"] + e["dur"]) for e in evs[lo:hi])
        busy = union_s((e["ts"], e["ts"] + e["dur"]) for e in evs)
        out["busy"] += busy
        out["idle"] += (max(e["ts"] + e["dur"] for e in evs) - evs[0]["ts"]) / 1e6 - busy
    return {k: v / len(evs_list) for k, v in out.items()}


def train_split(trace, run) -> dict | None:
    """``phase_split`` of the train graph, on a card."""
    if run.device.type != "cuda":
        return None
    return phase_split(trace, train_phases())


def records(run, outcome) -> list | None:
    """The program's span records that started and ended in the window, or
    None (no such records in the program, or a run on the CPU)."""
    take = getattr(_profiling(), "take", None)
    if take is None or run.device.type != "cuda":
        return None
    if _taken[0] is not run:
        _taken[:] = [run, take()[0]]
    t0 = run.start_time() * 1e9
    t1 = t0 + outcome.window["window_s"] * 1e9
    return [r for r in _taken[1] if t0 <= r.start_ns and r.end_ns <= t1]


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")
HOST_API = ("cuda_runtime", "cuda_driver")


def _step_calls(trace):
    """Each ``train.step`` span of the trace with the CUDA API calls its
    thread started inside it, or None without such spans."""
    steps = trace.spans("train.step")
    if not steps:
        return None
    calls = [e for e in trace.events if e.get("cat") in HOST_API]
    return [(s, [e for e in calls if e.get("tid") == s.get("tid")
                 and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]) for s in steps]


def launches_per_step(trace) -> float | None:
    """The mean number of the host's launch calls (kernels, graphs, async
    copies and fills: ``LAUNCH_CALLS`` and their ``Ex`` forms) inside the
    trace's ``train.step`` spans, or None without such spans."""
    steps = _step_calls(trace)
    if steps is None:
        return None
    return sum(sum(e["name"].startswith(LAUNCH_CALLS) for e in calls)
               for _, calls in steps) / len(steps)


def host_self_us(trace) -> float | None:
    """Mean microseconds of a ``train.step`` span outside the CUDA API
    calls inside it: the host's own work a step (the reseed, the lr fill,
    the spans and the profiler's own cost). The calls are left out, as the
    host waits in them while the card works through a queue of replays, in
    whichever launch finds the queue full. None without such spans."""
    steps = _step_calls(trace)
    if steps is None:
        return None
    own = [s["dur"] - union_s((max(e["ts"], s["ts"]), min(e["ts"] + e["dur"], s["ts"] + s["dur"]))
                              for e in calls) * 1e6 for s, calls in steps]
    return sum(own) / len(own)


def _busy_within(busy, ends, lo, hi) -> float:
    """Microseconds of [lo, hi] covered by the merged intervals ``busy``
    (``ends`` their ends)."""
    total, i = 0.0, bisect.bisect_right(ends, lo)
    while i < len(busy) and busy[i][0] < hi:
        total += min(busy[i][1], hi) - max(busy[i][0], lo)
        i += 1
    return total


def request_idle(trace, request: str = "predict_long") -> dict | None:
    """The card's idle time inside the window's ``request`` spans:
    ``span_s`` their seconds, ``idle_s`` the seconds of them with no device
    event, ``by_span`` that idle time by the innermost span of the trace's
    host timeline (``user_annotation``) it falls in (``request`` itself
    outside its children). None without such spans or without device
    events."""
    spans = trace.spans(request)
    if not spans or not trace.device:
        return None
    busy = merged(trace.clipped(trace.device))
    ends = [b[1] for b in busy]
    annotations = [e for e in trace.events if e.get("cat") == "user_annotation"]
    out = {"span_s": 0.0, "idle_s": 0.0, "by_span": {}}
    for sp in spans:
        s0, s1 = sp["ts"], sp["ts"] + sp["dur"]
        out["span_s"] += (s1 - s0) / 1e6
        inner = [a for a in annotations if s0 <= a["ts"] and a["ts"] + a["dur"] <= s1]
        cuts = sorted({x for a in inner for x in (a["ts"], a["ts"] + a["dur"])})
        for lo, hi in zip(cuts, cuts[1:]):
            idle = (hi - lo) - _busy_within(busy, ends, lo, hi)
            if idle <= 0:
                continue
            mid = (lo + hi) / 2
            who = min((a for a in inner if a["ts"] <= mid <= a["ts"] + a["dur"]),
                      key=lambda a: a["dur"])["name"]
            out["by_span"][who] = out["by_span"].get(who, 0.0) + idle / 1e6
            out["idle_s"] += idle / 1e6
    return out


def request_idle_share(trace, run, names=None) -> float | None:
    """Percent of the time inside the trace's ``predict_long`` spans in
    which the card idles: all of it, or only inside the child spans
    ``names``. None on the CPU or without such spans. The trace's
    ``request_idle`` is computed once for the metrics that share it."""
    if run.device.type != "cuda":
        return None
    if _idle[0] is not trace:
        _idle[:] = [trace, request_idle(trace)]
    idle = _idle[1]
    if idle is None or idle["span_s"] <= 0:
        return None
    part = idle["idle_s"] if names is None else sum(idle["by_span"].get(n, 0.0) for n in names)
    return 100.0 * part / idle["span_s"]
