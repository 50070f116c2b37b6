"""The training loop's steps as CUDA graphs, captured once and replayed.

Counterpart of the JAX package's fused multi-step dispatch in
signaltrain_tpu/training/train.py: ``make_train_multi_step`` (:264-383) runs
a ``lax.scan`` over whole steps, data synthesis included, in one device call,
and ``make_eval_scan`` (:486-588) the whole validation pass in one call. The
PyTorch counterpart of a program built once and run many times is a CUDA
graph:

* ``TrainGraph`` captures one whole loop step: ``batch_fn`` (the stratified
  synthesis, the effect with kernel C, the trim, the polarity flip), the
  forward (kernels A and B, or the GEMM front-end), ``calc_loss``, the
  backward (E, D), ``clip_frontend_grads`` and ``opt.step()``
  (``train.optimizer_step``, the body of ``train_step_from_arrays``). It is
  replayed once a step. A TCN's step (``models/tcn.py``) is captured the
  same way: its BatchNorms' running statistics are buffers that each replay
  updates in place, as the eager step does. Under ``ST_TPU_MICROBATCH`` the
  forward and the backward run in slices of the synthesized batch inside
  the same capture.
* ``EvalGraph`` captures one validation batch (``val_batch_fn`` and
  ``eval_step_from_arrays``) and is replayed once a batch.
* ``ArraysTrainGraph`` and ``ArraysEvalGraph`` are the counterparts of
  ``make_train_step_from_arrays`` / ``make_eval_step_from_arrays`` (one step
  a device call), for a file corpus sampled on the host: the captured step
  reads static (x, y, knobs) buffers on the card, and before each replay the
  host copies the next batch into them on the same stream (a prefetched
  batch asynchronously from pinned memory).

Between two replays the host reseeds the generator for the step
(``synth_data.step_generator`` / ``val_step_generator``) and, for a train
step, writes the step's learning rate into Adam's lr tensor; nothing else.
The graph registers the generator, so each replay's prologue copies its seed
and offset (0 after ``manual_seed``) to the card and the replay draws what
the eager step draws for (seed, step), bit for bit: resume and the frozen
validation stream hold as before. Each graph appends its losses (and MAEs)
to a buffer on the card, fetched by the caller once a block of steps. An
evaluation graph also keeps the last batch's (x, y, knobs, y_hat, mag,
mag_hat) as its outputs (``last``): the next replay overwrites them, so a
caller that reads them later copies them first (``utils/async_io.snapshot``).

The capture follows PyTorch's whole-network pattern: the first call runs
the body for real on a side stream (the warm-up: it builds the kernels,
cuFFT's plan, cuBLAS's workspace, ``loss.freq_scale``'s tensor, the effect's
knob ranges on the card and Adam's state), then captures it on that stream
into the graph's own memory pool, with ``zero_grad(set_to_none=True)``
inside. So the first train step (and the first validation batch) of a graph
is its warm-up, the same step dispatched op by op, and every later one a
replay. Everything captured runs on the current stream and reads nothing
back to the host; a capture that fails raises with the failing op's message,
and nothing falls back to eager dispatch.

A capture calls the kernels' wrappers, which count launches, but launches
nothing; a replay launches every captured kernel without calling them. So
each graph takes back what its capture counted and adds it once a replay
(``ops/_cuda.add_launches``): the counters keep counting launches.

``TrainGraph``'s single graph keeps the train step's phase marks at its
capture (``utils/profiling.phase``: the device nodes before synthesis,
forward, loss, backward and update, and in all) and publishes them as
``profiling.graph_phases("train")``; the other graphs mark nothing.
``TrainGraph.__call__`` runs each step in the span ``train.step`` (its id
the step) around ``train.reseed``, ``train.set_lr`` and ``train.replay``.

With a data mesh (``parallel/mesh.py``, one process a rank) a train step is
two captured graphs around one collective that the host calls between their
replays (no collective is captured): graph 1 draws this rank's rows from its
shard's stream (the host reseeds the generator with ``shard=rank``), runs
the forward, the loss and the backward into the graph's own
``train.GradBucket`` (every ``.grad`` a view into one flat buffer, zeroed
inside the graph) and puts the loss in it; the host all-reduces the bucket
(NCCL on its stream, or gloo on the CUDA tensor); graph 2 divides it by
``n_data``, clips and steps Adam. The same two graphs run under NCCL on
several cards and under gloo on one, and at world 1 they are bit-equal to
the single graph. A mesh's graphs are captured in the ``thread_local``
capture mode, so that the process group's own threads may query their
events while a capture is open. An evaluation graph with a mesh evaluates
this rank's rows of the global batch; the mean over the ranks is taken
after the pass (``train.pmean_validation``), outside it.

With a tensor-parallel model (``parallel/mesh.py``, ``n_model > 1``: the
front-end's rows split over the model group) the forward and the backward
hold the model group's collectives (``parallel/tensor.py``) and the clip
one more (its L1 total). The graphs capture them when
``Mesh.captures_collectives`` says a graph may: NCCL collectives on a model
group of one rank are captured into the graph (in the ``thread_local`` mode,
as above) and each replay runs them again on the same buffers; the data
group's all-reduce of the bucket stays between the two graphs, on the host.
gloo's collectives cannot be captured, and a captured step of a model group
of several NCCL ranks has not been seen to finish on the cards, so every
graph refuses such a model: ``train()`` then dispatches its steps op by op
(``train.eager_steps``), and a capture that fails still raises.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..data import synth_data
from ..models.st_model import STModel
from ..ops import _cuda
from ..utils import profiling
from . import train as train_mod


def _append(buffer: torch.Tensor, value: torch.Tensor) -> None:
    """Shift ``buffer`` down by one and put ``value`` last, on the card: after
    n replays its last n entries are theirs, oldest first."""
    buffer.copy_(torch.cat([buffer[1:], value.reshape(1).float()]))


def _capturable(model: STModel) -> None:
    """Refuse a tensor-parallel model whose collectives a graph may not hold
    (``Mesh.captures_collectives``)."""
    mesh = model.mesh
    if mesh is not None and not mesh.captures_collectives():
        raise ValueError("this model group's collectives are not captured in a CUDA graph "
                         "(gloo's cannot be; NCCL's only on a group of one rank): dispatch "
                         "the tensor-parallel step op by op (train.eager_steps)")


class _Graph:
    """``body()`` as one CUDA graph: the first call runs it on a side stream
    (the warm-up) and captures it; every later call replays it and adds its
    launch counts. ``generator`` is the one ``body`` draws from, if it draws;
    else ``device`` names the card. A graph given a ``name`` publishes its
    capture's phase marks under it (``profiling.graph_phases``)."""

    def __init__(self, body, generator: torch.Generator | None = None,
                 device: torch.device | None = None, capture_error_mode: str = "global",
                 name: str | None = None):
        dev = generator.device if generator is not None else torch.device(device)
        if dev.type != "cuda":
            what = "generator" if generator is not None else "device"
            raise ValueError(f"a CUDA graph needs a CUDA {what}, got one on {dev}")
        self.body = body
        self.generator = generator
        self.capture_error_mode = capture_error_mode
        self.device = dev
        self.name = name
        self.graph: torch.cuda.CUDAGraph | None = None
        self.counts: dict[str, int] = {}
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self) -> None:
        if self.graph is None:
            self._capture()
            return
        self.graph.replay()
        _cuda.add_launches(self.counts)
        self.replays += 1

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        _cuda.build()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.body()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        counted = _cuda.launch_counts()
        marks = (contextlib.nullcontext() if self.name is None
                 else profiling.GraphMarks(stream, self.name))
        with torch.cuda.graph(graph, stream=stream, capture_error_mode=self.capture_error_mode):
            with marks:
                self.body()
        now = _cuda.launch_counts()
        self.counts = {k: v - counted.get(k, 0) for k, v in now.items() if v != counted.get(k, 0)}
        _cuda.add_launches(self.counts, -1)  # the capture launched nothing
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


class _MeanUpdate:
    """Graph 2 of a data-parallel step (module docstring): the mean of the
    all-reduced bucket, its loss appended to ``losses``, the clip and Adam's
    step, as a graph of its own."""

    def __init__(self, model: STModel, opt: torch.optim.Optimizer, mesh, losses: torch.Tensor,
                 bucket: train_mod.GradBucket):
        self.model, self.opt, self.mesh, self.losses = model, opt, mesh, losses
        self.bucket = bucket
        self.graph = _Graph(self._body, device=losses.device, capture_error_mode="thread_local")

    def _body(self) -> None:
        _append(self.losses, self.bucket.mean(self.mesh.n_data))
        self.model.clip_grads()
        self.opt.step()

    def __call__(self) -> None:
        self.mesh.all_reduce(self.bucket.flat)
        self.graph()


class TrainGraph:
    """``model``'s train step as a CUDA graph: ``self(step0, n)`` runs steps
    step0 .. step0 + n - 1 (n <= capacity), each on the batch of
    ``synth_data.step_generator(generator, seed, step)`` at ``lr_fn(step)``,
    and returns their (n,) losses on the card, bit-equal to
    ``train.eager_steps`` with the same capturable optimizer. The first step
    run is the capture's warm-up, every later one a replay. ``batch`` is the
    last step's (x, y, knobs). With ``mesh`` each step is this rank's
    ``batch_size // n_data`` rows from ``step_generator(..., shard=rank)``
    and two graphs around the all-reduce (module docstring); the losses are
    the means over the ranks. With ``micro`` k > 1 (``train.microbatches``)
    the graph synthesizes the whole local batch and runs its forward and
    backward in k slices inside the one capture (``train.loss_and_grads``);
    with a mesh the slices' mean goes into the bucket before the all-reduce,
    JAX's order (slice mean, then ``pmean``)."""

    def __init__(self, model: STModel, opt: torch.optim.Optimizer, lr_fn, batch_fn,
                 batch_size: int, generator: torch.Generator, seed: int, capacity: int,
                 mesh=None, micro: int = 1):
        _capturable(model)
        self.model, self.opt, self.lr_fn, self.micro = model, opt, lr_fn, micro
        self.batch_fn, self.batch_size = batch_fn, batch_size
        self.generator, self.seed = generator, seed
        self.losses = torch.zeros(capacity, dtype=torch.float32, device=generator.device)
        self._batches = [None, None]  # the warm-up's batch, the captured one each replay fills
        self.shard, self.update = 0, None
        if mesh is None:
            self.graph = _Graph(self._body, generator, name="train")
        else:
            self.batch_size, self.shard = mesh.local_batch(batch_size), mesh.data_index
            self.bucket = train_mod.GradBucket(model)
            self.graph = _Graph(self._grads, generator, capture_error_mode="thread_local")
            self.update = _MeanUpdate(model, opt, mesh, self.losses, self.bucket)

    def _body(self) -> None:
        profiling.phase("synthesis")
        batch = self.batch_fn(self.batch_size, self.generator)
        _append(self.losses, train_mod.optimizer_step(self.model, self.opt, *batch,
                                                      micro=self.micro))
        self._batches[torch.cuda.is_current_stream_capturing()] = batch

    def _grads(self) -> None:
        profiling.phase("synthesis")
        batch = self.batch_fn(self.batch_size, self.generator)
        self.bucket.put_loss(train_mod.loss_and_grads(self.model, *batch, self.bucket,
                                                      self.micro))
        self._batches[torch.cuda.is_current_stream_capturing()] = batch

    @property
    def batch(self):
        return self._batches[self.graph.replays > 0]

    def __call__(self, step0: int, n: int) -> torch.Tensor:
        if not 1 <= n <= self.losses.numel():
            raise ValueError(f"TrainGraph: {n} steps, capacity {self.losses.numel()}")
        for step in range(step0, step0 + n):
            with profiling.span("train.step", step):
                with profiling.span("train.reseed"):
                    synth_data.step_generator(self.generator, self.seed, step, self.shard)
                with profiling.span("train.set_lr"):
                    train_mod.set_lr(self.opt, self.lr_fn(step))
                with profiling.span("train.replay"):
                    self.graph()
                    if self.update is not None:
                        self.update()
        return self.losses[-n:].clone()


class _EvalOutputs:
    """The losses and MAEs buffers of an evaluation graph (``self.graph``),
    and its last batch's outputs: the warm-up's, then the captured ones each
    replay fills."""

    def __init__(self, n_batches: int, device: torch.device):
        self.losses = torch.zeros(n_batches, dtype=torch.float32, device=device)
        self.maes = torch.zeros(n_batches, dtype=torch.float32, device=device)
        self._last = [None, None]

    def record(self, l, m, last) -> None:
        _append(self.losses, l)
        _append(self.maes, m)
        self._last[torch.cuda.is_current_stream_capturing()] = last

    @property
    def last(self):
        return self._last[self.graph.replays > 0]


class EvalGraph(_EvalOutputs):
    """The validation pass as a CUDA graph of one batch: ``self()`` runs it
    on the frozen batches 0 .. n_batches - 1
    (``synth_data.val_step_generator``) and returns (losses, maes, last):
    the losses and MAEs, each (n_batches,) on the card, equal to
    ``train.eager_validation``'s, and ``last``, the last batch's (x, y,
    knobs, y_hat, mag, mag_hat), the graph's own outputs (the next replay
    overwrites them). The first batch run is the capture's warm-up, in the
    model's mode then, every later one a replay."""

    def __init__(self, model: STModel, val_batch_fn, batch_size: int,
                 generator: torch.Generator, n_batches: int, mesh=None):
        _capturable(model)
        super().__init__(n_batches, generator.device)
        self.model, self.val_batch_fn, self.batch_size = model, val_batch_fn, batch_size
        self.generator, self.n_batches, self.mesh = generator, n_batches, mesh
        self.rows = slice(None) if mesh is None else mesh.local_rows(batch_size)
        self.graph = _Graph(self._body, generator,
                            capture_error_mode="global" if mesh is None else "thread_local")

    def _body(self) -> None:
        x, y, knobs = self.val_batch_fn(self.batch_size, self.generator)
        r = self.rows
        self.record(*train_mod.eval_step_from_arrays(self.model, x[r], y[r], knobs[r]))

    def __call__(self) -> tuple[torch.Tensor, torch.Tensor, tuple]:
        for v in range(self.n_batches):
            synth_data.val_step_generator(self.generator, v)
            self.graph()
        return *train_mod.pmean_validation(self.mesh, self.losses.clone(), self.maes.clone()), \
            self.last


class ArraysTrainGraph:
    """``model``'s train step on given batches as a CUDA graph (the
    counterpart of ``make_train_step_from_arrays``): ``self(step0, n)`` runs
    steps step0 .. step0 + n - 1 at ``lr_fn(step)``, each on the batch
    ``next_batch()`` returns (a ``file_data.HostBatch``, copied into the
    graph's static buffers on the current stream and its slot given back),
    and returns their (n,) losses on the card, bit-equal to
    ``train.host_steps`` on the same batches. ``shapes`` are those of (x, y,
    knobs). The first step run is the capture's warm-up. With ``mesh`` the
    batches are this rank's rows (``shapes`` are theirs) and each step is two
    graphs around the all-reduce, as ``TrainGraph``'s. Its step is never
    sliced (``ST_TPU_MICROBATCH`` does not reach it): the JAX package's
    host-fed step, ``make_train_step_from_arrays``, takes the whole batch."""

    def __init__(self, model: STModel, opt: torch.optim.Optimizer, lr_fn, next_batch, shapes,
                 capacity: int, mesh=None):
        _capturable(model)
        dev = next(model.parameters()).device
        self.model, self.opt, self.lr_fn, self.next_batch = model, opt, lr_fn, next_batch
        self.buffers = tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes)
        self.losses = torch.zeros(capacity, dtype=torch.float32, device=dev)
        self.update = None
        if mesh is None:
            self.graph = _Graph(self._body, device=dev)
        else:
            self.bucket = train_mod.GradBucket(model)
            self.graph = _Graph(self._grads, device=dev, capture_error_mode="thread_local")
            self.update = _MeanUpdate(model, opt, mesh, self.losses, self.bucket)

    def _body(self) -> None:
        _append(self.losses, train_mod.optimizer_step(self.model, self.opt, *self.buffers))

    def _grads(self) -> None:
        self.bucket.put_loss(train_mod.loss_and_grads(self.model, *self.buffers, self.bucket))

    def __call__(self, step0: int, n: int) -> torch.Tensor:
        if not 1 <= n <= self.losses.numel():
            raise ValueError(f"ArraysTrainGraph: {n} steps, capacity {self.losses.numel()}")
        for step in range(step0, step0 + n):
            self.next_batch().copy_into(self.buffers)
            train_mod.set_lr(self.opt, self.lr_fn(step))
            self.graph()
            if self.update is not None:
                self.update()
        return self.losses[-n:].clone()


class ArraysEvalGraph(_EvalOutputs):
    """One validation batch on given arrays as a CUDA graph (the counterpart
    of ``make_eval_step_from_arrays``): ``self(batches)`` runs it on each
    numpy (x, y, knobs) of ``batches`` (n_batches of them, copied into the
    static buffers) and returns (losses, maes, last) as ``EvalGraph`` does,
    equal to ``train.host_validation``'s. With ``mesh`` the batches are this
    rank's rows and the figures are averaged over the ranks after the pass."""

    def __init__(self, model: STModel, shapes, n_batches: int, mesh=None):
        _capturable(model)
        dev = next(model.parameters()).device
        super().__init__(n_batches, dev)
        self.model, self.n_batches, self.mesh = model, n_batches, mesh
        self.buffers = tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in shapes)
        self.graph = _Graph(self._body, device=dev,
                            capture_error_mode="global" if mesh is None else "thread_local")

    def _body(self) -> None:
        self.record(*train_mod.eval_step_from_arrays(self.model, *self.buffers))

    def __call__(self, batches) -> tuple[torch.Tensor, torch.Tensor, tuple]:
        count = 0
        for arrays in batches:
            for buf, a in zip(self.buffers, arrays):
                buf.copy_(torch.from_numpy(a))
            self.graph()
            count += 1
        if count != self.n_batches:
            raise ValueError(f"ArraysEvalGraph: {count} batches, built for {self.n_batches}")
        return *train_mod.pmean_validation(self.mesh, self.losses.clone(), self.maes.clone()), \
            self.last
