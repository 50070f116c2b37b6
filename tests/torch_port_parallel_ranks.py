"""What each rank runs for tests/test_torch_port_parallel.py.

``parallel/launch.spawn`` pickles a rank's function by name, so these live
at module level, in a module that imports neither JAX nor the test module:
a spawned rank imports this file, torch and the port, nothing more. Each
function returns numpy arrays and plain values for the test to hold against
the oracle and the JAX package.
"""

import os
import time

import torch

from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models import st_model
from signaltrain_tpu_torch.training import train as train_mod

# the JAX package's multi-chip test geometry (tests/test_multichip_oracle.py)
TINY = dict(scale_factor=512 / 8192.0, shrink_factor=4.0, num_knobs=4, sr=44100,
            in_chunk_size=512, out_chunk_size=128, ft_size=64, hop_size=24, time_frames=25,
            output_time_frames=9)
BATCH = 16
DP_SEED = 3
DP_STEPS = 3
MICRO = 2  # ST_TPU_MICROBATCH's slices in the microbatched steps
OPT = dict(lr_max=1e-4, n_data_points=256, epochs=2, batch_size=BATCH)
# the arrays step: tests/test_torch_port_train.py's five steps
ARRAYS_OPT = dict(lr_max=2e-4, n_data_points=40, epochs=1, batch_size=8)
# train() at world N: one epoch of two steps of 8, one validation batch
TRAIN_KW = dict(epochs=1, n_data_points=16, batch_size=8, scale_factor=0.0625, lr_max=2e-4,
                seed=5, make_plots=False, device="cpu", compute_dtype=torch.float32,
                status_every=1)


def tiny_model(state_dict=None):
    """The tiny model on the CPU: seeded weights, or ``state_dict``'s."""
    model = st_model.STModel(st_model.ModelSpec(**TINY), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    return model.train()


def dp_setup():
    """(model, optimizer, lr_fn, batch_fn) of the data-parallel steps."""
    model = tiny_model()
    opt, lr_fn = train_mod.make_optimizer(model, **OPT)
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              TINY["in_chunk_size"], TINY["out_chunk_size"])
    return model, opt, lr_fn, batch_fn


def params_of(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def dp_steps(mesh, micro: int = 1) -> dict:
    """DP_STEPS eager data-parallel steps at global batch BATCH, each
    rank's rows in ``micro`` slices."""
    model, opt, lr_fn, batch_fn = dp_setup()
    losses = train_mod.eager_steps(model, opt, lr_fn, batch_fn, BATCH, torch.Generator(),
                                   DP_SEED, 0, DP_STEPS, mesh=mesh, micro=micro)
    return {"losses": losses, "params": params_of(model)}


def arrays_steps(mesh, state_dict, batches) -> dict:
    """The arrays-fed step on this rank's rows of each numpy (x, y, knobs)."""
    model = tiny_model(state_dict)
    opt, lr_fn = train_mod.make_optimizer(model, **ARRAYS_OPT)
    rows = mesh.local_rows(ARRAYS_OPT["batch_size"])
    losses = [train_mod.train_step_from_arrays(
        model, opt, lr_fn, step, *(torch.from_numpy(a[rows]) for a in batch), mesh=mesh)
        for step, batch in enumerate(batches)]
    return {"losses": torch.stack(losses), "params": params_of(model)}


def predict(mesh, state_dict, signal, knobs):
    return pl.predict_long(signal, knobs, tiny_model(state_dict).eval(), mesh=mesh)


def train_world(mesh, workdir: str, in_checkpointname: str = "modelcheckpoint.tar") -> dict:
    """train() as one rank, in a directory of the rank's own: its history,
    its final weights and the files it wrote."""
    os.chdir(workdir)
    here = os.path.join(workdir, f"rank{mesh.rank}")
    os.makedirs(here)
    os.chdir(here)
    model, hist = train_mod.train(effects.make_effect("comp_4c", device="cpu"),
                                  in_checkpointname=in_checkpointname, **TRAIN_KW)
    return {"hist": hist, "params": params_of(model), "files": sorted(os.listdir(here))}


def two_ranks(mesh, state_dict, signal, knobs, workdir, done: str) -> dict:
    """Rank 0 touches ``done`` once train()'s checkpoint is written; then
    the microbatched steps at 2 x 1 and, on a mesh of the same world that
    splits the front-end, at 1 x 2."""
    from signaltrain_tpu_torch.parallel import mesh as meshlib
    from tests import torch_port_tp_ranks as tp_ranks

    out = {"dp": dp_steps(mesh), "predict": predict(mesh, state_dict, signal, knobs),
           "train": train_world(mesh, workdir)}
    if mesh.rank == 0:
        open(done, "w").close()
    out["micro"] = {"2x1": dp_steps(mesh, MICRO),
                    "1x2": tp_ranks.tp_steps(meshlib.make_mesh(n_model=2, device="cpu"), MICRO)}
    return out


def four_ranks(mesh, state_dict, batches, checkpoint, workdir, done: str,
               wait_s: float = 120.0) -> dict:
    """The 2-rank run may still be training when these start: the resume
    waits for its ``done`` file."""
    out = {"dp": dp_steps(mesh), "arrays": arrays_steps(mesh, state_dict, batches)}
    deadline = time.monotonic() + wait_s
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {done} after {wait_s} s: the 2-rank run did not finish")
        time.sleep(0.1)
    out["resume"] = train_world(mesh, workdir, in_checkpointname=checkpoint)
    return out
