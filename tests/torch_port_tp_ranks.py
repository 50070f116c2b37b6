"""What each rank runs for tests/test_torch_port_tensor_parallel.py.

``parallel/launch.spawn`` pickles a rank's function by name, so these live
at module level, in a module that imports neither JAX nor the test module.
One spawn of four gloo CPU ranks runs ``four_ranks``, which builds each mesh
shape the test needs over the same world (2 x 2, 1 x 4, 4 x 1) and returns
numpy arrays and plain values for the test to hold against the oracle, the
unsharded port and the JAX package.
"""

import os
import time

import torch
import torch.distributed as dist

from signaltrain_tpu_torch.parallel import mesh as meshlib
from signaltrain_tpu_torch.parallel import tensor as tp
from signaltrain_tpu_torch.training import checkpoint
from signaltrain_tpu_torch.training import train as train_mod
from tests import torch_port_parallel_ranks as dp

STEPS = 3  # dp x tp steps against the oracle
# train() at 2 x 2 (it writes the checkpoint), resumed at 4 x 1 and 1 x 4:
# one epoch of two steps of 8, one validation batch
TRAIN_KW = dict(dp.TRAIN_KW)


def tp_model(mesh, state_dict=None):
    """The tiny model on ``mesh``'s model group: seeded, or ``state_dict``'s
    whole weights, of which it keeps its rows."""
    from signaltrain_tpu_torch.models import st_model

    model = st_model.STModel(st_model.ModelSpec(**dp.TINY), device="cpu", mesh=mesh,
                             generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        model.load_state_dict(checkpoint.shard_state_dict(model, sd), strict=True)
    return model.train()


def whole(model, opt=None) -> dict:
    """The gathered weights (and Adam's moments), as the checkpoint holds them."""
    return checkpoint.training_tensors(model, opt)


def replicated(model) -> dict:
    """The parameters every model rank holds whole: the autoencoders'."""
    return {k: v.detach().clone() for k, v in model.named_parameters() if "dft_" not in k}


def forward(mesh, state_dict, x, knobs) -> dict:
    """The model on ``mesh`` over the whole batch (each data group a 1 x
    n_model run) and over this data index's rows."""
    model = tp_model(mesh, state_dict).eval()
    rows = mesh.local_rows(x.shape[0])
    with torch.no_grad():
        whole_batch = model(torch.from_numpy(x), torch.from_numpy(knobs))
        own = model(torch.from_numpy(x[rows]), torch.from_numpy(knobs[rows]))
    return {"whole": whole_batch, "rows": own}


def tp_steps(mesh, micro: int = 1) -> dict:
    """STEPS eager dp x tp steps at global batch dp.BATCH from the seeded
    weights, as ``tests/torch_port_parallel_ranks.dp_steps`` takes them,
    each data index's rows in ``micro`` slices."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects

    model = tp_model(mesh)
    opt, lr_fn = train_mod.make_optimizer(model, **dp.OPT)
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              dp.TINY["in_chunk_size"], dp.TINY["out_chunk_size"])
    losses = train_mod.eager_steps(model, opt, lr_fn, batch_fn, dp.BATCH, torch.Generator(),
                                   dp.DP_SEED, 0, STEPS, mesh=mesh, micro=micro)
    params = dict(model.named_parameters())
    rows = {k: (params[k].shape[0], params[k].grad.shape[0], opt.state[params[k]]["exp_avg"].shape[0],
                opt.state[params[k]]["exp_avg_sq"].shape[0]) for k in train_mod.FRONTEND_PARAMS}
    return {"losses": losses, "state": whole(model, opt), "replicated": replicated(model),
            "shard_rows": rows}


def arrays_steps(mesh, state_dict, batches) -> dict:
    """The arrays-fed step of a tp model on this data index's rows."""
    model = tp_model(mesh, state_dict)
    opt, lr_fn = train_mod.make_optimizer(model, **dp.ARRAYS_OPT)
    rows = mesh.local_rows(dp.ARRAYS_OPT["batch_size"])
    losses = [train_mod.train_step_from_arrays(
        model, opt, lr_fn, step, *(torch.from_numpy(a[rows]) for a in batch), mesh=mesh)
        for step, batch in enumerate(batches)]
    return {"losses": torch.stack(losses), "params": whole(model)["state_dict"]}


def clip(mesh, state_dict, grads) -> dict:
    """The front-end clip of a tp model whose gradients are its rows of
    ``grads`` (whole matrices), gathered after it."""
    model = tp_model(mesh, state_dict)
    sharded = checkpoint.shard_state_dict(model, {k: torch.from_numpy(v) for k, v in grads.items()})
    for name, p in model.named_parameters():
        p.grad = sharded[name].clone() if name in sharded else torch.zeros_like(p)
    total = train_mod.clip_frontend_grads(model)
    shards = checkpoint.frontend_shards(model)
    params = dict(model.named_parameters())
    return {"total": total, "grads": {k: tp.gather_rows(params[k].grad, s)
                                      for k, s in shards.items()}}


def train_at(n_model: int, workdir: str, in_checkpointname: str = "modelcheckpoint.tar") -> dict:
    """train() over the world at n_model, in a directory of the rank's own."""
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.parallel import distributed

    here = os.path.join(workdir, f"rank{distributed.rank()}")
    os.makedirs(here)
    cwd = os.getcwd()
    os.chdir(here)
    try:
        model, hist = train_mod.train(effects.make_effect("comp_4c", device="cpu"),
                                      in_checkpointname=in_checkpointname, n_model=n_model,
                                      **TRAIN_KW)
    finally:
        os.chdir(cwd)
    return {"hist": hist, "state": whole(model)["state_dict"], "files": sorted(os.listdir(here))}


def four_ranks(mesh, state_dict, x, knobs, batches, grads, workdir: str) -> dict:
    """Every case of the test, over one world of four ranks."""
    t0 = time.perf_counter()
    m22 = meshlib.make_mesh(n_model=2, device="cpu")
    m14 = meshlib.make_mesh(n_model=4, device="cpu")
    out = {"forward": forward(m22, state_dict, x, knobs),
           "steps": {"2x2": tp_steps(m22), "1x4": tp_steps(m14)},
           "arrays": arrays_steps(m22, state_dict, batches),
           "clip": clip(m22, state_dict, grads)}
    out["controls"] = {}
    for name in ("gather_sums", "input_not_summed"):
        with tp.scale_control(name):
            out["controls"][name] = tp_steps(m22)
    ckpt = os.path.join(workdir, "2x2", "rank0", "modelcheckpoint.tar")
    out["train"] = {"2x2": train_at(2, os.path.join(workdir, "2x2"))}
    dist.barrier()  # rank 0's checkpoint is written
    for name, n_model in (("4x1", 1), ("1x4", 4)):
        out["train"][name] = train_at(n_model, os.path.join(workdir, name), ckpt)
    out["seconds"] = time.perf_counter() - t0
    return out


def nccl_world_one(mesh, steps: int = 5) -> dict:
    """On a card, in a world of one under NCCL: the tiny model's bf16 train
    graph on the gemm front-end without a mesh, and with the front-end split
    over the mesh's model group of one (its collectives captured): their
    losses, weights and Adam moments, compared bit for bit."""
    from signaltrain_tpu_torch.data import synth_data
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models import st_model
    from signaltrain_tpu_torch.training import graphs

    dev = mesh.device
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device=dev),
                                              dp.TINY["in_chunk_size"], dp.TINY["out_chunk_size"])
    runs = []
    for m in (None, mesh):
        model = st_model.STModel(st_model.ModelSpec(**dp.TINY), frontend="gemm", device=dev,
                                 generator=torch.Generator().manual_seed(0),
                                 compute_dtype=torch.bfloat16, mesh=m).train()
        opt, lr_fn = train_mod.make_optimizer(model, **dp.OPT)
        g = graphs.TrainGraph(model, opt, lr_fn, batch_fn, dp.BATCH, torch.Generator(device=dev),
                              dp.DP_SEED, capacity=steps, mesh=m)
        runs.append((g(0, steps), whole(model, opt), g.graph.replays))
    (l0, s0, _), (l1, s1, replays) = runs
    return {"losses_equal": torch.equal(l0, l1), "replays": replays,
            "state_equal": {k: all(torch.equal(v, s1[k][n]) for n, v in d.items())
                            for k, d in s0.items()}}
