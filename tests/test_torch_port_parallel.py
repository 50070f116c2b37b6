"""Data parallelism of the port on the CPU, under gloo, against the
single-process oracle and the JAX package's ``'data'`` mesh.

Ranks are spawned processes (``parallel/launch.spawn``, a ``file://`` store
under the test's temporary directory, so no port is shared between workers)
running the functions of ``tests/torch_port_parallel_ranks.py``; one spawn
of 2 ranks and one of 4, started together, serve every case through one
module fixture. World 1 runs in this process, in a gloo group of one.

* (a) 3 data-parallel steps on 2 and 4 ranks (global batch 16) against
  ``training/oracle.oracle_steps``: the weights within the JAX test's ``atol
  2e-6`` / ``rtol 2e-5`` (tests/test_multichip_oracle.py:41-42), the losses
  within ``rtol 1e-5``; every rank holds the same weights, bit for bit.
* (b) the control: the oracle with ``reduce="sum"`` (the shards' gradients
  added, not averaged) fails (a) (tests/test_multichip_oracle.py:130).
* (c) world 1 (a gloo group of one) bit-equal to the steps and the
  validation without a mesh, and to the oracle at one shard; so are the
  facade's ``make_train_step`` / ``make_eval_step`` with that mesh.
* (d) ``step_generator``: shard 0 is the single-process stream; shards are
  pairwise distinct.
* (e) the arrays-fed step on 4 ranks against the JAX
  ``make_train_step_from_arrays`` on a 4-way ``'data'`` mesh of the virtual
  CPU devices, on the same numpy batches from the same weights: the loss
  within ``rtol 1e-4`` a step, the weights within ``atol 1e-5`` after 5
  steps (tests/test_torch_port_train.py's constants).
* (f) ``predict_long(mesh=)`` on 2 ranks against one process within ``atol
  2e-5`` (tests/test_predict_long_parity.py:88), and against the JAX
  ``predict_long(mesh=)`` within the model-output tolerance 1e-3.
* (g) ``train()``'s checkpoint saved at world 2, resumed at world 1 and at
  world 4: its next steps against the oracle at the new world.
* (h) at world 2 only rank 0 writes, and every rank returns one history.
* (i) ``host_batch(rows=)`` over the ranks' rows is the global batch.
* (k) ``ST_TPU_MICROBATCH``: 3 steps of the 2 ranks with each rank's rows in
  2 slices, at 2 x 1 and at 1 x 2 (the front-end split over both ranks),
  against ``oracle_steps(..., micro=2)`` with the (a) limits (at 1 x 2 over
  the weights and Adam's moments, ``oracle.state_excess``).
* (j) a mesh must tile the world: ``make_mesh``, ``RunConfig`` and
  ``run_train --nmodel`` refuse a world that is not ``n_data x n_model``
  (tensor parallelism itself: tests/test_torch_port_tensor_parallel.py).
* ``cli.run_train --nproc 2 --device cpu`` and the same CLI under torchrun
  (``python -m torch.distributed.run --standalone --nproc_per_node 2``),
  run beside the spawns: each trains one world of 2, and only rank 0 prints
  and writes.
"""

import concurrent.futures
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.inference import predict_long as jpl
from signaltrain_tpu.parallel import mesh as jmeshlib
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch import config
from signaltrain_tpu_torch.cli import run_train
from signaltrain_tpu_torch.data import file_data, synth_data
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.inference import predict_long as pl
from signaltrain_tpu_torch.models.st_model import st_model
from signaltrain_tpu_torch.parallel import distributed, launch
from signaltrain_tpu_torch.parallel import mesh as meshlib
from signaltrain_tpu_torch.training import checkpoint, oracle
from signaltrain_tpu_torch.training import train as train_mod
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_file_data import write_dataset
from tests.torch_port_util import jax_params, model_inputs, n, tiny_spec

ATOL, RTOL = 2e-6, 2e-5
SPAWN_LIMIT_S = 300.0
REPO = Path(__file__).resolve().parent.parent
CLI_ARGS = ["-m", "signaltrain_tpu_torch.cli.run_train", "--epochs", "1", "-n", "16", "-b", "8",
            "--scale", "0.0625", "--dtype", "float32", "--lrmax", "2e-4", "--device", "cpu"]
LAUNCHES = {"nproc": [*CLI_ARGS, "--nproc", "2"],
            "torchrun": ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                         *CLI_ARGS]}


@pytest.fixture(scope="module")
def weights():
    """(JAX model, its parameters, the same as a numpy state dict)."""
    jm, params = jax_params(tiny_spec(), seed=11)
    sd = {k: v.numpy() for k, v in checkpoint.params_to_state_dict(params).items()}
    return jm, params, sd


@pytest.fixture(scope="module")
def signal():
    rs = np.random.RandomState(3)
    return (rs.randn(9100) * 0.3).astype(np.float32), (rs.rand(4) - 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def arrays_batches():
    spec, b = tiny_spec(), ranks.ARRAYS_OPT["batch_size"]
    out = []
    for step in range(5):
        x, knobs = model_inputs(spec, b, seed=20 + step)
        y = (np.random.default_rng(40 + step).normal(size=(b, spec.out_chunk_size)) * 0.3)
        out.append((x, y.astype(np.float32), knobs))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, weights, signal, arrays_batches):
    """The 2-rank spawn (the DP steps, predict_long, train()) and the 4-rank
    one (the DP steps, the arrays step, train() resumed from the 2-rank
    run's checkpoint), run at once: {"two": results, "four": results,
    "world2": the directory whose rank0/ holds the checkpoint}."""
    world2, world4 = tmp_path_factory.mktemp("world2"), tmp_path_factory.mktemp("world4")
    ckpt, done = str(world2 / "rank0" / "modelcheckpoint.tar"), str(world2 / "done")
    path = os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, ST_TPU_TIMING="1")  # the CLIs time their epochs
    clis = {}
    for name, argv in LAUNCHES.items():
        cwd = tmp_path_factory.mktemp(name)
        clis[name] = (cwd, subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, text=True,
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            four = pool.submit(launch.spawn, ranks.four_ranks, ["cpu"] * 4, "gloo",
                               args=(weights[2], arrays_batches, ckpt, str(world4), done),
                               timeout_s=SPAWN_LIMIT_S)
            two = launch.spawn(ranks.two_ranks, ["cpu"] * 2, "gloo",
                               args=(weights[2], *signal, str(world2), done),
                               timeout_s=SPAWN_LIMIT_S)
            out = {"two": two, "four": four.result(), "world2": world2}
        for name, (cwd, proc) in clis.items():
            stdout, stderr = proc.communicate(timeout=SPAWN_LIMIT_S)
            out[name] = (cwd, proc.returncode, stdout, stderr)
        return out
    finally:
        for _, proc in clis.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@contextlib.contextmanager
def world_one(tmp_path):
    """A gloo process group of one (this process) and its mesh."""
    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0, "gloo", "cpu")
    try:
        yield meshlib.make_mesh(device="cpu")
    finally:
        distributed.shutdown()


def assert_params_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def run_oracle(n_data: int):
    model, opt, lr_fn, batch_fn = ranks.dp_setup()
    losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, ranks.BATCH, n_data,
                                 torch.Generator(), ranks.DP_SEED, 0, ranks.DP_STEPS)
    return n(losses), ranks.params_of(model)


# ------------------------------------------------------------- (a), (b), (c)

@pytest.mark.parametrize("world", [2, 4])
def test_dp_steps_match_the_single_process_oracle(world, spawned):
    res = spawned["two"] if world == 2 else spawned["four"]
    losses, params = run_oracle(world)
    for r in res:
        np.testing.assert_allclose(r["dp"]["losses"], losses, rtol=1e-5)
        assert_params_close(r["dp"]["params"], params)
        for k, v in r["dp"]["params"].items():  # one replicated model
            np.testing.assert_array_equal(v, res[0]["dp"]["params"][k])
    assert oracle.max_param_delta(res[0]["dp"]["params"], params) <= ATOL


def test_an_oracle_that_sums_the_shards_fails_the_check(spawned):
    model, opt, lr_fn, batch_fn = ranks.dp_setup()
    oracle.oracle_steps(model, opt, lr_fn, batch_fn, ranks.BATCH, 2, torch.Generator(),
                        ranks.DP_SEED, 0, ranks.DP_STEPS, reduce="sum")
    with pytest.raises(AssertionError):
        assert_params_close(spawned["two"][0]["dp"]["params"], ranks.params_of(model))
    assert oracle.excess(spawned["two"][0]["dp"]["params"], ranks.params_of(model)) > 1.0


@pytest.mark.parametrize("mesh_shape", ["2x1", "1x2"])
def test_microbatched_steps_match_the_microbatched_oracle(mesh_shape, spawned):
    n_data = 2 if mesh_shape == "2x1" else 1
    model, opt, lr_fn, batch_fn = ranks.dp_setup()
    if mesh_shape == "1x2":  # the ranks' front-end
        model.mpaec.frontend = "gemm"
    losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, ranks.BATCH, n_data,
                                 torch.Generator(), ranks.DP_SEED, 0, ranks.DP_STEPS,
                                 micro=ranks.MICRO)
    for r in spawned["two"]:
        got = r["micro"][mesh_shape]
        np.testing.assert_allclose(got["losses"], n(losses), rtol=1e-5)
        if mesh_shape == "2x1":
            assert_params_close(got["params"], ranks.params_of(model))
        else:
            assert oracle.state_excess(got["state"],
                                       checkpoint.training_tensors(model, opt)) <= 1.0


def test_world_one_is_bit_equal_to_the_single_process_path(tmp_path):
    val_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"), 512, 128,
                                            augment=False)

    def run(mesh):
        model, opt, lr_fn, batch_fn = ranks.dp_setup()
        losses = train_mod.eager_steps(model, opt, lr_fn, batch_fn, ranks.BATCH, torch.Generator(),
                                       ranks.DP_SEED, 0, ranks.DP_STEPS, mesh=mesh)
        val = train_mod.eager_validation(model.eval(), val_fn, ranks.BATCH, torch.Generator(), 2,
                                         mesh=mesh)
        return losses, val, model, opt

    want = run(None)
    with world_one(tmp_path) as mesh:
        assert (mesh.n_data, mesh.rank, mesh.local_rows(ranks.BATCH)) == (1, 0, slice(0, 16))
        got = run(mesh)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1][:2] + got[1][2], want[1][:2] + want[1][2]):
        assert torch.equal(a, b)
    for (name, p), q in zip(got[2].named_parameters(), want[2].parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[3].state[p][key], want[3].state[q][key]), (name, key)
    o_losses, o_params = run_oracle(1)
    assert np.array_equal(o_losses, n(want[0]))
    assert oracle.max_param_delta(o_params, want[2]) == 0.0


def test_the_facade_step_builders_take_a_mesh(tmp_path):
    """st.train.make_train_step / make_eval_step with a world-1 mesh give
    the steps without one, bit for bit."""
    import signaltrain_tpu_torch as st

    val_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"), 512, 128,
                                            augment=False)

    def run(mesh):
        model, opt, lr_fn, batch_fn = ranks.dp_setup()
        kw = {} if mesh is None else {"mesh": mesh}
        step = st.train.make_train_step(model, (opt, lr_fn), batch_fn, ranks.BATCH,
                                        seed=ranks.DP_SEED, **kw)
        losses = [step(s) for s in range(2)]
        evaluate = st.train.make_eval_step(model.eval(), val_fn, ranks.BATCH, **kw)
        return losses + list(evaluate(0)[:2]), ranks.params_of(model)

    want = run(None)
    with world_one(tmp_path) as mesh:
        got = run(mesh)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(torch.equal(got[1][k], v) for k, v in want[1].items())


# -------------------------------------------------------------------- (d)

def test_shard_streams():
    g = torch.Generator()
    for seed, step in [(218, 0), (218, 7), (0x7FFFFFFF, 2**32 - 1)]:
        synth_data.step_generator(g, seed, step)  # the single-process stream
        assert g.initial_seed() == ((seed & 0x7FFFFFFF) << 32) + step < 2**63
        a = torch.rand(8, generator=g)
        synth_data.step_generator(g, seed, step, shard=0)
        assert torch.equal(torch.rand(8, generator=g), a)
    seeds = {}
    for shard in range(6):
        for step in list(range(40)) + [2**32 - 1]:
            seeds[(shard, step)] = synth_data.step_generator(g, 218, step, shard).initial_seed()
            assert (seeds[(shard, step)] >= 2**63) == (shard > 0)
    assert len(set(seeds.values())) == len(seeds)
    draws = [torch.rand(64, generator=synth_data.step_generator(g, 218, 3, s)) for s in range(4)]
    assert all(not torch.equal(a, b) for i, a in enumerate(draws) for b in draws[i + 1:])


# -------------------------------------------------------------------- (e)

def test_four_rank_arrays_step_matches_the_jax_data_mesh(spawned, weights, arrays_batches):
    jm, params, _ = weights
    tx, _ = jtrain.make_optimizer(**ranks.ARRAYS_OPT)
    jmesh = jmeshlib.make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    jstep = jtrain.make_train_step_from_arrays(jm, tx, mesh=jmesh)
    jp = jax.device_put(jax.tree_util.tree_map(jnp.copy, params), jmeshlib.replicated(jmesh))
    jopt = tx.init(jp)
    for step, (x, y, knobs) in enumerate(arrays_batches):
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(knobs))
        for r in spawned["four"]:
            np.testing.assert_allclose(r["arrays"]["losses"][step], float(jl), rtol=1e-4,
                                       err_msg=f"step {step}")
    want = checkpoint.params_to_state_dict(jax.device_get(jp))
    for r in spawned["four"]:
        for name, v in r["arrays"]["params"].items():
            np.testing.assert_allclose(v, n(want[name]), atol=1e-5, err_msg=name)


# -------------------------------------------------------------------- (f)

def test_predict_long_split_over_ranks(spawned, weights, signal):
    jm, params, sd = weights
    x, knobs = signal
    whole = pl.predict_long(x, knobs, ranks.tiny_model(sd).eval())
    assert pl._num_windows(len(x), 512, 384) % 2 == 1  # a pad window on the 2 ranks
    for r in spawned["two"]:
        assert r["predict"].shape == whole.shape == (len(x) - 384,)
        np.testing.assert_allclose(r["predict"], whole, atol=2e-5)
    jmesh = jmeshlib.make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    want = jpl.predict_long(x, knobs, jm, params, mesh=jmesh)
    assert want.shape == whole.shape
    np.testing.assert_allclose(spawned["two"][0]["predict"], want, atol=1e-3)


# --------------------------------------------------------------- (g), (h)

@pytest.mark.parametrize("world", [1, 4])
def test_a_world_two_checkpoint_resumes_at_another_world(world, spawned, tmp_path, monkeypatch):
    ckpt = str(spawned["world2"] / "rank0" / "modelcheckpoint.tar")
    if world == 4:
        got = spawned["four"][0]["resume"]
    else:
        monkeypatch.chdir(tmp_path)
        with world_one(tmp_path) as mesh:
            got = ranks.train_world(mesh, str(tmp_path), in_checkpointname=ckpt)
    # the oracle: the checkpoint's weights and Adam state, its next steps on `world` shards
    kw = ranks.TRAIN_KW
    state, rv = checkpoint.load_checkpoint(ckpt)
    assert rv["optax_step"] == 2
    model = st_model(scale_factor=kw["scale_factor"], device="cpu").train()
    model.load_state_dict(state, strict=True)
    opt, lr_fn = train_mod.make_optimizer(model, kw["lr_max"], kw["n_data_points"], kw["epochs"],
                                          kw["batch_size"])
    checkpoint.restore_optimizer(model, opt, rv["optax_state"], rv["optax_step"])
    spec = model.spec
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              spec.in_chunk_size, spec.out_chunk_size)
    losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, kw["batch_size"], world,
                                 torch.Generator(), kw["seed"], 2, 2)
    assert got["hist"]["step"] == 4
    np.testing.assert_allclose(got["hist"]["train_loss"], n(losses), rtol=1e-5)
    assert_params_close(got["params"], ranks.params_of(model))


def test_only_rank_zero_writes(spawned):
    res, workdir = spawned["two"], spawned["world2"]
    assert res[0]["train"]["files"] == ["modelcheckpoint.tar", "val_err_mae.dat",
                                        "vl_avg_out.dat"]
    assert res[1]["train"]["files"] == []
    assert res[0]["train"]["hist"] == res[1]["train"]["hist"]
    hist = res[0]["train"]["hist"]
    assert len(hist["train_loss"]) == 2 and hist["step"] == 2
    line = open(workdir / "rank0" / "val_err_mae.dat").read().split()
    assert line == ["1", f"{hist['val_mae'][0]:.3e}", f"{hist['val_mae_mean'][0]:.3e}"]


# -------------------------------------------------------------- (i), (j)

def test_host_batch_rows_make_up_the_global_batch(tmp_path):
    path = os.path.join(write_dataset(tmp_path), "Train")
    ds = file_data.FileDataset(path, effects.Compressor_4c(device="cpu"), 512, 128,
                               device_resident_limit_bytes=1)
    assert not ds.device_resident
    rng = np.random.default_rng(5)
    want = [ds.host_batch(8, rng) for _ in range(3)]
    for world in (2, 4):
        parts = []
        for r in range(world):
            rng = np.random.default_rng(5)
            rows = slice(r * 8 // world, (r + 1) * 8 // world)
            parts.append([ds.host_batch(8, rng, rows=rows) for _ in range(3)])
        for b in range(3):
            for a in range(3):
                np.testing.assert_array_equal(np.concatenate([p[b][a] for p in parts]), want[b][a])
    pf = ds.prefetch_batches(8, np.random.default_rng(5), rows=slice(4, 8))
    try:
        for b in range(3):
            for got, w in zip(pf.next().take("cpu"), want[b]):
                np.testing.assert_array_equal(n(got), w[4:8])
    finally:
        pf.close()


def test_meshes_must_tile_the_world_and_batches_must_divide(capsys):
    with pytest.raises(SystemExit) as e:  # one process is no world of n_data x 2
        run_train.main(["--nmodel", "2", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "--nmodel 2: a world of 1 ranks is not n_data x 2" in out
    with pytest.raises(ValueError, match="not n_data x 2"):
        meshlib.make_mesh(n_model=2, device="cpu")
    with pytest.raises(ValueError, match="not n_data x 2"):
        config.RunConfig(n_model=2)
    with pytest.raises(ValueError, match="not n_data x 3"):
        config.RunConfig(n_model=3, nproc=4)
    mesh = meshlib.Mesh(n_data=4, n_model=1, rank=2, device=torch.device("cpu"))
    assert mesh.local_rows(200) == slice(100, 150)
    dp_tp = meshlib.Mesh(n_data=2, n_model=2, rank=3, device=torch.device("cpu"))
    assert (dp_tp.data_index, dp_tp.model_index, dp_tp.local_rows(200)) == (1, 1, slice(100, 200))
    with pytest.raises(ValueError, match="must divide over the mesh's 4 'data' ranks"):
        mesh.local_rows(10)
    with pytest.raises(ValueError, match="one per shard"):
        meshlib.make_mesh(n_data=2, device="cpu")  # no process group: a world of 1
    assert run_train.torchrun_rank({"RANK": "1"}) is None
    env = dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="1", MASTER_ADDR="localhost",
               MASTER_PORT="29511")
    assert run_train.torchrun_rank(env) == dict(init_method="env://", world_size=4, rank=3,
                                                local_rank=1)


@pytest.mark.parametrize("launch_by", list(LAUNCHES))
def test_only_the_primary_rank_prints_its_epoch_timing(launch_by, spawned):
    """ST_TPU_TIMING=1 in both ranks of a world of 2: one [timing] line for
    the one epoch, rank 0's (JAX: `if timing and primary`); both ranks share
    the launcher's stderr, so a line from rank 1 would make two."""
    _, rc, _, stderr = spawned[launch_by]
    assert rc == 0, stderr[-3000:]
    assert stderr.count("[timing] epoch 1:") == 1, stderr[-3000:]


@pytest.mark.parametrize("launch_by", list(LAUNCHES))
def test_run_train_trains_one_world_and_only_rank_zero_writes(launch_by, spawned):
    cwd, rc, stdout, stderr = spawned[launch_by]
    assert rc == 0, stderr[-3000:]
    assert stdout.count("data parallel over 2 ranks, 4 rows each a step") == 1
    assert stdout.count("run_train: Execution completed.") == 1
    assert {"modelcheckpoint.tar", "vl_avg_out.dat", "val_err_mae.dat"} <= set(os.listdir(cwd))
    assert len(open(cwd / "vl_avg_out.dat").read().splitlines()) == 1  # one writer
    _, rv = checkpoint.load_checkpoint(str(cwd / "modelcheckpoint.tar"))
    assert rv["optax_step"] == 2
