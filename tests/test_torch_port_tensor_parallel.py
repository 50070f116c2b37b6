"""Tensor parallelism of the port on the CPU, under gloo, against the
single-process oracle, the unsharded port and the JAX package's
``("data", "model")`` mesh.

One spawn of four gloo CPU ranks (``parallel/launch.spawn``, a ``file://``
store under the test's temporary directory) runs
``tests/torch_port_tp_ranks.four_ranks``, which builds each mesh shape over
that world (2 x 2, 1 x 4, 4 x 1) and serves every case through one module
fixture; ``cli.run_train --nproc 2 --nmodel 2 --device cpu`` runs beside it,
and the JAX side is computed in this process meanwhile. The geometry is the
JAX multi-chip test's (ft 64, hop 24, batch 16, tests/test_multichip_oracle.py).

* The sharded forward over a model group of 2 (1 x 2: each data group of the
  2 x 2 mesh runs the whole batch) and at 2 x 2 (each data group its rows)
  against the JAX model's replicated forward within atol 2e-5
  (tests/test_parallel.py:56), and against the port's unsharded forward.
* 3 dp x tp steps at 2 x 2 and at 1 x 4 against ``oracle.oracle_steps`` at
  ``n_data`` shards: the gathered weights and Adam's two moments within the
  JAX test's ``ATOL 2e-6`` / ``RTOL 2e-5`` (tests/test_multichip_oracle.py:
  41-42, which holds the optimizer state too), the losses within rtol 1e-5.
* The controls, each failing that check: the oracle with ``reduce="sum"``,
  an all-gather whose backward sums over the model group where it must
  slice, a synthesis input whose backward does not sum where it must.
* The replicated weights bit-equal across the model ranks; the front-end's
  parameters, gradients and moments on a rank its rows only.
* The arrays-fed step at 2 x 2 against the JAX ``make_train_step_from_arrays``
  on a (2, 2) mesh of the virtual CPU devices (GSPMD's tensor parallelism):
  the loss within rtol 1e-4 a step, the weights within atol 1e-5 after 5
  steps (tests/test_torch_port_parallel.py's case (e)).
* The clip with the L1 total over the model group against the unsharded clip.
* A checkpoint saved by ``train()`` at 2 x 2 is the one a single card writes
  (whole matrices, ``strict=True``) and resumes at 4 x 1, at 1 x 4 and in one
  process, each matching the oracle at its ``n_data``.
* ``run_train --nproc 2 --nmodel 2`` trains one 1 x 2 world, only rank 0
  writes; ``RunConfig`` takes ``n_model`` and refuses a world it does not tile.
"""

import concurrent.futures
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from signaltrain_tpu.parallel import mesh as jmeshlib
from signaltrain_tpu.training import train as jtrain
from signaltrain_tpu_torch import config
from signaltrain_tpu_torch.dsp import effects
from signaltrain_tpu_torch.data import synth_data
from signaltrain_tpu_torch.models import mpaec
from signaltrain_tpu_torch.models.st_model import ModelSpec, STModel, st_model
from signaltrain_tpu_torch.parallel import launch
from signaltrain_tpu_torch.parallel import mesh as meshlib
from signaltrain_tpu_torch.training import checkpoint, oracle
from signaltrain_tpu_torch.training import train as train_mod
from tests import torch_port_parallel_ranks as dp
from tests import torch_port_tp_ranks as ranks
from tests.torch_port_util import jax_params, model_inputs, n, tiny_spec

SPAWN_LIMIT_S = 300.0
REPO = Path(__file__).resolve().parent.parent
CLI = ["-m", "signaltrain_tpu_torch.cli.run_train", "--epochs", "1", "-n", "16", "-b", "8",
       "--scale", "0.0625", "--dtype", "float32", "--lrmax", "2e-4", "--device", "cpu",
       "--nproc", "2", "--nmodel", "2"]
FT = dp.TINY["ft_size"]


def jax_arrays_steps(jm, params, batches):
    """The JAX arrays-fed step on a (2, 2) mesh, the front-end sharded over
    'model': its losses and final weights as a port state dict."""
    tx, _ = jtrain.make_optimizer(**dp.ARRAYS_OPT)
    jmesh = jmeshlib.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jstep = jtrain.make_train_step_from_arrays(jm, tx, mesh=jmesh)
    jp = jax.tree_util.tree_map(jnp.copy, params)
    jp = jax.device_put(jp, jmeshlib.param_shardings(jmesh, jp))
    jopt = tx.init(jp)
    losses = []
    for x, y, knobs in batches:
        jp, jopt, jl = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(knobs))
        losses.append(float(jl))
    return losses, {k: n(v) for k, v in
                    checkpoint.params_to_state_dict(jax.device_get(jp)).items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four ranks' results, the CLI run's, and the JAX side's."""
    jm, params = jax_params(tiny_spec(), seed=11)
    sd = {k: v.numpy() for k, v in checkpoint.params_to_state_dict(params).items()}
    x, knobs = model_inputs(tiny_spec(), 8, seed=4)
    batches = []
    for step in range(5):
        bx, bk = model_inputs(tiny_spec(), dp.ARRAYS_OPT["batch_size"], seed=20 + step)
        by = np.random.default_rng(40 + step).normal(size=(bx.shape[0], 128)) * 0.3
        batches.append((bx, by.astype(np.float32), bk))
    rng = np.random.default_rng(9)
    grads = {k: (rng.normal(size=sd[k].shape) * 1e-3).astype(np.float32)
             for k in train_mod.FRONTEND_PARAMS}
    workdir, cwd = tmp_path_factory.mktemp("world4"), tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO),
                                                       os.environ.get("PYTHONPATH", "")]))
    cli = subprocess.Popen([sys.executable, *CLI], cwd=cwd, env=env, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            four = pool.submit(launch.spawn, ranks.four_ranks, ["cpu"] * 4, "gloo",
                               args=(sd, x, knobs, batches, grads, str(workdir)),
                               timeout_s=SPAWN_LIMIT_S)
            y_jax = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(knobs))[0])
            j_losses, j_params = jax_arrays_steps(jm, params, batches)
            out = {"ranks": four.result(), "sd": sd, "x": x, "knobs": knobs, "grads": grads,
                   "y_jax": y_jax, "jax_arrays": (j_losses, j_params), "workdir": workdir}
        stdout, stderr = cli.communicate(timeout=SPAWN_LIMIT_S)
        out["cli"] = (cwd, cli.returncode, stdout, stderr)
        return out
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()


def oracle_state(n_data: int, reduce: str = "mean"):
    """(losses, gathered-form state) of ranks.STEPS oracle steps at n_data,
    on the ranks' gemm front-end."""
    model, opt, lr_fn, batch_fn = dp.dp_setup()
    model.mpaec.frontend = "gemm"
    losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, dp.BATCH, n_data, torch.Generator(),
                                 dp.DP_SEED, 0, ranks.STEPS, reduce=reduce)
    return n(losses), checkpoint.training_tensors(model, opt)


def unsharded(sd):
    model = dp.tiny_model(sd).eval()
    model.mpaec.frontend = "gemm"
    return model


# ------------------------------------------------------------ the row split

@pytest.mark.parametrize("ft,n_model", [(64, 1), (64, 2), (64, 4), (1024, 2), (1024, 4), (100, 3)])
def test_each_rank_holds_its_bins_and_their_mirrors(ft, n_model):
    half = ft // 2 + 1
    rows = [meshlib.frontend_rows(ft, n_model, m) for m in range(n_model)]
    assert np.array_equal(np.sort(np.concatenate(rows)), np.arange(ft))  # a partition
    bins = [meshlib.bin_range(half, n_model, m) for m in range(n_model)]
    assert [b[0] for b in bins] == [0] + [b[1] for b in bins[:-1]] and bins[-1][1] == half
    assert max(hi - lo for lo, hi in bins) - min(hi - lo for lo, hi in bins) <= 1
    for (lo, hi), r in zip(bins, rows):
        assert np.array_equal(r, np.sort(r))
        own, mirrors = r[r < half], r[r >= half]
        assert np.array_equal(own, np.arange(lo, hi))
        assert set(ft - mirrors) == {c for c in range(lo, hi) if 1 <= c <= half - 2}
        assert len(r) <= -(-ft // n_model) + 1


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("mesh_shape", ["1x2", "2x2"])
def test_sharded_forward_matches_jax_and_the_unsharded_port(mesh_shape, spawned):
    res, x, knobs = spawned["ranks"], spawned["x"], spawned["knobs"]
    with torch.no_grad():
        want = [n(t) for t in unsharded(spawned["sd"])(torch.from_numpy(x),
                                                       torch.from_numpy(knobs))]
    if mesh_shape == "1x2":  # each data group, a model group of 2, on the whole batch
        got = [r["forward"]["whole"] for r in res]
    else:  # each data group its rows; ranks 0 and 2 are model index 0 of data 0 and 1
        got = [[np.concatenate([res[0]["forward"]["rows"][i], res[2]["forward"]["rows"][i]])
                for i in range(3)]]
    for g in got:
        np.testing.assert_allclose(g[0], spawned["y_jax"], atol=2e-5)
        for a, b, name in zip(g, want, ("y_hat", "mag", "mag_hat")):
            np.testing.assert_allclose(a, b, atol=2e-5, err_msg=name)


# ------------------------------------------------------ the oracle, controls

@pytest.mark.parametrize("mesh_shape,n_data", [("2x2", 2), ("1x4", 1)])
def test_dp_tp_steps_match_the_single_process_oracle(mesh_shape, n_data, spawned):
    losses, want = oracle_state(n_data)
    for r in spawned["ranks"]:
        got = r["steps"][mesh_shape]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert oracle.state_excess(got["state"], want) <= 1.0


@pytest.mark.parametrize("control", ["sum_not_mean", "gather_sums", "input_not_summed"])
def test_each_control_fails_the_oracle_check(control, spawned):
    _, want = oracle_state(2)
    if control == "sum_not_mean":
        _, summed = oracle_state(2, reduce="sum")
        got, want = spawned["ranks"][0]["steps"]["2x2"]["state"], summed
    else:
        got = spawned["ranks"][0]["controls"][control]["state"]
    assert oracle.state_excess(got, want) > 1.0


@pytest.mark.parametrize("mesh_shape", ["2x2", "1x4"])
def test_replicated_weights_are_bit_equal_across_the_model_ranks(mesh_shape, spawned):
    res = [r["steps"][mesh_shape] for r in spawned["ranks"]]
    for r in res[1:]:
        assert r["replicated"].keys() == res[0]["replicated"].keys()
        for k, v in r["replicated"].items():
            np.testing.assert_array_equal(v, res[0]["replicated"][k], err_msg=k)
        for k, v in r["state"]["state_dict"].items():
            np.testing.assert_array_equal(v, res[0]["state"]["state_dict"][k], err_msg=k)


@pytest.mark.parametrize("mesh_shape,n_model", [("2x2", 2), ("1x4", 4)])
def test_a_rank_holds_its_share_of_the_front_end(mesh_shape, n_model, spawned):
    for rank, r in enumerate(spawned["ranks"]):
        want = len(meshlib.frontend_rows(FT, n_model, rank % n_model))
        sizes = r["steps"][mesh_shape]["shard_rows"]
        assert set(sizes) == {k for k in train_mod.FRONTEND_PARAMS}
        for name, (param, grad, mu, nu) in sizes.items():
            assert param == grad == mu == nu == want, name
        assert want <= -(-FT // n_model) + 1


# ------------------------------------------------------------ JAX's (2, 2) mesh

def test_arrays_step_matches_the_jax_dp_tp_mesh(spawned):
    j_losses, j_params = spawned["jax_arrays"]
    for r in spawned["ranks"]:
        np.testing.assert_allclose(r["arrays"]["losses"], j_losses, rtol=1e-4)
        for name, v in r["arrays"]["params"].items():
            np.testing.assert_allclose(v, j_params[name], atol=1e-5, err_msg=name)


# --------------------------------------------------------------------- clip

def test_the_clip_over_the_model_group_is_the_unsharded_clip(spawned):
    model = unsharded(spawned["sd"])
    for name, p in model.named_parameters():
        g = spawned["grads"].get(name)
        p.grad = torch.from_numpy(g.copy()) if g is not None else torch.zeros_like(p)
    total = train_mod.clip_frontend_grads(model)
    params = dict(model.named_parameters())
    for r in spawned["ranks"]:
        np.testing.assert_allclose(r["clip"]["total"], n(total), rtol=1e-6)
        for name, g in r["clip"]["grads"].items():
            np.testing.assert_allclose(g, n(params[name].grad), rtol=1e-6, atol=1e-12,
                                       err_msg=name)


# ------------------------------------------------------------- checkpoints

def resume_oracle(ckpt: str, n_data: int, frontend: str):
    """The checkpoint's weights and Adam state run on 2 steps at n_data, on
    the run's front-end."""
    kw = ranks.TRAIN_KW
    state, rv = checkpoint.load_checkpoint(ckpt)
    model = st_model(scale_factor=kw["scale_factor"], device="cpu").train()
    model.mpaec.frontend = frontend
    model.load_state_dict(state, strict=True)
    opt, lr_fn = train_mod.make_optimizer(model, kw["lr_max"], kw["n_data_points"], kw["epochs"],
                                          kw["batch_size"])
    checkpoint.restore_optimizer(model, opt, rv["optax_state"], rv["optax_step"])
    spec = model.spec
    batch_fn = synth_data.make_synth_batch_fn(effects.make_effect("comp_4c", device="cpu"),
                                              spec.in_chunk_size, spec.out_chunk_size)
    losses = oracle.oracle_steps(model, opt, lr_fn, batch_fn, kw["batch_size"], n_data,
                                 torch.Generator(), kw["seed"], rv["optax_step"], 2)
    return n(losses), model


@pytest.mark.parametrize("mesh_shape,n_data,frontend", [("4x1", 4, "fused"), ("1x4", 1, "gemm"),
                                                        ("one_process", 1, "fused")])
def test_a_2x2_checkpoint_resumes_under_another_mesh(mesh_shape, n_data, frontend, spawned,
                                                     tmp_path, monkeypatch):
    ckpt = str(spawned["workdir"] / "2x2" / "rank0" / "modelcheckpoint.tar")
    if mesh_shape == "one_process":
        monkeypatch.chdir(tmp_path)
        model, hist = train_mod.train(effects.make_effect("comp_4c", device="cpu"),
                                      in_checkpointname=ckpt, **ranks.TRAIN_KW)
        got = {"hist": hist, "state": ranks.whole(model)["state_dict"]}
    else:
        got = spawned["ranks"][0]["train"][mesh_shape]
    losses, model = resume_oracle(ckpt, n_data, frontend)
    assert got["hist"]["step"] == 4
    np.testing.assert_allclose(got["hist"]["train_loss"], losses, rtol=1e-5)
    assert oracle.excess(got["state"], dict(model.named_parameters())) <= 1.0


def test_the_2x2_checkpoint_is_the_one_a_single_card_writes(spawned):
    res = spawned["ranks"]
    ckpt = str(spawned["workdir"] / "2x2" / "rank0" / "modelcheckpoint.tar")
    state, rv = checkpoint.load_checkpoint(ckpt)
    single = st_model(scale_factor=ranks.TRAIN_KW["scale_factor"], device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in single.state_dict().items()}
    single.load_state_dict(state, strict=True)
    for k, v in res[0]["train"]["2x2"]["state"].items():  # the gathered weights, as trained
        np.testing.assert_array_equal(n(state[k]), v, err_msg=k)
    opt, _ = train_mod.make_optimizer(single, 1e-4, 16, 1, 8)
    checkpoint.restore_optimizer(single, opt, rv["optax_state"], rv["optax_step"])  # whole moments
    assert [r["train"]["2x2"]["files"] for r in res] == [
        ["modelcheckpoint.tar", "val_err_mae.dat", "vl_avg_out.dat"], [], [], []]
    assert all(r["train"]["2x2"]["hist"] == res[0]["train"]["2x2"]["hist"] for r in res)


# ------------------------------------------------------------ entry points

def test_run_train_nmodel_trains_one_1x2_world(spawned):
    cwd, rc, stdout, stderr = spawned["cli"]
    assert rc == 0, stderr[-3000:]
    assert stdout.count("tensor parallel over 2 ranks") == 1  # rank 0 alone prints
    assert stdout.count("data parallel over 1 ranks, 8 rows each a step") == 1
    assert stdout.count("run_train: Execution completed.") == 1
    assert {"modelcheckpoint.tar", "val_err_mae.dat", "vl_avg_out.dat"} <= set(os.listdir(cwd))
    assert len(open(cwd / "vl_avg_out.dat").read().splitlines()) == 1  # one writer
    state, rv = checkpoint.load_checkpoint(str(cwd / "modelcheckpoint.tar"))
    assert rv["optax_step"] == 2
    st_model(scale_factor=0.0625, device="cpu").load_state_dict(state, strict=True)


def test_run_config_takes_n_model_and_refuses_a_world_it_does_not_tile():
    cfg = config.RunConfig(n_model=2, nproc=4)
    assert (cfg.n_model, cfg.nproc) == (2, 4)
    for n_model, nproc in [(3, 4), (2, 1), (0, 4)]:
        with pytest.raises(ValueError, match="n_data x"):
            config.RunConfig(n_model=n_model, nproc=nproc)


def test_one_shard_is_the_gemm_front_end_bit_for_bit():
    """A model on a mesh of one (no process group: one shard, collectives
    that are identities) takes every sum of the gemm front-end in its order;
    the fused front-end is refused on a mesh, and "auto" picks gemm there."""
    mesh = meshlib.make_mesh(device="cpu")
    assert (mpaec.pick_frontend("auto"), mpaec.pick_frontend("auto", mesh)) == ("fused", "gemm")
    with pytest.raises(ValueError, match="unsupported on a tensor-parallel mesh"):
        mpaec.pick_frontend("fused", mesh)
    sd = dp.tiny_model().state_dict()
    x, knobs = (torch.from_numpy(a) for a in model_inputs(tiny_spec(), 4, seed=2))
    outs = []
    for m in (None, mesh):
        model = STModel(ModelSpec(**dp.TINY), frontend="gemm", device="cpu", mesh=m)
        model.load_state_dict(sd, strict=True)
        y, mag, mag_hat = model(x, knobs)
        (y.square().mean() + mag_hat.mean()).backward()
        outs.append([y, mag, mag_hat, *(p.grad for p in model.parameters())])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_a_gloo_model_group_is_dispatched_op_by_op(tmp_path):
    """gloo's collectives cannot be captured: in a gloo world of one the
    model group is the world's, and every graph refuses a model split over
    it (train() dispatches its steps op by op there); with no process group
    there is no collective to capture."""
    from signaltrain_tpu_torch.parallel import distributed
    from signaltrain_tpu_torch.training import graphs

    assert meshlib.make_mesh(device="cpu").captures_collectives()
    assert distributed.backend() is None
    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0, "gloo", "cpu")
    try:
        assert distributed.backend() == "gloo"
        mesh = meshlib.make_mesh(device="cpu")
        assert not mesh.captures_collectives()
        model = STModel(ModelSpec(**dp.TINY), device="cpu", mesh=mesh)
        with pytest.raises(ValueError, match="op by op"):
            graphs.EvalGraph(model, None, 8, torch.Generator(), 1, mesh=mesh)
    finally:
        distributed.shutdown()


def test_train_refuses_tensor_parallelism_over_nccl(monkeypatch):
    """Under NCCL (across CUDA cards) train() takes n_model > 1 as it does
    over gloo, its steps op by op (four cards met the oracle through
    cli.time_data_parallel --nmodel 2 and 4): the backend is no reason to
    refuse; a world that n_model does not tile still is, here a world of one."""
    from signaltrain_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "backend", lambda: "nccl")
    effect = effects.make_effect("comp_4c", device="cpu")
    with pytest.raises(ValueError, match="1 ranks are not n_data x 2") as refused:
        train_mod.train(effect, device="cpu", n_model=2, make_plots=False)
    assert "NCCL" not in str(refused.value)
