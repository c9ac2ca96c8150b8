"""The port's multi-process training (DDP and the global-batch BatchNorm in
place of the JAX mesh) on the CPU: two gloo ranks, each a process of
tests/torch_ddp_worker.py, held against one process and against the JAX
package's SPMD step on the global batch (which tests/test_multihost.py shows
equals its multi-process run).  Each multi-process run has its own timeout
(tests/torch_ddp_worker.run_ranks) and its own working directory."""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import load_jax_train_state
from simple_pose_torch.models.layers import BatchNorm2d
from simple_pose_torch.train.solver import PoseSolver, init_train_state
from simple_pose_tpu.convert.torch2flax import convert_torch_state
from simple_pose_tpu.parallel.mesh import make_mesh
from simple_pose_tpu.train.config import load_config as jax_load_config
from simple_pose_tpu.train.solver import PoseSolver as JaxPoseSolver
from simple_pose_tpu.train.solver import TrainState as JaxTrainState
from simple_pose_tpu.train.solver import make_train_step as jax_make_train_step
from tests import torch_train_pair as P
from tests.torch_ddp_worker import run_ranks
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

BN_TOL = dict(rtol=1e-5, atol=1e-5)


def test_batchnorm_global_batch_over_two_ranks(tmp_path):
    """Output, input and weight gradients and running statistics of two
    ranks' halves equal one process's module on the whole batch and flax's
    BatchNorm there (f32, 1e-5); the ranks' buffers are identical; the
    recompute of a rematerialized block (update_stats False) makes the same
    collectives and leaves the buffers alone."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0.5, 2.0, (8, 4, 5, 6))).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.normal(0, 0.5, 4).astype(np.float32)
    np.savez(tmp_path / "bn.npz", x=x, g=g, weight=weight, bias=bias)
    ranks = run_ranks("bn", tmp_path)

    bn = BatchNorm2d(4, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()

    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}

    def loss(params, xj):
        out, upd = fbn.apply({**variables, "params": params}, xj, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(g.transpose(0, 2, 3, 1))), (out, upd)

    (_, (yj, upd)), (dparams, dxj) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], xj)

    got_y = torch.cat([r["y"] for r in ranks]).numpy()
    got_dx = torch.cat([r["dx"] for r in ranks]).numpy()
    got_dw = sum(r["dweight"] for r in ranks).numpy()
    got_db = sum(r["dbias"] for r in ranks).numpy()
    for want in ((y.detach().numpy(), xt.grad.numpy(), bn.weight.grad.numpy(),
                  bn.bias.grad.numpy(), bn.running_mean.numpy(), bn.running_var.numpy()),
                 (np.asarray(yj).transpose(0, 3, 1, 2), np.asarray(dxj).transpose(0, 3, 1, 2),
                  np.asarray(dparams["scale"]), np.asarray(dparams["bias"]),
                  np.asarray(upd["batch_stats"]["mean"]),
                  np.asarray(upd["batch_stats"]["var"]))):
        np.testing.assert_allclose(got_y, want[0], **BN_TOL)
        np.testing.assert_allclose(got_dx, want[1], **BN_TOL)
        np.testing.assert_allclose(got_dw, want[2], **BN_TOL)
        np.testing.assert_allclose(got_db, want[3], **BN_TOL)
        for r in ranks:
            np.testing.assert_allclose(r["running_mean"].numpy(), want[4], **BN_TOL)
            np.testing.assert_allclose(r["running_var"].numpy(), want[5], **BN_TOL)
    for key in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][key], ranks[1][key])
    for r in ranks:
        assert torch.equal(r["y_recompute"], r["y"])
        assert torch.equal(r["after_recompute"][0], r["running_mean"])
        assert torch.equal(r["after_recompute"][1], r["running_var"])


GLOBAL_BATCH = 4  # 2 crops per rank


def _jax_state_after_warmup(cfg, jstep_of, canvases, warmup):
    """tests/torch_train_pair.make_states at the global batch: JAX warms up
    alone (Adam moments, tests/torch_train_pair.py), then its state goes
    into the port."""
    solver = JaxPoseSolver(jax_load_config(cfg), mesh=make_mesh({"data": 1}))
    solver._steps_per_epoch = 1
    solver.schedule = solver._build_schedule(1)
    solver.tx = solver._build_optimizer()
    variables = jax.jit(solver.train_model.init)(jax.random.PRNGKey(0),
                                                 jnp.zeros((1,) + P.CROP + (3,), jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    jstate = JaxTrainState(
        params=params, batch_stats=stats, opt_state=solver.tx.init(params),
        ema_params=jax.tree.map(jnp.copy, params), ema_batch_stats=jax.tree.map(jnp.copy, stats),
        step=jnp.zeros((), jnp.int32))
    jstep = jstep_of(solver)
    for i in range(warmup):
        jstate, _ = jstep(jstate, P.make_batch(100 + i, batch=GLOBAL_BATCH, canvases=canvases))
    return jstate, jstep


# (config, warm-up steps, DDP steps).  Adam hides a gradient's scale
# (m / sqrt(v)); SGD's step is linear in it, so a rank's gradient that were
# not the global batch's mean would show: one step from the init at lr 10,
# as tests/test_torch_train_variants.py runs it (more steps diverge)
OPTIMS = {"adam": ({}, P.WARMUP, 2),
          "sgd": (dict(optimizer="sgd", lr=10.0, weight_decay=1e-4, split_groups=True), 0, 1)}


@pytest.mark.parametrize("optim,dedup,remat", [("adam", False, False), ("adam", True, True),
                                               ("sgd", False, False)])
def test_ddp_train_steps_match_jax_global_batch(tmp_path, monkeypatch, optim, dedup, remat):
    """Two DDP train steps of a narrow ResNet (resnet18, 64x64) from a
    JAX-converted state, each rank on its half of the global batch (with
    dedup: its own canvases), with and without canvas dedup, Adam and SGD,
    and with model.remat (DDP's reducer sees each parameter once; the
    recompute repeats the BatchNorm collectives): the ranks' parameters, BN
    buffers and EMA are identical, and they match JAX's make_train_step on
    the concatenated global batch within the train-step tolerances of
    tests/torch_train_pair.py (loss 1e-4, trees 1e-2 of the update); the
    logged loss and accuracy are the global batch's."""
    P.jax_crops_as_tested(monkeypatch)
    canvases = 3 if dedup else None
    optim_cfg, warmup, steps = OPTIMS[optim]
    cfg = P.config("resnet18", **optim_cfg)
    cfg["model"]["remat"] = remat
    jstate, jstep = _jax_state_after_warmup(
        cfg, lambda s: jax.jit(jax_make_train_step(s.train_model, s.tx, P.OUT, P.CROP,
                                                   crop_impl="pallas")), canvases, warmup)
    before, _ = P.torch_trees(jstate)
    tstate = init_train_state(cfg, device="cpu", steps_per_epoch=1)
    load_jax_train_state(tstate, jax.device_get(jstate))
    torch.save({"model": tstate.model.state_dict(), "optimizer": tstate.optimizer.state_dict(),
                "ema": {**tstate.ema_params, **tstate.ema_buffers}, "step": tstate.step},
               tmp_path / "state.pt")
    batches, jmetrics = {}, []
    for i in range(steps):
        batch = P.make_batch(i, batch=GLOBAL_BATCH, canvases=canvases)
        batches.update({f"{i}_{k}": v for k, v in batch.items()})
        jstate, m = jstep(jstate, batch)
        jmetrics.append({"loss": float(m["loss"]), "acc": float(m["acc"])})
    np.savez(tmp_path / "batches.npz", **batches)
    (tmp_path / "train.json").write_text(json.dumps(
        {"cfg": cfg, "out": P.OUT, "crop": P.CROP, "steps": steps}))
    ranks = run_ranks("train", tmp_path)

    for key in ("model", "ema"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)
    assert ranks[0]["step"] == ranks[1]["step"] == warmup + steps
    for i, want in enumerate(jmetrics):
        for r in ranks:
            got = r["metrics"][i]
            assert abs(got["loss"] / want["loss"] - 1) <= P.LOSS_REL, (i, got, want)
            assert abs(got["acc"] - want["acc"]) <= 1e-6, (i, got, want)
    jmodel, jema = P.torch_trees(jstate)
    P.check_trees(before, (jmodel, ranks[0]["model"]), (jema, ranks[0]["ema"]))


PEOPLE = [1, 3, 1, 4, 2, 1, 1, 3, 2, 1, 2, 2]  # 23 records on 12 images


def _solver_cfg(tmp_path, coco, world):
    img_root, ann_path = coco
    return {
        "model_name": "test",
        "data": {"train_ann_path": ann_path, "val_ann_path": ann_path,
                 "train_img_root": img_root, "val_img_root": img_root,
                 "batch_size": 4, "num_workers": 1, "canvas": 192,
                 "input_shape": [P.CROP[1], P.CROP[0]]},
        "model": {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17},
        "optim": {"lr": 1e-3, "milestones": [1], "epochs": 2, "amp": False},
        "val": {"interval": 1, "weight_path": str(tmp_path / "weights")},
        "mesh": {"data": world},
        "seed": 11,
    }


def test_solver_two_ranks_epoch_validate_resume(tmp_path):
    """PoseSolver over two ranks: one epoch (each rank its stride of the
    records, one dedup bucket each), validate, a checkpoint, then a resumed
    run to the end.  Every rank gets the same stats and ends in the same
    state; rank 0 alone writes the results file and the checkpoints; the
    gathered results equal one process's validate of the same checkpoint,
    and its AP is within 0.005 of the JAX solver's validate of the same
    weights.  A config whose mesh.data is neither -1 nor the rank count
    raises."""
    root = tmp_path / "coco"
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=2)
    work = tmp_path / "run"
    work.mkdir()
    cfg = _solver_cfg(work, (img_root, ann_path), 2)
    (work / "solver.json").write_text(json.dumps(cfg))
    ranks = run_ranks("solver", work)

    assert ranks[0]["stats"] == ranks[1]["stats"]
    assert ranks[0]["train"] == ranks[1]["train"]
    assert ranks[0]["start"] == ranks[1]["start"] == 1
    assert ranks[0]["step"] == ranks[1]["step"]
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    assert {"val.json", "temp_test.json"} <= set(ranks[0]["written"])
    assert any(w.startswith("weights/") for w in ranks[0]["written"])  # the checkpoints
    assert ranks[1]["written"] == []

    # one process validates the last checkpoint: the gathered list's poses
    one = PoseSolver({**cfg, "mesh": {"data": -1}}, device="cpu")
    one.restore_checkpoint()
    stats = one.validate(1, results_path=str(tmp_path / "one.json"))
    two = json.loads((work / "temp_test.json").read_text())
    mine = json.loads((tmp_path / "one.json").read_text())
    key = lambda r: (r["image_id"], r["score"])  # noqa: E731
    assert len(two) == len(mine) == sum(PEOPLE)
    for a, b in zip(sorted(two, key=key), sorted(mine, key=key)):
        assert a["image_id"] == b["image_id"]
        np.testing.assert_allclose(a["keypoints"], b["keypoints"], rtol=1e-5, atol=1e-4)

    # the JAX solver validates the same weights
    jsolver = JaxPoseSolver(jax_load_config({**cfg, "mesh": {"data": 1}}),
                            mesh=make_mesh({"data": 1}))
    jstate = jsolver.init_state()
    sd = {k: v.numpy() for k, v in one.state.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    conv, _ = convert_torch_state(sd, "resnet")
    jsolver.state = jstate.replace(params=jax.tree.map(jnp.asarray, conv["params"]),
                                   batch_stats=jax.tree.map(jnp.asarray, conv["batch_stats"]))
    want = jsolver.validate(1, results_path=str(tmp_path / "jax.json"))
    assert abs(stats["AP"] - want["AP"]) < 0.005, (stats["AP"], want["AP"])

    with pytest.raises(ValueError, match="mesh.data"):
        PoseSolver({**cfg, "mesh": {"data": 3}}, device="cpu")
