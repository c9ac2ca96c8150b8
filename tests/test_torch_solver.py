"""The port's PoseSolver (simple_pose_torch/train/solver.py) against the JAX
package's PoseSolver on a one-device mesh: the lr per step, one train_epoch
from a carried state, validate on the same weights, and model.pretrained.
resnet18, 64x64 crops, batch 8, f32, as tests/test_train.py runs the JAX
solver, on synthetic COCO with a skewed instance count (canvas dedup on)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import flax_to_torch_state, load_jax_train_state
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.train.solver import PoseSolver, init_train_state
from simple_pose_tpu.parallel.mesh import make_mesh
from simple_pose_tpu.train.config import load_config as jax_load_config
from simple_pose_tpu.train.solver import PoseSolver as JaxPoseSolver
from simple_pose_tpu.train.solver import TrainState as JaxTrainState
from simple_pose_tpu.train.solver import make_train_step as jax_make_train_step
from tests import torch_train_pair as P
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

PEOPLE = [1, 3, 1, 4, 2, 1, 1, 3, 2, 1, 2, 2]  # 23 records: 2 plain, 3 dedup batches of 8


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    img_root, ann_path, _ = make_synth_coco(str(root), num_images=len(PEOPLE),
                                            people_per_image=PEOPLE, seed=2)
    return img_root, ann_path


def _cfg(coco, weight_path="weights", **optim):
    img_root, ann_path = coco
    return {
        "model_name": "test",
        "data": {"train_ann_path": ann_path, "val_ann_path": ann_path,
                 "train_img_root": img_root, "val_img_root": img_root,
                 "batch_size": 8, "num_workers": 2, "canvas": 192,
                 "input_shape": [P.CROP[1], P.CROP[0]]},
        "model": {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17},
        "optim": {"lr": 1e-3, "milestones": [1], "epochs": 3, "amp": False, **optim},
        "val": {"interval": 1, "weight_path": str(weight_path)},
        "mesh": {"data": 1},
        "seed": 11,
    }


def _jax_solver(cfg):
    return JaxPoseSolver(jax_load_config(cfg), mesh=make_mesh({"data": 1}))


OPTIMS = {
    "multistep": {},
    "warmup_cosine_multistep_split": {"schedule": "warmup_cosine_multistep",
                                      "milestones": [1, 2], "warm_up_epoch": 1,
                                      "split_groups": True, "weight_decay": 1e-4},
}


@pytest.mark.parametrize("optim", sorted(OPTIMS))
def test_lr_per_step_matches_optax(coco, optim):
    """Each param group's lr at every step of one epoch and a half (the
    milestone inside) equals the JAX solver's optax schedule, f32 rounding
    aside: the schedule's steps per epoch are plain batches in both."""
    cfg = _cfg(coco, **OPTIMS[optim])
    jsolver = _jax_solver(cfg)
    tsolver = PoseSolver(cfg, device="cpu")
    spe = tsolver._steps_per_epoch
    assert spe == jsolver._steps_per_epoch == 2
    assert len(tsolver.train_pipe._pack_epoch(0)) == 3  # dedup packs another count
    state = tsolver.init_state()
    # the port's param groups: decay, bias (warms up from 0.1 with
    # split_groups), other
    bias = (jsolver._build_schedule(spe, warmup_start=0.1)
            if cfg["optim"].get("split_groups") else jsolver.schedule)
    want = [jsolver.schedule, bias, jsolver.schedule]
    assert len(state.schedules) == len(want)
    steps = range(spe * 3 // 2 + 1)
    for got_fn, want_fn in zip(state.schedules, want):
        got = [got_fn(s) for s in steps]
        np.testing.assert_allclose(got, [float(want_fn(jnp.int32(s))) for s in steps],
                                   rtol=1e-6)
        assert len(set(got)) > 1


def _recording(step, losses):
    def wrapped(state, batch):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return wrapped


@pytest.fixture(scope="module")
def epoch_pair(coco, tmp_path_factory):
    """JAX: 4 warm-up steps alone on this run's own batches (epoch 9), then
    train_epoch(0) with the step of tests/torch_train_pair.py (Pallas in
    interpret mode, the crop eager).  The port: the warmed-up state carried
    over with load_jax_train_state, then its own train_epoch(0)."""
    cfg = _cfg(coco, tmp_path_factory.mktemp("w"))
    with pytest.MonkeyPatch.context() as mp:
        P.jax_crops_as_tested(mp)
        jsolver = _jax_solver(cfg)
        variables = jax.jit(jsolver.train_model.init)(
            jax.random.PRNGKey(0), jnp.zeros((1,) + P.CROP + (3,), jnp.float32))
        params, stats = variables["params"], variables["batch_stats"]
        jstate = JaxTrainState(
            params=params, batch_stats=stats, opt_state=jsolver.tx.init(params),
            ema_params=jax.tree.map(jnp.copy, params),
            ema_batch_stats=jax.tree.map(jnp.copy, stats), step=jnp.zeros((), jnp.int32))
        jstep = jax.jit(jax_make_train_step(jsolver.train_model, jsolver.tx, P.OUT, P.CROP,
                                            crop_impl="pallas"))
        warm = list(jsolver.train_pipe.epoch(9)) + list(jsolver.train_pipe.epoch(8))[:1]
        for b in warm:
            jstate, _ = jstep(jstate, b)
        before = jax.device_get(jstate)

        tsolver = PoseSolver(cfg, device="cpu")
        load_jax_train_state(tsolver.init_state(), before)
        jlosses, tlosses = [], []
        jsolver.state = jstate
        jsolver._train_step = _recording(jstep, jlosses)
        tsolver._compile()
        tsolver._train_step = _recording(tsolver._train_step, tlosses)
        jm = jsolver.train_epoch(0, log_every=2)
        tm = tsolver.train_epoch(0, log_every=2)
    return {"cfg": cfg, "jsolver": jsolver, "tsolver": tsolver, "before": before,
            "losses": (jlosses, tlosses), "means": (jm, tm)}


def test_train_epoch_matches_jax(epoch_pair):
    jsolver, tsolver = epoch_pair["jsolver"], epoch_pair["tsolver"]
    jlosses, tlosses = epoch_pair["losses"]
    assert len(tlosses) == len(jlosses) == 3
    for i, (w, g) in enumerate(zip(jlosses, tlosses)):
        assert np.isfinite(g) and abs(g / w - 1) <= P.LOSS_REL, (i, g, w)
    jm, tm = epoch_pair["means"]
    assert abs(tm["loss"] / jm["loss"] - 1) <= P.LOSS_REL
    assert abs(tm["acc"] - jm["acc"]) <= 1e-6
    assert tsolver.state.step == int(jsolver.state.step) == P.WARMUP + 3
    before, _ = P.torch_trees(epoch_pair["before"])
    jmodel, jema = P.torch_trees(jsolver.state)
    tstate = tsolver.state
    P.check_trees(before, (jmodel, tstate.model.state_dict()),
                  (jema, {**tstate.ema_params, **tstate.ema_buffers}))
    # the lr the last step applied: the schedule at the count of earlier updates
    lr = tstate.optimizer.param_groups[0]["lr"]
    assert lr == pytest.approx(float(jsolver.schedule(tstate.step - 1)), rel=1e-6)


def test_validate_matches_jax_on_same_weights(epoch_pair, tmp_path):
    """Both validate the JAX solver's weights after the epoch (loaded into
    the port); tolerances of test_torch_evalkit.py's predicts_by_gt test:
    with weights this young the heatmaps are nearly flat, so a few argmaxes
    flip between peaks tied to f32 sum order."""
    jsolver, tsolver = epoch_pair["jsolver"], epoch_pair["tsolver"]
    load_jax_train_state(tsolver.state, jax.device_get(jsolver.state))
    want = jsolver.validate(0, results_path=str(tmp_path / "j.json"))
    got = tsolver.validate(0, results_path=str(tmp_path / "t.json"))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    rj = json.loads((tmp_path / "j.json").read_text())  # both in the val pipeline's order
    rt = json.loads((tmp_path / "t.json").read_text())
    n = sum(PEOPLE)
    assert len(rt) == len(rj) == n
    assert [r["image_id"] for r in rt] == [r["image_id"] for r in rj]
    kt = np.array([r["keypoints"] for r in rt]).reshape(n, 17, 3)
    kj = np.array([r["keypoints"] for r in rj]).reshape(n, 17, 3)
    np.testing.assert_allclose(kt[..., 2], kj[..., 2], rtol=1e-4)
    close = np.abs(kt[..., :2] - kj[..., :2]).max(-1) < 0.15  # canvas px
    assert close.mean() >= 0.95, close.mean()


def test_pretrained_loads_like_jax(coco, tmp_path):
    """A reference-layout .pth the test writes: wrapped in ['ema'], keys with
    a 'module.' prefix, and an ImageNet fc.weight that no pose model has.
    Every key the JAX solver loads equals the port's, and the EMA copies
    start at the loaded weights."""
    src = build_resnet("resnet18", seed=5).state_dict()
    raw = {f"module.{k}": v for k, v in src.items()}
    raw["module.fc.weight"] = torch.randn(1000, 512, generator=torch.Generator().manual_seed(0))
    pth = str(tmp_path / "ref.pth")
    torch.save({"ema": raw, "epoch": 3}, pth)
    cfg = _cfg(coco)
    cfg["model"]["pretrained"] = pth
    jstate = _jax_solver(cfg).init_state()
    tstate = init_train_state(cfg, device="cpu")
    jloaded = flax_to_torch_state({"params": jax.device_get(jstate.params),
                                   "batch_stats": jax.device_get(jstate.batch_stats)})
    port = tstate.model.state_dict()
    assert set(jloaded) == set(port)
    for k, v in jloaded.items():
        assert torch.equal(port[k], v), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, src[k]), k  # loaded, not the init
    for k, v in {**tstate.ema_params, **tstate.ema_buffers}.items():
        assert torch.equal(v, port[k]), k
    jema = flax_to_torch_state({"params": jax.device_get(jstate.ema_params),
                                "batch_stats": jax.device_get(jstate.ema_batch_stats)})
    for k, v in tstate.ema_params.items():
        assert torch.equal(jema[k], v), k
