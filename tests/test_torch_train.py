"""The port's train step (simple_pose_torch/train/solver.py) against the JAX
package's make_train_step: f32, Adam with the multistep schedule (its
milestone inside the compared steps) and EMA on.  JAX takes 4 steps alone
from its init, then its whole state is carried into the port with
convert/from_jax (tests/torch_train_pair.py says why), and both take the
same steps on the same batches.  The loss must agree to 1e-4 relative at
every step and the accuracy exactly; params, BN statistics and their EMA
copies to |port - jax| / |jax update| <= 1e-2 per tensor (not elementwise).
``crop_impl='kernel'`` (K1's plain version on the CPU) runs against JAX's
``'pallas'`` (interpret mode), ``'gather'`` against ``'gather'``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_pose_torch.train.config import load_config
from simple_pose_torch.train.solver import make_val_step
from simple_pose_tpu.train.config import load_config as jax_load_config
from simple_pose_tpu.train.solver import make_val_step as jax_make_val_step
from tests import torch_train_pair as P

torch.set_num_threads(1)


@pytest.mark.parametrize("crop_impl", ["kernel", "gather"])
def test_three_steps_match_jax(monkeypatch, crop_impl):
    P.jax_crops_as_tested(monkeypatch)
    metrics, before, model_pair, ema_pair, (solver, jstate, tstate) = P.run_steps(
        P.config(), 3, crop_impl=crop_impl)
    print("losses (jax, port):", [(m["jax_loss"], m["loss"]) for m in metrics])
    P.check_metrics(metrics)
    P.check_trees(before, model_pair, ema_pair)
    if crop_impl == "kernel":
        _check_val_step(solver, jstate, tstate)


def _check_val_step(solver, jstate, tstate):
    """The validation step on the EMA weights (eval-mode BN, separable crop,
    basic decode): loss and accuracy as the train step's."""
    batch = P.make_batch(7)
    batch["trans"] = np.tile(np.array([[0.5, 0.0, 4.0], [0.0, 0.5, 6.0]], np.float32), (2, 1, 1))
    batch["trans_inv"] = np.tile(np.array([[8.0, 0.0, -8.0], [0.0, 8.0, -12.0]], np.float32),
                                 (2, 1, 1))
    want = jax.jit(jax_make_val_step(solver.eval_model, "basic", P.OUT, P.CROP, use_ema=True))(
        jstate, batch)
    got = make_val_step("basic", P.OUT, P.CROP, use_ema=True)(tstate, batch)
    assert abs(got["loss"].item() / float(want["loss"]) - 1) <= P.LOSS_REL
    assert abs(got["acc"].item() - float(want["acc"])) <= 1e-6
    assert got["kps"].shape == (2, 17, 2) and torch.isfinite(got["kps"]).all()
    np.testing.assert_allclose(got["kp_conf"].numpy(), np.asarray(want["kp_conf"]), rtol=1e-4,
                               atol=1e-9)


def test_load_config_matches_jax():
    want = jax_load_config("configs/fast_pose.yaml")
    got = load_config("configs/fast_pose.yaml")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    d = {"model": {"name": "resnet18"}, "optim": {"milestones": [3], "split_groups": True},
         "data": {"aug_rot": [-30, 30]}, "seed": 5}
    assert dataclasses.asdict(load_config(d)) == dataclasses.asdict(jax_load_config(d))
