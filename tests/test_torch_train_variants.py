"""One train step of the port against the JAX package in the model and
optimizer variants the three-step test (tests/test_torch_train.py) does not
cover: the flagship ResNet-50+SE blocks, and SGD with weight decay and split
param groups.  Same limits: loss to 1e-4 relative, trees to
|port - jax| / |jax update| <= 1e-2 per tensor."""

import pytest
import torch

from tests import torch_train_pair as P

torch.set_num_threads(1)

VARIANTS = {
    "resnet50_se": dict(cfg=P.config("resnet50", se=True)),
    # From the init: SGD's step is linear in the gradient (no Adam warm-up
    # needed), but at the seeded init's gradients (~1e-6) a step at lr 1e-3
    # is below one ulp of a BN scale of 1.0, so lr 10.  Batch 4: at batch 2
    # layer4's BN statistics (n = 8) leave its gradients ~0.6% apart.
    "sgd_weight_decay_split_groups": dict(
        cfg=P.config(optimizer="sgd", lr=10.0, weight_decay=1e-4, split_groups=True),
        warmup=0, batch=4),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_step_matches_jax(monkeypatch, variant):
    P.jax_crops_as_tested(monkeypatch)
    v = VARIANTS[variant]
    metrics, before, model_pair, ema_pair, _ = P.run_steps(
        v["cfg"], 1, warmup=v.get("warmup", P.WARMUP), batch=v.get("batch", 2))
    P.check_metrics(metrics)
    P.check_trees(before, model_pair, ema_pair)
