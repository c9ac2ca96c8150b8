"""Training ops of the port against the JAX package on the same numpy inputs:
heatmap target encoders, heatmap accuracy, the three lr schedules, the EMA
update and the training BatchNorm (simple_pose_torch/ops/heatmap.py,
metrics/acc.py, train/schedules.py, train/ema.py, models/layers.py)."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.metrics.acc import heatmap_accuracy
from simple_pose_torch.models.layers import batch_norm
from simple_pose_torch.ops.decode import heatmap_to_coords
from simple_pose_torch.ops.heatmap import encode_biased, encode_unbiased
from simple_pose_torch.train import schedules as TS
from simple_pose_torch.train.ema import ema_decay, ema_update
from simple_pose_tpu.metrics.acc import heatmap_accuracy as j_heatmap_accuracy
from simple_pose_tpu.ops import heatmap as JH
from simple_pose_tpu.ops.decode import heatmap_to_coords as j_heatmap_to_coords
from simple_pose_tpu.train import ema as JE
from simple_pose_tpu.train import schedules as JS

torch.set_num_threads(1)


def _joints(rng, b=3, k=17, w=48, h=64):
    """Joints in heatmap coordinates: in range, far out of bounds, just
    inside and just outside the 3-sigma boundary on every side, invisible
    (vis 0) and half-visible (vis 0.4: weighted but not rendered)."""
    j = np.zeros((b, k, 3), np.float32)
    j[..., 0] = rng.uniform(0, w, (b, k))
    j[..., 1] = rng.uniform(0, h, (b, k))
    j[..., 2] = 1.0
    j[0, 0, :2] = (-20.0, 10.0)        # far left
    j[0, 1, :2] = (10.0, h + 30.0)     # far below
    j[0, 2, :2] = (-6.9, 5.0)          # int(-6.9 + 7) = 0: in bounds
    j[0, 3, :2] = (-7.1, 5.0)          # int(-0.1) = 0 (trunc, not floor): in bounds
    j[0, 4, :2] = (-8.0, 5.0)          # br_x = int(-1.0) < 0: out
    j[0, 5, :2] = (w + 5.9, 5.0)       # ul_x = int(w - 0.1) < w: in bounds
    j[0, 6, :2] = (w + 6.0, 5.0)       # ul_x = w: out
    j[0, 7, :2] = (5.0, h + 6.0)       # ul_y = h: out
    j[1, 0, 2] = 0.0                   # invisible
    j[1, 1, 2] = 0.4                   # weight 0.4, no map
    j[2, :, :2] = np.round(j[2, :, :2]) + 0.5  # half-pixel centers (biased snap ties)
    return j


@pytest.mark.parametrize("kind", ["unbiased", "biased"])
def test_encoders_match_jax(kind):
    rng = np.random.default_rng(0)
    joints = _joints(rng)
    if kind == "unbiased":
        want = JH.encode_unbiased(jnp.asarray(joints), (64, 48))
        got = encode_unbiased(torch.from_numpy(joints), (64, 48))
    else:  # the biased encoder snaps input-space joints with stride 4
        joints[..., :2] *= 4.0
        want = JH.encode_biased(jnp.asarray(joints), (64, 48))
        got = encode_biased(torch.from_numpy(joints), (64, 48))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert got[1][0, :8].tolist() == np.asarray(want[1])[0, :8].tolist()


def test_heatmap_accuracy_matches_jax():
    """The same argmaxes (first maximum on ties) and the same counts, so the
    same per-joint accuracies; their f32 mean may differ in the last bit
    (sum order).  Predictions are targets with noise, shifted maps, flat
    maps and a batch where a joint has no valid label."""
    rng = np.random.default_rng(1)
    targets, _ = JH.encode_unbiased(jnp.asarray(_joints(rng, b=4)), (64, 48))
    targets = np.array(targets)
    preds = targets + rng.normal(0, 0.3, targets.shape).astype(np.float32)
    preds[1] = np.roll(targets[1], 3, axis=-1)
    preds[2, :4] = 0.0  # flat: argmax 0, coords zeroed
    targets[:, 5] = 0.0  # joint 5 has no valid label anywhere
    coords, _ = heatmap_to_coords(torch.from_numpy(preds))
    np.testing.assert_array_equal(coords.numpy(), np.asarray(j_heatmap_to_coords(preds)[0]))
    for p, t in ((preds, targets), (targets, targets), (preds[:1], targets[:1])):
        want = float(j_heatmap_accuracy(jnp.asarray(p), jnp.asarray(t)))
        got = heatmap_accuracy(torch.from_numpy(p), torch.from_numpy(t))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(got.item() - want) <= 2.0**-23 * max(want, 1e-3)


def _sweep(spe, epochs):
    return list(range(0, spe * (epochs + 1) + 1))


@pytest.mark.parametrize("warmup_start", [0.0, 0.1])
def test_schedules_match_jax(warmup_start):
    spe, epochs = 4, 8
    pairs = [
        (JS.multistep_schedule(1e-3, [2, 5], 0.1, spe),
         TS.multistep_schedule(1e-3, [2, 5], 0.1, spe)),
        (JS.warmup_cosine_multistep_schedule(1e-3, epochs, [3, 6], spe, 1, alpha=0.1,
                                             warmup_start=warmup_start),
         TS.warmup_cosine_multistep_schedule(1e-3, epochs, [3, 6], spe, 1, alpha=0.1,
                                             warmup_start=warmup_start)),
        (JS.warmup_cosine_multistep_schedule(1e-3, epochs, [3, epochs], spe, 2, gamma=2.0,
                                             warmup_start=warmup_start),
         TS.warmup_cosine_multistep_schedule(1e-3, epochs, [3, epochs], spe, 2, gamma=2.0,
                                             warmup_start=warmup_start)),
        (JS.epoch_warmup_cosine_schedule(1e-3, epochs, spe, 2, warmup_start=warmup_start),
         TS.epoch_warmup_cosine_schedule(1e-3, epochs, spe, 2, warmup_start=warmup_start)),
    ]
    for j_sched, t_sched in pairs:
        for step in _sweep(spe, epochs):
            want = float(j_sched(jnp.asarray(step, jnp.int32)))
            got = t_sched(step)
            assert isinstance(got, float)
            # JAX evaluates in f32, the port in f64
            assert got == pytest.approx(want, rel=1e-6, abs=1e-9), (step, got, want)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(2)
    shapes = [(3, 4), (7,), (2, 3, 3, 1)]
    ema = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    new = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    for updates in (1, 7, 2000, 50000):
        # 1 - exp(-n/2000) in f32: one ulp of exp near 1 (6e-8) is the error
        # of either framework's exp
        assert abs(ema_decay(updates) - float(JE.ema_decay(jnp.float32(updates)))) < 1.2e-7
        want = JE.ema_update(ema, new, updates)
        got = [torch.from_numpy(e.copy()) for e in ema]
        ema_update(got, [torch.from_numpy(n) for n in new], updates)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=5e-7)


def test_training_batch_norm_matches_flax():
    """n = 8 values per channel (2 samples of 2x2): output and running
    statistics after two updates, against flax nn.BatchNorm (momentum 0.9,
    the biased batch variance).  torch's own BatchNorm2d would move
    running_var 8/7 further."""
    rng = np.random.default_rng(3)
    c = 6
    xs = [rng.normal(rng.uniform(-2, 2, c), rng.uniform(0.2, 3, c), (2, 2, 2, c))
          .astype(np.float32) for _ in range(2)]
    mean0 = rng.normal(0, 0.5, c).astype(np.float32)
    var0 = rng.uniform(0.5, 2, c).astype(np.float32)
    scale = rng.normal(1, 0.2, c).astype(np.float32)
    bias = rng.normal(0, 0.2, c).astype(np.float32)

    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    bn = batch_norm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    for x in xs:
        want, upd = fm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 2
