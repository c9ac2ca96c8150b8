"""The port's HRNet (simple_pose_torch/models/hrnet.py) against the flax
PoseHRNet on the same weights, carried by convert/from_jax: heatmaps, the
state_dict round trip through the JAX package's converter, the fused layer1
(the K2 plain version against JAX's Pallas chain in interpret mode), the
train step, ``predicts_by_gt`` and ``model.remat``.

Two topologies: the full W32 (four stages, 4-block layer1) on a 64x64 input
(the branches halve three times from 16x16, so each side must be a multiple
of 32), and a narrow one (c=4, 2-block layer1, two stages, a 3x3 final
conv) on 64x48."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_pose_torch.models.resnet as R
from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.evalkit.workflows import PoseEvaluator, predicts_by_gt
from simple_pose_torch.models.hrnet import HRNET_W32_CFG, PoseHRNet, build_hrnet
from simple_pose_torch.models.registry import build_model
from simple_pose_torch.ops.bottleneck_chain import fold_bottleneck_blocks
from simple_pose_torch.train.solver import init_train_state, make_train_step
from simple_pose_tpu.convert.torch2flax import convert_torch_state, merge_converted
from simple_pose_tpu.evalkit import workflows as jwf
from simple_pose_tpu.models.hrnet import PoseHRNet as FlaxPoseHRNet
from simple_pose_tpu.ops.pallas_bottleneck import fold_bottleneck_blocks as jax_fold
from tests import torch_train_pair as P
from tests.test_torch_models import _randomize_bn
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

HEAT_REL = 1e-4  # f32: the two frameworks sum convolutions in another order

NARROW_CFG = {
    "FINAL_CONV_KERNEL": 3,
    "LAYER1_NUM_BLOCKS": 2,
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
               "NUM_BLOCKS": [2, 2], "NUM_CHANNELS": [4, 8], "FUSE_METHOD": "SUM"},
    "STAGE3": {"NUM_MODULES": 2, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
               "NUM_BLOCKS": [2, 2, 2], "NUM_CHANNELS": [4, 8, 16], "FUSE_METHOD": "SUM"},
}
_MODELS = {"w32": (HRNET_W32_CFG, (64, 64)), "narrow": (NARROW_CFG, (64, 48))}


@pytest.fixture(scope="module", params=sorted(_MODELS))
def pair(request):
    """(flax model, its randomized variables, port model loaded with them, x)."""
    cfg, hw = _MODELS[request.param]
    fm = FlaxPoseHRNet(cfg=cfg)
    x = np.random.default_rng(0).normal(0, 1, (1,) + hw + (3,)).astype(np.float32)
    variables = _randomize_bn(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    tm = PoseHRNet(cfg=cfg).eval()
    tm.load_state_dict(flax_to_torch_state(variables), strict=True)
    return fm, variables, tm, x


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_heatmaps_match_flax(pair):
    fm, variables, tm, x = pair
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (1, 17, x.shape[1] // 4, x.shape[2] // 4)
    assert _rel(got, want) < HEAT_REL


def test_state_round_trips_through_jax_converter(pair):
    """flax -> torch state -> the JAX package's convert_torch_state(...,
    'hrnet') + merge_converted gives back the flax variables leaf for leaf:
    the port's module paths are the reference's key names."""
    _, variables, tm, _ = pair
    state = flax_to_torch_state(variables)
    assert set(state) == set(tm.state_dict())
    converted, skipped = convert_torch_state(state, "hrnet")
    assert all(k.endswith("num_batches_tracked") for k in skipped)
    merged, missing, unexpected = merge_converted(variables, converted)
    assert not missing and not unexpected
    flat_a = jax.tree_util.tree_leaves_with_path(merged)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_fused_layer1_matches_jax(pair):
    """The port's fused path (the plain K2 version on the CPU) against JAX's
    apply(..., layer1_folded=...), whose Pallas chain runs in interpret mode
    on the CPU (tests/test_pallas_bottleneck.py)."""
    fm, variables, tm, x = pair
    names = tm.layer1_block_names()
    assert names == [f"layer1.{i}" for i in range(fm.cfg.get("LAYER1_NUM_BLOCKS", 4))]
    folded = fold_bottleneck_blocks([tm.get_submodule(n) for n in names])
    assert "wd" in folded[0] and not any("sf1" in blk for blk in folded)
    jfolded = jax_fold(variables["params"], variables["batch_stats"], fm.layer1_block_names())
    want = np.asarray(fm.apply(variables, jnp.asarray(x), layer1_folded=jfolded))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), layer1_folded=folded).numpy()
    assert _rel(got, want.transpose(0, 3, 1, 2)) < HEAT_REL


def test_build_hrnet_configs(tmp_path):
    """'w32', 'w48', a dict and a JSON file with MODEL.EXTRA (no PyYAML)."""
    import json

    path = tmp_path / "hrnet.json"
    path.write_text(json.dumps({"MODEL": {"EXTRA": NARROW_CFG}}))
    narrow = build_hrnet(str(path))
    assert narrow.cfg == NARROW_CFG and narrow.final_layer.kernel_size == (3, 3)
    w48 = build_model("pose_hrnet", "w48")
    assert w48.final_layer.in_channels == 48 and not w48.training
    assert len(w48.stage4) == 3 and len(w48.stage4[-1].fuse_layers) == 1
    assert len(w48.stage3[-1].fuse_layers) == 3  # not the last stage: every output kept


# -- training ------------------------------------------------------------------


def _narrow_config(**optim):
    cfg = P.config(**optim)
    cfg["model"].update(type="pose_hrnet", name=copy.deepcopy(NARROW_CFG))
    return cfg


def test_train_step_matches_jax(monkeypatch):
    """make_train_step with the narrow HRNet against JAX's: the scheme and
    tolerances of tests/test_torch_train.py (loss 1e-4 relative, each tensor
    |port - jax| / |jax update| <= 1e-2), K1's plain version against
    Pallas in interpret mode."""
    P.jax_crops_as_tested(monkeypatch)
    metrics, before, model_pair, ema_pair, (_, _, tstate) = P.run_steps(_narrow_config(), 3)
    assert isinstance(tstate.model, PoseHRNet)
    print("losses (jax, port):", [(m["jax_loss"], m["loss"]) for m in metrics])
    P.check_metrics(metrics)
    P.check_trees(before, model_pair, ema_pair)


def test_pretrained_loads_reference_checkpoint(tmp_path):
    """model.pretrained with a reference-layout HRNet .pth (['ema'] key,
    'module.' prefixes): every weight and BN statistic lands."""
    src = build_hrnet(NARROW_CFG, seed=5)
    pth = str(tmp_path / "hrnet.pth")
    torch.save({"ema": {f"module.{k}": v for k, v in src.state_dict().items()}}, pth)
    cfg = {"model": {"type": "pose_hrnet", "name": NARROW_CFG, "pretrained": pth},
           "optim": {"amp": False}}
    model = init_train_state(cfg, device="cpu").model
    want = src.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _remat_step(remat):
    cfg = {"model": {"type": "pose_hrnet", "name": NARROW_CFG, "remat": remat},
           "optim": {"amp": False}, "data": {"input_shape": [64, 64]}}
    state = init_train_state(cfg, device="cpu")
    step = make_train_step((16, 16), (64, 64))
    state, _ = step(state, P.make_batch(1))  # Adam moments set
    state, m = step(state, P.make_batch(2))
    return m["loss"].item(), state.model.state_dict()


def test_remat_matches_no_remat(monkeypatch):
    """model.remat on HRNet checkpoints layer1's and every branch's blocks,
    with the same loss and the same BN statistics as without (the recompute
    leaves them alone)."""
    loss_off, sd_off = _remat_step(False)
    calls = []
    orig = R.checkpoint

    def counted(fn, x, **kw):
        calls.append(fn)
        return orig(fn, x, **kw)

    monkeypatch.setattr(R, "checkpoint", counted)
    loss_on, sd_on = _remat_step(True)
    # per forward: 2 layer1 blocks, stage2 2 x 2, stage3 2 modules x 3 x 2
    assert len(calls) == 2 * (2 + 4 + 12)
    assert abs(loss_on / loss_off - 1) <= 1e-6
    for k, v in sd_off.items():
        if "running_" in k or "num_batches" in k:
            assert torch.equal(sd_on[k], v), k
        else:
            assert ((sd_on[k] - v).abs().max() / v.abs().max().clamp_min(1e-12)).item() <= 1e-6, k
    monkeypatch.setattr(R, "_recompute_contexts",
                        lambda block: (contextlib.nullcontext(), contextlib.nullcontext()))
    _, sd_twice = _remat_step(True)
    assert sd_twice["stage3.1.branches.2.1.bn2.num_batches_tracked"] == 2 * sd_off[
        "stage3.1.branches.2.1.bn2.num_batches_tracked"]


# -- serving -------------------------------------------------------------------


def test_predicts_by_gt_matches_jax(tmp_path):
    """Both packages load one reference-layout .pth (['ema'] key) of the
    narrow HRNet: COCO stats within 0.005 (tests/test_torch_evalkit.py)."""
    img_root, ann_path, _ = make_synth_coco(str(tmp_path / "coco"), num_images=6)
    cfg = {"type": "pose_hrnet", "name": NARROW_CFG, "num_joints": 17}
    _, variables = jwf.load_model_variables(cfg, None, (64, 64))
    pth = str(tmp_path / "hrnet.pth")
    torch.save({"ema": flax_to_torch_state(_randomize_bn(variables, 3))}, pth)
    kw = dict(weights=pth, batch_size=4, input_shape=(64, 64), canvas=192, amp=False,
              flip_test=True)
    want = jwf.predicts_by_gt(img_root, ann_path, cfg, out_path=str(tmp_path / "j.json"), **kw)
    got = predicts_by_gt(img_root, ann_path, cfg, out_path=str(tmp_path / "t.json"),
                         device="cpu", fused_layer1=True, **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    ev = PoseEvaluator(cfg, pth, (64, 64), amp=False, fused_layer1=True, device="cpu")
    assert len(ev._layer1_folded) == 2
