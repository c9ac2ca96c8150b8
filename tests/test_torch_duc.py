"""The port's DUC head (simple_pose_torch/models/layers.DUC and
PoseResNet(head='duc')) against the flax model on the same weights, carried
by convert/from_jax: the DUC layer, heatmaps, the state_dict round trip
through the JAX package's converter, the fused layer1 (the K2 plain version
against JAX's Pallas chain in interpret mode) and the train step.

ResNet-50-DUC is configs/fast_pose_duc.yaml's model (no SE: its layer1 is 3
blocks, a projection without SE in block 0); Bottleneck (2,1,1,1) with SE
puts SE in block 0's projection.  Inputs are 64x64: the trunk halves each
side five times and the head doubles it three times, so a side must be a
multiple of 32 for the heatmaps to be a quarter of the input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.models.layers import DUC
from simple_pose_torch.models.registry import build_model
from simple_pose_torch.models.resnet import PoseResNet, build_resnet
from simple_pose_torch.ops.bottleneck_chain import fold_bottleneck_blocks
from simple_pose_tpu.convert.torch2flax import convert_torch_state, merge_converted
from simple_pose_tpu.models.layers import DUC as FlaxDUC
from simple_pose_tpu.models.resnet import PoseResNet as FlaxPoseResNet
from simple_pose_tpu.models.resnet import build_resnet as flax_build_resnet
from simple_pose_tpu.ops.pallas_bottleneck import fold_bottleneck_blocks as jax_fold
from tests import torch_train_pair as P
from tests.test_torch_models import _randomize_bn

torch.set_num_threads(1)

HEAT_REL = 1e-4  # f32: the two frameworks sum convolutions in another order

_MODELS = {
    "resnet50_duc": (lambda: flax_build_resnet("resnet50", head="duc"),
                     lambda: build_resnet("resnet50", head="duc")),
    "bottleneck_2111_se_duc": (
        lambda: FlaxPoseResNet(block="bottleneck", layers=(2, 1, 1, 1), se=True, head="duc"),
        lambda: PoseResNet(block="bottleneck", layers=(2, 1, 1, 1), se=True, head="duc")),
}


@pytest.fixture(scope="module", params=sorted(_MODELS))
def pair(request):
    """(flax model, its randomized variables, port model loaded with them, x)."""
    make_flax, make_torch = _MODELS[request.param]
    fm = make_flax()
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    variables = _randomize_bn(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    tm = make_torch().eval()
    tm.load_state_dict(flax_to_torch_state(variables), strict=True)
    return fm, variables, tm, x


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_duc_layer_matches_flax():
    """conv3x3 -> BN -> ReLU -> PixelShuffle(2): nn.PixelShuffle keeps the
    channel order of the JAX pixel_shuffle."""
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 6, 12)).astype(np.float32)
    fm = FlaxDUC(planes=16)
    variables = _randomize_bn(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    want = np.asarray(fm.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    tm = DUC(12, 16).eval()
    state = {k.removeprefix("duc_layers.1."): v for k, v in flax_to_torch_state(
        {c: {"duc_1": t} for c, t in variables.items()}).items()}
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 4, 10, 12)
    assert _rel(got, want) < HEAT_REL


def test_heatmaps_match_flax(pair):
    fm, variables, tm, x = pair
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (1, 17, 16, 16)
    assert _rel(got, want) < HEAT_REL


def test_state_round_trips_through_jax_converter(pair):
    """flax -> torch state -> the JAX package's convert_torch_state(...,
    'resnet') + merge_converted gives back the flax variables leaf for leaf
    (``duc_layers.{1,2}.{conv,bn}`` <-> ``duc_{1,2}/{conv,bn}``)."""
    _, variables, tm, _ = pair
    state = flax_to_torch_state(variables)
    assert set(state) == set(tm.state_dict())
    assert "duc_layers.2.bn.running_var" in state and "final_layer.bias" in state
    converted, skipped = convert_torch_state(state, "resnet")
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
    apply(..., layer1_folded=...) with the Pallas chain in interpret mode."""
    fm, variables, tm, x = pair
    names = tm.layer1_block_names()
    folded = fold_bottleneck_blocks([tm.get_submodule(n) for n in names])
    assert "wd" in folded[0] and ("sf1" in folded[0]) == (tm.layer1[0].se is not None)
    jfolded = jax_fold(variables["params"], variables["batch_stats"], fm.layer1_block_names())
    want = np.asarray(fm.apply(variables, jnp.asarray(x), layer1_folded=jfolded))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), layer1_folded=folded).numpy()
    assert _rel(got, want.transpose(0, 3, 1, 2)) < HEAT_REL


def test_registry_builds_fast_pose_duc():
    """configs/fast_pose_duc.yaml's model: ResNet-50, no SE, the DUC head."""
    model = build_model("pose_resnet_duc", "resnet50", reduction=False)
    assert model.head == "duc" and not hasattr(model, "deconv_layers")
    assert model.layer1_block_names() == ["layer1.0", "layer1.1", "layer1.2"]
    assert model.layer1[0].se is None and model.layer1[0].downsample is not None
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 256, 192))
    assert out.shape == (1, 17, 64, 48)


def test_train_step_matches_jax(monkeypatch):
    """make_train_step with ResNet-18-DUC against JAX's: the scheme and
    tolerances of tests/test_torch_train.py."""
    P.jax_crops_as_tested(monkeypatch)
    cfg = P.config()
    cfg["model"]["type"] = "pose_resnet_duc"
    metrics, before, model_pair, ema_pair, (_, _, tstate) = P.run_steps(cfg, 3)
    assert tstate.model.head == "duc"
    print("losses (jax, port):", [(m["jax_loss"], m["loss"]) for m in metrics])
    P.check_metrics(metrics)
    P.check_trees(before, model_pair, ema_pair)
