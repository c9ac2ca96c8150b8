"""Port models (simple_pose_torch/models) against the flax models on the same
weights, carried by convert/from_jax.flax_to_torch_state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.models.registry import build_model
from simple_pose_torch.models.resnet import PoseResNet, build_resnet
from simple_pose_torch.ops.bottleneck_chain import fold_bottleneck_blocks
from simple_pose_tpu.convert.torch2flax import convert_torch_state, merge_converted
from simple_pose_tpu.models.resnet import PoseResNet as FlaxPoseResNet
from simple_pose_tpu.models.resnet import build_resnet as flax_build_resnet

torch.set_num_threads(1)

HEAT_REL = 1e-4  # f32: the two frameworks sum convolutions in another order


def _randomize_bn(variables, seed):
    """Random running stats and BN affines, so folding is non-trivial and
    eval activations stay normalized (as tests/test_pallas_bottleneck.py)."""
    r = np.random.default_rng(seed)

    def stat(path, leaf):
        key = path[-1].key
        if key == "mean":
            return r.normal(0, 0.3, leaf.shape).astype(np.float32)
        if key == "var":
            return r.uniform(1.0, 4.0, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    def param(path, leaf):
        keys = [p.key for p in path]
        if any("bn" in k for k in keys) and keys[-1] in ("scale", "bias"):
            base = 1.0 if keys[-1] == "scale" else 0.0
            return (base + r.normal(0, 0.2, leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return {"params": jax.tree_util.tree_map_with_path(param, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


_MODELS = {
    "bottleneck_2111_se": (lambda: FlaxPoseResNet(block="bottleneck", layers=(2, 1, 1, 1),
                                                  se=True),
                           lambda: PoseResNet(block="bottleneck", layers=(2, 1, 1, 1), se=True)),
    "resnet50_se": (lambda: flax_build_resnet("resnet50", se=True),
                    lambda: build_resnet("resnet50", se=True)),
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


def test_heatmaps_match_flax(pair):
    fm, variables, tm, x = pair
    want = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < HEAT_REL


def test_state_round_trips_through_jax_converter(pair):
    """flax -> torch state -> the JAX package's convert_torch_state +
    merge_converted gives back the same flax variables, leaf for leaf."""
    _, variables, _, _ = pair
    converted, skipped = convert_torch_state(flax_to_torch_state(variables), "resnet")
    assert all(k.endswith("num_batches_tracked") for k in skipped)
    merged, missing, unexpected = merge_converted(variables, converted)
    assert not missing and not unexpected
    flat_a = jax.tree_util.tree_leaves_with_path(merged)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_b[path]))


def test_fused_forward_matches_unfused(pair):
    _, _, tm, x = pair
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = tm(xt)
        got = tm(xt, layer1_folded=fold_bottleneck_blocks(list(tm.layer1)))
    assert (got - want).abs().max() / want.abs().max() < HEAT_REL


def test_layer1_block_names_and_registry():
    assert build_resnet("resnet50").layer1_block_names() == ["layer1.0", "layer1.1", "layer1.2"]
    assert build_resnet("resnet18").layer1_block_names() is None  # BasicBlock
    assert build_resnet("resnext50_32x4d").layer1_block_names() is None  # grouped
    hrnet = build_model("pose_hrnet", "w32")
    assert hrnet.layer1_block_names() == ["layer1.0", "layer1.1", "layer1.2", "layer1.3"]
    duc = build_model("pose_resnet_duc", "resnet50")
    assert duc.head == "duc" and duc.layer1_block_names() == ["layer1.0", "layer1.1", "layer1.2"]
    with pytest.raises(KeyError):
        build_model("nope")
