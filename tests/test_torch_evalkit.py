"""Port serving path (simple_pose_torch/evalkit) against the JAX package's
evaluator on the same weights, plus the port's package rules."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.evalkit.workflows import PoseEvaluator, load_model_variables, predicts_by_gt
from simple_pose_tpu.evalkit import workflows as jwf
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50 = {"type": "pose_resnet_dconv", "name": "resnet50", "num_joints": 17}
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
WIDE50 = {"type": "pose_resnet_dconv", "name": "wide_resnet50_2", "num_joints": 17}


def _batch(b=2, canvas=128, out=64):
    rng = np.random.default_rng(0)
    s = canvas / out
    return {
        "canvas": rng.integers(0, 255, (b, canvas, canvas, 3), dtype=np.uint8),
        "trans": np.tile(np.array([[1 / s, 0, 0], [0, 1 / s, 0]], np.float32), (b, 1, 1)),
        "trans_inv": np.tile(np.array([[4 * s, 0, 0], [0, 4 * s, 0]], np.float32), (b, 1, 1)),
    }


@pytest.mark.parametrize("flip_test", [False, True])
def test_fused_evaluator_matches_jax(flip_test):
    """fused_layer1=True, amp=False, resnet50 at 64x64: the same keypoints
    as the JAX evaluator (its Pallas chain in interpret mode) on its own
    weights (tolerances of tests/test_pallas_bottleneck.py:180-203)."""
    batch = _batch()
    jev = jwf.PoseEvaluator(R50, None, (64, 64), amp=False, fused_layer1=True,
                            flip_test=flip_test)
    want = jev(batch)
    ev = PoseEvaluator(R50, flax_to_torch_state(jev.variables), (64, 64), amp=False,
                       fused_layer1=True, flip_test=flip_test, device="cpu")
    got = ev(batch)
    assert got["kps"].shape == (2, 17, 2) and got["conf"].shape == (2, 17, 1)
    np.testing.assert_allclose(got["kps"].numpy(), np.asarray(want["kps"]), atol=0.15)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]), atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=2e-3)


def test_fused_evaluator_wide_layer1_matches_jax():
    """fused_layer1=True at layer1 width 128 (wide_resnet50_2, amp=False,
    64x64, batch 2): the same keypoints as the JAX evaluator on its own
    weights, with the tolerances of the test above."""
    batch = _batch()
    jev = jwf.PoseEvaluator(WIDE50, None, (64, 64), amp=False, fused_layer1=True)
    want = jev(batch)
    ev = PoseEvaluator(WIDE50, flax_to_torch_state(jev.variables), (64, 64), amp=False,
                       fused_layer1=True, device="cpu")
    assert ev._layer1_folded[0]["w2"].shape == (3, 3, 128, 128)
    got = ev(batch)
    np.testing.assert_allclose(got["kps"].numpy(), np.asarray(want["kps"]), atol=0.15)
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]), atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=2e-3)


def test_predicts_by_gt_matches_jax(tmp_path):
    """Both packages load one reference-layout .pth (['ema'] key): the port's
    state_dict keys are the ones the JAX package's converter reads."""
    img_root, ann_path, _ = make_synth_coco(str(tmp_path / "coco"), num_images=6)
    _, variables = jwf.load_model_variables(R18, None, (64, 64))
    pth = str(tmp_path / "r18.pth")
    torch.save({"ema": flax_to_torch_state(variables)}, pth)
    kw = dict(weights=pth, batch_size=4, input_shape=(64, 64), canvas=192, amp=False)
    want = jwf.predicts_by_gt(img_root, ann_path, R18, out_path=str(tmp_path / "j.json"), **kw)
    got = predicts_by_gt(img_root, ann_path, R18, out_path=str(tmp_path / "t.json"),
                         device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    rj = sorted(json.load(open(tmp_path / "j.json")), key=lambda r: r["image_id"])
    rt = sorted(json.load(open(tmp_path / "t.json")), key=lambda r: r["image_id"])
    assert len(rt) == len(rj) == 6
    kt = np.array([r["keypoints"] for r in rt]).reshape(6, 17, 3)
    kj = np.array([r["keypoints"] for r in rj]).reshape(6, 17, 3)
    # peak values agree closely; the seeded-init heatmaps are nearly flat
    # (~1e-7), so a few argmaxes flip between peaks tied to f32 sum order
    np.testing.assert_allclose(kt[..., 2], kj[..., 2], rtol=1e-4)
    close = np.abs(kt[..., :2] - kj[..., :2]).max(-1) < 0.15  # canvas px
    assert close.mean() >= 0.95, close.mean()


def test_evaluator_device_rules():
    """No device means CUDA, which raises without a GPU; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU rule")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseEvaluator(R18, None, (64, 64))
    with pytest.raises(ValueError, match="foldable"):
        PoseEvaluator(R18, None, (64, 64), fused_layer1=True, device="cpu")
    with pytest.raises(ValueError, match="dark_original"):
        PoseEvaluator(R18, None, (64, 64), decoder="dark_origin", device="cpu")
    assert PoseEvaluator(R18, None, (64, 64), decoder="dark_original", device="cpu")._decode is None


def test_load_model_variables_device_rule():
    """None means CUDA, as in every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU rule")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model_variables(R18)
    model = load_model_variables(R18, device="cpu")
    assert not model.training and {p.device.type for p in model.parameters()} == {"cpu"}


def test_eval_cli_gt(tmp_path):
    img_root, ann_path, _ = make_synth_coco(str(tmp_path / "coco"), num_images=3)
    out = tmp_path / "gt.json"
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.eval", "gt", "--img-root", img_root,
         "--ann", ann_path, "--model-name", "resnet50", "--reduction", "--fused-layer1",
         "--flip-test", "--batch-size", "2", "--input-w", "64", "--input-h", "64",
         "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "AP" in stats and len(json.load(open(out))) == 3


@pytest.mark.parametrize("model", [("pose_hrnet", "w32"), ("pose_resnet_duc", "resnet50")])
def test_eval_cli_gt_other_families(tmp_path, model):
    """``--model-type pose_hrnet --model-name w32`` and ``pose_resnet_duc``
    with the fused layer1 and flip-test, end to end on the CPU."""
    img_root, ann_path, _ = make_synth_coco(str(tmp_path / "coco"), num_images=2)
    out = tmp_path / "gt.json"
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.eval", "gt", "--img-root", img_root,
         "--ann", ann_path, "--model-type", model[0], "--model-name", model[1],
         "--fused-layer1", "--flip-test", "--batch-size", "2", "--input-w", "64",
         "--input-h", "64", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "AP" in stats and len(json.load(open(out))) == 2


_GUARD = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "simple_pose_tpu", "cv2"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import simple_pose_torch
mods = [m.name for m in pkgutil.walk_packages(simple_pose_torch.__path__, "simple_pose_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
# the native path reads JPEGs and decodes dark_original without cv2
from simple_pose_torch.data.coco import load_detection_boxes
from simple_pose_torch.data.pipeline import DetBoxPipeline
from simple_pose_torch.ops.decode import decode_dark_original
det = "tests/data_torch_jpeg/det"
recs = load_detection_boxes(det + "/images", det + "/detections.json", debug=8)
batch = next(iter(DetBoxPipeline(recs, 8, use_native=True, dedup_canvases=4).epoch(0)))
assert batch["canvas"].shape == (4, 640, 640, 3) and batch["canvas"].any()
kps, conf = decode_dark_original(np.random.default_rng(0).random((2, 17, 64, 48)),
                                 batch["trans_inv"][:2])
assert np.isfinite(kps).all()
print(len(mods))
"""


def test_port_imports_nothing_of_jax():
    """No module of the port and no part of chip_smoke.py imports jax or the
    JAX package, and nothing of the native JPEG path imports cv2."""
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 17
