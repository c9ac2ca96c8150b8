"""The port's detector-box eval (simple_pose_torch data/coco.load_detection_boxes,
data/pipeline.DetBoxPipeline, ops/decode.decode_dark_original, evalkit
predicts_by_detections and rescore_and_filter, eval.py detections/rescore)
against the JAX package on the same numpy-seeded inputs and weights."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import flax_to_torch_state
from simple_pose_torch.data import coco as tcoco
from simple_pose_torch.data import pipeline as tpipe
from simple_pose_torch.evalkit import workflows as twf
from simple_pose_torch.ops.decode import decode_dark_original
from simple_pose_torch.ops.heatmap import encode_unbiased
from simple_pose_tpu.data import coco as jcoco
from simple_pose_tpu.data import pipeline as jpipe
from simple_pose_tpu.evalkit import workflows as jwf
from simple_pose_tpu.ops import decode as jdecode
from tests.util_synth import make_synth_coco

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "tests", "data_torch_jpeg", "det")
DET_IMAGES = os.path.join(DET, "images")
DET_JSON = os.path.join(DET, "detections.json")
DET_GT = os.path.join(DET, "person_keypoints.json")
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
# keypoints of the seeded-init model may sit on argmax ties of near-flat
# heatmaps (f32 sum order picks another peak); at most this share may
# differ by more than KP_TOL canvas pixels
KP_TOL, TIE_SHARE = 0.15, 0.03


@pytest.mark.parametrize("debug", [0, 7])
def test_load_detection_boxes_matches_jax(debug):
    want = jcoco.load_detection_boxes(DET_IMAGES, DET_JSON, debug=debug)
    got = tcoco.load_detection_boxes(DET_IMAGES, DET_JSON, debug=debug)
    assert [vars(r) for r in got] == [vars(r) for r in want]
    assert len(got) == (debug or 176)
    assert all(r.img_path.endswith(f"{r.img_id:012d}.jpg") for r in got)


@pytest.mark.parametrize("dedup", [True, False])
def test_detbox_pipeline_matches_jax(dedup):
    """Exactly equal batches, area and score included, on the committed
    640x480 JPEGs (both through their native loaders)."""
    kw = dict(batch_size=32, input_shape=(192, 256), output_shape=(48, 64), canvas=640,
              num_threads=2, use_native=True)
    if dedup:
        kw["dedup_canvases"] = 16
    jp = jpipe.DetBoxPipeline(jcoco.load_detection_boxes(DET_IMAGES, DET_JSON), **kw)
    tp = tpipe.DetBoxPipeline(tcoco.load_detection_boxes(DET_IMAGES, DET_JSON), **kw)
    want, got = list(jp.epoch(0)), list(tp.epoch(0))
    assert len(got) == len(want) >= 6
    for bw, bt in zip(want, got):
        assert set(bt) == set(bw) >= {"area", "score", "canvas"}
        for k in bw:
            assert bt[k].dtype == bw[k].dtype and bt[k].shape == bw[k].shape, k
            np.testing.assert_array_equal(bt[k], bw[k], err_msg=k)
    valid = np.concatenate([b["valid"] for b in got]) > 0.5
    assert valid.sum() == 176 and (np.concatenate([b["area"] for b in got])[valid] > 0).all()


def _raw_predictions(seed=0):
    """Seeded raw predictions for the committed detections: one pattern of
    joints per image, placed in each box (so the jittered boxes of one
    person give near poses that OKS-NMS suppresses), confidences in [0, 1]."""
    rng = np.random.default_rng(seed)
    preds = []
    for r in tcoco.load_detection_boxes(DET_IMAGES, DET_JSON):
        x1, y1, x2, y2 = r.box
        fx, fy = np.random.default_rng(r.img_id).uniform(0, 1, (2, 17))
        kps = np.stack([x1 + fx * (x2 - x1), y1 + fy * (y2 - y1), rng.uniform(0, 1, 17)], -1)
        preds.append({"kps": kps.reshape(-1).tolist(), "area": float((x2 - x1) * (y2 - y1)),
                      "score": float(r.score), "img_id": int(r.img_id)})
    return preds


def test_rescore_and_filter_matches_jax(tmp_path):
    preds = _raw_predictions()
    raw = str(tmp_path / "raw.json")
    with open(raw, "w") as f:
        json.dump(preds, f)
    want = jwf.rescore_and_filter(raw, DET_GT, out_path=str(tmp_path / "j.json"))
    got = twf.rescore_and_filter(raw, DET_GT, out_path=str(tmp_path / "t.json"))
    assert got == want
    with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
        jf, tf = json.load(f), json.load(g)
    assert tf == jf and 0 < len(tf) < len(preds)
    assert twf.rescore_and_filter(preds, DET_GT, out_path=str(tmp_path / "l.json")) == got


def _synth_detections(tmp_path):
    """A small synthetic set and a detection JSON of 1-3 jittered boxes per
    person and a false positive per image."""
    img_root, ann_path, gt = make_synth_coco(str(tmp_path / "coco"), num_images=6,
                                             people_per_image=[1, 2, 1, 2, 1, 1], seed=5)
    rng = np.random.default_rng(9)
    dets = []
    for a in gt["annotations"]:
        x, y, w, h = a["bbox"]
        for k in range(1 + int(rng.integers(0, 3))):
            j = rng.normal(0, 0.03 if k == 0 else 0.12, 4) * [w, h, w, h]
            dets.append({"image_id": a["image_id"], "category_id": 1,
                         "score": float(rng.uniform(0.3, 0.99)),
                         "bbox": [float(x + j[0]), float(y + j[1]), float(w + j[2]),
                                  float(h + j[3])]})
    for img in gt["images"]:
        dets.append({"image_id": img["id"], "category_id": 1, "score": 0.1,
                     "bbox": [5.0, 5.0, 40.0, 60.0]})
    det_path = str(tmp_path / "dets.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return img_root, ann_path, det_path, len(dets)


@pytest.fixture(scope="module")
def r18_weights(tmp_path_factory):
    _, variables = jwf.load_model_variables(R18, None, (64, 64))
    pth = str(tmp_path_factory.mktemp("w") / "r18.pth")
    torch.save({"ema": flax_to_torch_state(variables)}, pth)
    return pth


def _keypoints(path):
    with open(path) as f:
        preds = sorted(json.load(f), key=lambda p: (p["img_id"], p["score"], p["area"]))
    return np.array([p["kps"] for p in preds]).reshape(len(preds), 17, 3)


@pytest.mark.parametrize("decoder", ["gauss_taylor", "dark_original"])
def test_predicts_by_detections_matches_jax(tmp_path, monkeypatch, r18_weights, decoder):
    img_root, ann_path, det_path, n_dets = _synth_detections(tmp_path)
    kw = dict(weights=r18_weights, batch_size=4, input_shape=(64, 64), canvas=192, amp=False,
              decoder=decoder)
    monkeypatch.chdir(tmp_path)  # the JAX workflow writes ./filter_kps_predicts.json
    want = jwf.predicts_by_detections(img_root, det_path, ann_path, R18,
                                      out_path=str(tmp_path / "j.json"), **kw)
    got = twf.predicts_by_detections(img_root, det_path, ann_path, R18,
                                     out_path=str(tmp_path / "t.json"), device="cpu",
                                     filtered_out_path=str(tmp_path / "t_filtered.json"), **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    kj, kt = _keypoints(tmp_path / "j.json"), _keypoints(tmp_path / "t.json")
    assert kt.shape == kj.shape == (n_dets, 17, 3)
    np.testing.assert_allclose(kt[..., 2], kj[..., 2], rtol=1e-4)
    close = np.abs(kt[..., :2] - kj[..., :2]).max(-1) < KP_TOL
    assert close.mean() >= 1 - TIE_SHARE, close.mean()
    with open(tmp_path / "t_filtered.json") as f:
        assert 0 < len(json.load(f)) <= n_dets


def _dark_inputs(case, rng, b=3, c=17, h=64, w=48):
    if case == "zero":
        return np.zeros((b, c, h, w), np.float32)
    joints = np.zeros((b, c, 3), np.float32)
    if case == "peaky":
        joints[..., 0] = rng.uniform(2, w - 3, (b, c))
        joints[..., 1] = rng.uniform(2, h - 3, (b, c))
    else:  # peaks on and next to the border, where the refinement is skipped
        joints[..., 0] = rng.choice([0.0, 1.0, w - 2.0, w - 1.0, w / 2], (b, c))
        joints[..., 1] = rng.choice([0.0, 1.0, h - 2.0, h - 1.0], (b, c))
    joints[..., 2] = 1
    heat, _ = encode_unbiased(torch.from_numpy(joints), (h, w))
    return heat.numpy() + rng.normal(0, 1e-3, (b, c, h, w)).astype(np.float32)


@pytest.mark.parametrize("case", ["peaky", "border", "zero"])
def test_decode_dark_original_matches_jax(case):
    rng = np.random.default_rng({"peaky": 0, "border": 1, "zero": 2}[case])
    heat = _dark_inputs(case, rng)
    trans_inv = rng.normal(0, 1, (heat.shape[0], 2, 3)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        want_kps, want_conf = jdecode.decode_dark_original(heat, trans_inv)
    got_kps, got_conf = decode_dark_original(heat, trans_inv)
    assert got_kps.dtype == np.float32 and got_kps.shape == (3, 17, 2)
    assert np.isfinite(got_kps).all()
    np.testing.assert_array_equal(got_conf, want_conf)
    np.testing.assert_allclose(got_kps, want_kps, atol=1e-4, rtol=0)
    if case == "zero":  # no peak: the keypoint is trans_inv's image of (0, 0)
        origin = np.broadcast_to(trans_inv[:, None, :, 2], got_kps.shape)
        np.testing.assert_allclose(got_kps, origin)


def test_eval_cli_detections_and_rescore(tmp_path, r18_weights):
    """`detections` then `rescore` on its raw predictions: the same stats."""
    img_root, ann_path, det_path, _ = _synth_detections(tmp_path)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}

    def cli(*args):
        proc = subprocess.run([sys.executable, "-m", "simple_pose_torch.eval", *args],
                              cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    stats = cli("detections", "--img-root", img_root, "--ann", ann_path, "--dets", det_path,
                "--model-name", "resnet18", "--weights", r18_weights, "--batch-size", "4",
                "--input-w", "64", "--input-h", "64", "--decoder", "dark_original",
                "--flip-test", "--device", "cpu", "--out", "raw.json")
    filtered = json.load(open(tmp_path / "filter_kps_predicts.json"))
    again = cli("rescore", "--preds", "raw.json", "--ann", ann_path)
    assert "AP" in stats and again == stats
    assert json.load(open(tmp_path / "filter_kps_predicts.json")) == filtered
