"""The port's detect -> pose programs (simple_pose_torch/ops/affine_device,
evalkit/fused.FusedDetectPose and fused_eval, evalkit/workflows.
gen_detections and detect_then_pose, the gen-dets/fused/e2e CLI) against
the JAX package on the same numpy-seeded inputs and weights.

The seeded detector's scores sit near its prior, so candidates differ by
~1e-6 and a 1e-9 difference in pred can change which of two near-equal
candidates NMS keeps.  The stages are therefore held apart: pred against
JAX, NMS on the same pred, the pose stage on the same boxes.  End to end,
only detections whose score clears every other candidate's by more than
the measured pred difference are compared.  The pose weights are seeded
with unit-variance kernels so that the heatmaps have distinct peaks, as a
trained model's do (a flat map's argmax sits on sum-order ties)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import detector_flax_to_torch_state, flax_to_torch_state
from simple_pose_torch.detector.yolov5 import YOLOv5
from simple_pose_torch.evalkit import fused as tfused
from simple_pose_torch.evalkit import workflows as twf
from simple_pose_torch.ops.affine_device import (
    affine_crop_separable_multi,
    boxes_to_crop_affines,
)
from simple_pose_tpu.detector import wrapper as jwrap
from simple_pose_tpu.detector.nms import non_max_suppression_jit
from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
from simple_pose_tpu.evalkit import fused as jfused
from simple_pose_tpu.evalkit import workflows as jwf
from simple_pose_tpu.models.registry import build_from_cfg as jax_build_from_cfg
from simple_pose_tpu.ops import affine_jax
from tests.torch_jax_vars import abstract_flax_init, clear_pairs, is_clear, seeded_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(REPO, "tests", "data_torch_jpeg", "det")
DET_IMAGES = os.path.join(DET, "images")
DET_GT = os.path.join(DET, "person_keypoints.json")
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17}
INPUT = (64, 64)  # (w, h)
# the fixture's 640x480 JPEGs stay whole on a 640 canvas
FUSED_KW = dict(scale_name="s", det_size=(128, 128), input_shape=INPUT, max_people=4,
                det_conf=0.001, det_iou=0.5, canvas=640, amp=False)
BATCH = 8
KP_TOL, CONF_REL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A YOLOv5-s 80-class checkpoint and a ResNet-18 pose checkpoint, both
    in the reference's layout, from numpy-seeded flax variables."""
    d = tmp_path_factory.mktemp("w")
    rng = np.random.default_rng(3)
    det_vars = seeded_variables(JYOLOv5(num_cls=80, scale_name="s"),
                                np.zeros((1, 128, 128, 3), np.float32), rng)
    # the objectness prior of head_bias_init; class logits 0, as in the
    # seeded one-class detector
    for i, stride in enumerate((8, 16, 32)):
        b = np.zeros((3, 85), np.float32)
        b[:, 4] = np.log(8.0 / (640.0 / stride) ** 2)
        det_vars["params"]["head"][f"heads_{i}"]["bias"] = b.reshape(-1)
    det_path = str(d / "yolov5s.pth")
    torch.save({"ema": detector_flax_to_torch_state(det_vars, YOLOv5(80, "s"))}, det_path)
    pose_vars = seeded_variables(jax_build_from_cfg(R18), np.zeros((1, 64, 64, 3), np.float32),
                                 rng)
    pose_path = str(d / "r18.pth")
    torch.save({"ema": flax_to_torch_state(pose_vars)}, pose_path)
    return det_path, pose_path


@pytest.fixture(scope="module")
def confident_det_path(weights, tmp_path_factory):
    """The seeded YOLOv5-s with one anchor of its stride-32 level made sure
    of a person (objectness and class logits +4), so that the detector's
    default conf 0.25 keeps boxes."""
    ckpt = torch.load(weights[0])
    bias = ckpt["ema"]["head.heads.2.bias"].view(3, 85)
    bias[2, 4:6] += 4.0
    path = str(tmp_path_factory.mktemp("w") / "yolov5s_confident.pth")
    torch.save(ckpt, path)
    return path


@pytest.fixture(scope="module")
def programs(weights):
    det_path, pose_path = weights
    with abstract_flax_init():
        jf = jfused.FusedDetectPose(R18, pose_path, det_path, **FUSED_KW)
    tf = tfused.FusedDetectPose(R18, pose_path, det_path, device="cpu", **FUSED_KW)
    return jf, tf


def _fixture_batch(start=0, n=BATCH, canvas=640):
    """cv2.imread + the JAX paste_with_border, as the JAX workflows read."""
    cv = pytest.importorskip("cv2")
    names = sorted(os.listdir(DET_IMAGES))[start:start + n]
    canvases = np.zeros((n, canvas, canvas, 3), np.uint8)
    shapes = []
    for slot, name in zip(canvases, names):
        img = cv.imread(os.path.join(DET_IMAGES, name))
        jwrap.paste_with_border(slot, img)
        shapes.append(img.shape[:2])
    return canvases, shapes


@pytest.fixture(scope="module")
def jax_preds(programs):
    """JAX's letterbox + detector pred [32, N, 6] for every fixture image,
    in image-id order: the candidates of the clear rule."""
    jf, _ = programs

    @jax.jit
    def pred(variables, canvases, trans, region):
        x = jwrap._letterbox_input(canvases, trans, region, 128, 128, jnp.float32)
        return jf.detector.model.apply(variables, x)

    out = []
    for start in range(0, len(os.listdir(DET_IMAGES)), BATCH):
        canvases, shapes = _fixture_batch(start)
        geom = jf.host_prep(shapes)
        out.append(np.asarray(pred(jf.detector.variables,
                                   *(jnp.asarray(a) for a in (canvases, *geom[:2])))))
    return np.concatenate(out)


@pytest.fixture(scope="module")
def staged(programs, jax_preds):
    """One batch of the fixture through JAX's fused program, JAX's
    letterbox + detector (pred) and the port's stages; ``tol`` is 4x the
    measured port-vs-JAX difference of pred's scores."""
    jf, tf = programs
    canvases, shapes = _fixture_batch()
    geom = jf.host_prep(shapes)
    jx = jwrap._letterbox_input(jnp.asarray(canvases), *(jnp.asarray(a) for a in geom[:2]),
                                128, 128, jnp.float32)
    jpred = jax_preds[:BATCH]
    jout = jf(canvases, shapes)
    args = tf.prepare(canvases, shapes)
    with torch.no_grad():
        tx = tf.letterbox(*args[:3], 128, 128)
        tpred = tf.detector.model(tx).numpy()
    tol = 4 * np.abs(tpred[..., 4:] - jpred[..., 4:]).max()
    return {"canvases": canvases, "shapes": shapes, "jx": np.asarray(jx), "tx": tx,
            "jpred": jpred, "tpred": tpred, "jout": jout, "args": args, "tol": tol}


# ------------------------------------------------------------- geometry
def test_boxes_to_crop_affines_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-20, 600, (3, 5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 300, (3, 5, 2))], -1).astype(np.float32)
    for shapes in [((192, 256), (48, 64)), ((64, 64), (16, 16)), ((288, 384), (72, 96))]:
        want = affine_jax.boxes_to_crop_affines(jnp.asarray(boxes), *shapes)
        got = boxes_to_crop_affines(torch.from_numpy(boxes), *shapes)
        for g, w in zip(got, want):
            assert g.shape == (3, 5, 2, 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_affine_crop_separable_multi_matches_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 255, (2, 200, 240, 3), dtype=np.uint8)
    xy = rng.uniform(-30, 180, (2, 3, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 150, (2, 3, 2))], -1).astype(np.float32)
    trans, _ = affine_jax.boxes_to_crop_affines(jnp.asarray(boxes), (48, 64), (12, 16))
    want = np.asarray(affine_jax.affine_crop_separable_multi(jnp.asarray(imgs), trans, (64, 48)))
    trans = torch.from_numpy(np.array(trans))
    got = affine_crop_separable_multi(torch.from_numpy(imgs), trans, (64, 48))
    assert got.shape == (2, 3, 64, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    bf16 = affine_crop_separable_multi(torch.from_numpy(imgs), trans, (64, 48),
                                       out_dtype=torch.bfloat16)
    assert torch.equal(bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("rect", [False, True])
def test_host_prep_and_bucket_match_jax(rect):
    """Letterbox geometry exactly, at det_size and at a rect bucket."""
    fused = tfused.FusedDetectPose.__new__(tfused.FusedDetectPose)
    fused.det_size = (640, 640)
    shapes = [(480, 640), (640, 480), (200, 640), (1000, 500), (333, 333)]
    want_bucket = jfused.FusedDetectPose._pick_bucket(fused, shapes)
    assert fused._pick_bucket(shapes) == want_bucket
    run = (want_bucket[1], want_bucket[0]) if rect else None
    want = jfused.FusedDetectPose.host_prep(fused, shapes, run_size=run)
    for g, w in zip(fused.host_prep(shapes, run_size=run), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------- the stages
def test_detect_stage_pred_matches_jax(staged):
    np.testing.assert_allclose(staged["tx"].permute(0, 2, 3, 1).numpy(), staged["jx"],
                               rtol=0, atol=1e-6)
    jp, tp = staged["jpred"], staged["tpred"]
    assert tp.shape == jp.shape == (BATCH, 3 * (16 ** 2 + 8 ** 2 + 4 ** 2), 6)
    np.testing.assert_allclose(tp[..., :4], jp[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tp[..., 4:], jp[..., 4:], rtol=0, atol=1e-5)


def test_detect_stage_nms_matches_jax(programs, staged):
    """The fused program's NMS (top max_people, merge, multi-label) on the
    same pred: exact keep masks, and every image fills its slots."""
    _, tf = programs
    jd, jv = (np.asarray(a) for a in non_max_suppression_jit(
        jnp.asarray(staged["jpred"]), conf_thresh=0.001, iou_thresh=0.5, max_det=4,
        multi_label=True, merge=True))
    td, tv = tf.nms(torch.from_numpy(staged["jpred"]))
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert jv.all()
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def basic_programs(weights):
    """The pair with decoder='basic' (argmax and a quarter-pixel shift)."""
    det_path, pose_path = weights
    with abstract_flax_init():
        jf = jfused.FusedDetectPose(R18, pose_path, det_path, decoder="basic", **FUSED_KW)
    return jf, tfused.FusedDetectPose(R18, pose_path, det_path, decoder="basic", device="cpu",
                                      **FUSED_KW)


def _hm_px(kps, trans_inv):
    """Keypoints [B, P, J, 2] back in heatmap pixels."""
    k, t = trans_inv[..., 0, 0], trans_inv[..., :, 2]
    return (kps - t[:, :, None, :]) / k[:, :, None, None]


def test_pose_stage_matches_jax_on_the_same_boxes(programs, basic_programs, staged):
    """The port's pose stage on JAX's boxes against JAX's program output.
    decoder='basic': keypoints 1e-3 canvas px.  gauss_taylor: its Taylor
    step divides by the log-heatmap's Hessian determinant, which the seeded
    net's maps make near-singular at some keypoints (JAX's own step moves
    them by up to 1e5 px); where JAX's step stays inside a heatmap pixel,
    as on a peaked map, keypoints within 1e-3 heatmap px.  Confidences
    1e-4 relative in both."""
    canvases, shapes = staged["canvases"], staged["shapes"]
    jb, tb = basic_programs
    jbasic = jb(canvases, shapes)
    boxes = torch.from_numpy(staged["jout"]["boxes"])
    np.testing.assert_array_equal(jbasic["boxes"], staged["jout"]["boxes"])
    for (jf, tf), jout in ((programs, staged["jout"]), (basic_programs, jbasic)):
        got = {k: v.numpy() for k, v in tf.pose(staged["args"][0], boxes).items()}
        assert got["kps"].shape == jout["kps"].shape == (BATCH, 4, 17, 2)
        np.testing.assert_allclose(got["kp_conf"], jout["kp_conf"], rtol=CONF_REL, atol=1e-7)
        np.testing.assert_allclose(got["pose_scores"], jout["pose_scores"], rtol=CONF_REL)
        if jout is jbasic:
            np.testing.assert_allclose(got["kps"], jout["kps"], rtol=0, atol=KP_TOL)
            continue
        _, trans_inv = boxes_to_crop_affines(boxes, INPUT, (INPUT[0] // 4, INPUT[1] // 4))
        trans_inv = trans_inv.numpy()
        want_hm, got_hm = _hm_px(jout["kps"], trans_inv), _hm_px(got["kps"], trans_inv)
        step = np.abs(want_hm - np.round(_hm_px(jbasic["kps"], trans_inv))).max(-1)
        tame = step < 1.0
        assert tame.mean() > 0.5, tame.mean()
        np.testing.assert_allclose(got_hm[tame], want_hm[tame], rtol=0, atol=KP_TOL)


def test_fused_program_matches_jax_where_clear(programs, staged):
    """End to end: each JAX detection whose score clears its neighbours by
    more than 4x the measured pred difference is found by the port with
    the same score, box and keypoint confidences (the keypoints' decode is
    held on the same boxes above)."""
    _, tf = programs
    jout, tol = staged["jout"], staged["tol"]
    got = tf(staged["canvases"], staged["shapes"])
    assert set(got) == set(jout)
    for k in jout:
        assert got[k].shape == jout[k].shape, k
    compared = 0
    for b in range(BATCH):
        for p in range(4):
            s = jout["det_scores"][b, p]
            if not is_clear(staged["jpred"][b], s, tol):
                continue
            q = int(np.argmin(np.abs(got["det_scores"][b] - s)))
            assert abs(got["det_scores"][b, q] - s) <= tol, (b, p)
            np.testing.assert_allclose(got["boxes"][b, q], jout["boxes"][b, p], atol=1e-2)
            np.testing.assert_allclose(got["kp_conf"][b, q], jout["kp_conf"][b, p],
                                       rtol=CONF_REL, atol=1e-7)
            compared += 1
    assert compared >= BATCH, compared


def test_fused_rect_buckets(programs, weights, staged):
    """rect=True: the fixture's 640x480 images bucket to the full square at
    det 128, so the outputs equal the default program's; wide images run
    in a 128x64 bucket whose pred equals JAX's letterbox + detector there."""
    jf, tf = programs
    det_path, pose_path = weights
    rect = tfused.FusedDetectPose(R18, pose_path, det_path, rect=True, device="cpu", **FUSED_KW)
    canvases, shapes = staged["canvases"], staged["shapes"]
    square = rect(canvases, shapes)
    default = tf(canvases, shapes)
    for k in default:
        np.testing.assert_array_equal(square[k], default[k], err_msg=k)
    wide = [(200, 640)] * BATCH
    assert rect._pick_bucket(wide) == jf._pick_bucket(wide) == (64, 128)
    geom = jf.host_prep(wide, run_size=(128, 64))
    jx = jwrap._letterbox_input(jnp.asarray(canvases), *(jnp.asarray(a) for a in geom[:2]),
                                64, 128, jnp.float32)
    want = np.asarray(jax.jit(jf.detector.model.apply)(jf.detector.variables, jx))
    args = rect.prepare(canvases, wide)
    assert args[-2:] == (64, 128)
    with torch.no_grad():
        got = rect.detector.model(rect.letterbox(*args[:3], 64, 128)).numpy()
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-5)
    out = rect(canvases, wide)
    assert out["kps"].shape == (BATCH, 4, 17, 2) and np.isfinite(out["kps"]).all()
    # boxes clip to the bucket, then map back: y2 <= (64 - top) / r
    lb_inv_scale, lb_offset = geom[2][0], geom[3][0]
    assert (out["boxes"][..., 3] <= (64 - lb_offset[1]) * lb_inv_scale + 1e-3).all()


# --------------------------------------------------------- the workflows
def _fused_entries(path):
    """fused_eval's raw JSON as (image index, score, entry) in file order."""
    with open(path) as f:
        return [(p["img_id"] - 1, p["score"], p) for p in json.load(f)]


def test_fused_eval_matches_jax(basic_programs, jax_preds, staged, tmp_path, monkeypatch):
    """fused_eval's raw predictions against JAX's, instance by instance:
    each JAX instance whose detector score is clear (see
    tests/torch_jax_vars.is_clear) has the port's instance of that image
    with the same score, and the same area (1e-5 relative), keypoints (1e-2
    px: the boxes agree to BOX_TOL) and keypoint confidences.  The decoder
    is 'basic' (gauss_taylor's step is held on the same boxes above).  AP
    within 0.005 of JAX's as well."""
    jf, tf = basic_programs
    monkeypatch.chdir(tmp_path)  # the JAX workflow writes ./filter_kps_predicts.json
    kw = dict(batch_size=BATCH, input_shape=INPUT, max_people=4, canvas=640)
    want = jfused.fused_eval(DET_IMAGES, DET_GT, R18, fused=jf,
                             out_path=str(tmp_path / "j.json"), **kw)
    got = tfused.fused_eval(DET_IMAGES, DET_GT, R18, fused=tf, out_path=str(tmp_path / "t.json"),
                            filtered_out_path=str(tmp_path / "t_f.json"), use_native=True, **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])
    jp, tp = _fused_entries(tmp_path / "j.json"), _fused_entries(tmp_path / "t.json")
    assert len(tp) == len(jp) == 32 * 4
    assert sorted({e["img_id"] for _, _, e in tp}) == list(range(1, 33))
    pairs = clear_pairs(jax_preds, jp, tp, staged["tol"])
    assert len(pairs) >= 32, len(pairs)
    for (_, _, w), (_, _, g) in pairs:
        assert g["img_id"] == w["img_id"]
        np.testing.assert_allclose(g["area"], w["area"], rtol=1e-5)
        gk, wk = np.reshape(g["kps"], (17, 3)), np.reshape(w["kps"], (17, 3))
        np.testing.assert_allclose(gk[:, :2], wk[:, :2], rtol=0, atol=1e-2)
        np.testing.assert_allclose(gk[:, 2], wk[:, 2], rtol=CONF_REL, atol=1e-7)
    assert os.path.exists(tmp_path / "t_f.json")


def test_gen_detections_into_predicts_by_detections_matches_jax(programs, weights, jax_preds,
                                                               staged, tmp_path, monkeypatch):
    """gen_detections on the fixture (the port decoding with the native
    loader), then predicts_by_detections, in both packages.  The
    detection JSONs: the same number of detections per image within one,
    and each JAX detection whose score is clear has the port's detection of
    that image with the same score and box (1e-2 px: the un-letterboxed
    boxes of pred's BOX_TOL).  AP within 0.005 of JAX's."""
    jf, tf = programs
    monkeypatch.chdir(tmp_path)  # the JAX workflow writes ./filter_kps_predicts.json
    kw = dict(batch_size=BATCH, canvas=640, debug=2)
    jdets = jwf.gen_detections(DET_IMAGES, DET_GT, detector=jf.detector,
                               out_path=str(tmp_path / "jd.json"), **kw)
    tdets = twf.gen_detections(DET_IMAGES, DET_GT, detector=tf.detector,
                               out_path=str(tmp_path / "td.json"), use_native=True, **kw)
    count = lambda dets: np.bincount([d["image_id"] for d in dets], minlength=3)  # noqa: E731
    assert count(jdets)[1:].min() > 0
    assert np.abs(count(tdets) - count(jdets)).max() <= 1
    with open(tmp_path / "td.json") as f:
        assert json.load(f) == tdets
    entries = lambda dets: [(d["image_id"] - 1, d["score"], d) for d in dets]  # noqa: E731
    pairs = clear_pairs(jax_preds, entries(jdets), entries(tdets), staged["tol"])
    assert len(pairs) >= 20, (len(pairs), len(jdets))  # ~1 in 5 of the near-prior scores
    for (_, _, w), (_, _, g) in pairs:
        assert g["category_id"] == w["category_id"] == 1
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-2)
    pw = dict(weights=weights[1], batch_size=64, input_shape=INPUT, canvas=640, amp=False)
    with abstract_flax_init():
        want = jwf.predicts_by_detections(DET_IMAGES, str(tmp_path / "jd.json"), DET_GT, R18,
                                          out_path=str(tmp_path / "jk.json"), **pw)
    got = twf.predicts_by_detections(DET_IMAGES, str(tmp_path / "td.json"), DET_GT, R18,
                                     out_path=str(tmp_path / "tk.json"), device="cpu",
                                     filtered_out_path=str(tmp_path / "tf.json"),
                                     use_native=True, **pw)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 0.005, (k, got[k], want[k])


CLI = {
    "gen-dets": ["--canvas", "640", "--debug", "8", "--batch-size", "8"],
    "fused": ["--model-name", "resnet18", "--canvas", "640", "--det-size", "128",
              "--max-people", "4", "--debug", "8", "--batch-size", "8"],
    # the fused layer1 needs a Bottleneck trunk: ResNet-50+SE, seeded; e2e
    # detects at the default conf 0.25 (confident_det_path)
    "e2e": ["--model-name", "resnet50", "--reduction", "--debug", "1", "--flip-test",
            "--fused-layer1"],
}


def _cli(argv, capsys):
    from simple_pose_torch import eval as teval

    teval.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cmd", sorted(CLI))
def test_eval_cli_detector_subcommands(cmd, weights, confident_det_path, tmp_path, monkeypatch,
                                      capsys):
    """gen-dets, fused and e2e from the command line on the CPU; e2e with
    flip-test and the fused layer1 (the plain chain on the CPU)."""
    det_path, pose_path = weights
    monkeypatch.chdir(tmp_path)
    args = ["--img-root", DET_IMAGES, "--ann", DET_GT, "--scale-name", "s", "--device", "cpu"]
    if cmd == "e2e":
        args += ["--det-weights", confident_det_path]
    else:
        args += ["--det-weights", det_path, "--conf", "0.001"]
    if cmd == "fused":
        args += ["--weights", pose_path]
    if cmd != "gen-dets":
        args += ["--input-w", "64", "--input-h", "64"]
    from simple_pose_torch.models import resnet

    chain = resnet.bottleneck_chain
    calls = []
    monkeypatch.setattr(resnet, "bottleneck_chain", lambda *a, **k: calls.append(1) or chain(*a, **k))
    last = _cli([cmd, *args, *CLI[cmd]], capsys)
    # e2e honours --fused-layer1: one chain per forward, two with flip-test
    assert len(calls) % 2 == 0 and bool(calls) == (cmd == "e2e")
    if cmd == "gen-dets":
        with open(tmp_path / "person_detections.json") as f:
            assert last["detections"] == len(json.load(f)) > 0
        return
    assert 0.0 <= last["AP"] <= 1.0
    out = {"fused": ["fused_kps_temp.json", "fused_filter_kps_predicts.json"],
           "e2e": ["person_detections.json", "predicts_kps_temp.json",
                   "filter_kps_predicts.json"]}[cmd]
    assert all(os.path.exists(tmp_path / f) for f in out)
    with open(tmp_path / out[-2]) as f:
        assert len(json.load(f)) > 0
    if cmd == "e2e":  # the detector's default conf
        with open(tmp_path / "person_detections.json") as f:
            assert min(d["score"] for d in json.load(f)) >= 0.25


def test_eval_cli_runs_on_cuda_by_default(capsys):
    """Without --device the entry points take CUDA, and raise where no GPU
    is present."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cmd in ("gen-dets", "fused", "e2e"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli([cmd, "--img-root", DET_IMAGES, "--ann", DET_GT], capsys)


@pytest.mark.parametrize("extra", [["--flip-test"], ["--decoder", "dark_original"]])
def test_eval_cli_fused_refuses_two_stage_options(extra, capsys):
    with pytest.raises(SystemExit) as e:
        _cli(["fused", "--img-root", DET_IMAGES, "--ann", DET_GT, "--device", "cpu", *extra],
             capsys)
    assert e.value.code == 2 and "two-stage" in capsys.readouterr().err
