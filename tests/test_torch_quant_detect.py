"""W8A8 in the port's detector and fused detect -> pose program
(detector/wrapper.YOLOv5Detector, evalkit/fused.FusedDetectPose and
fused_eval) against the JAX package's, on numpy-seeded weights and the
fixture's JPEGs: calibrated scales, quantized preds on shared scales, and
the detections instance by instance, and the fused program's quantized
pose stage on JAX's boxes.

The float detector tests' pairing rule (a score clear of its image's
other candidates by 4x the port-vs-JAX pred difference,
tests/torch_jax_vars.clear_pairs) finds no instance here: the quantized
preds differ by up to ~3e-3 in score (x8 flips,
tests/test_torch_quant.py), so the rule's margin is ~1e-2, while every
seeded candidate scores 0.26-0.29.  Detections pair instead by box (the
port's box of the same image with the highest IoU) and, in fused_eval, by
each image's scores in order; the pose stage is held on the same boxes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import detector_flax_to_torch_state
from simple_pose_torch.detector import wrapper as twrap
from simple_pose_torch.detector.yolov5 import YOLOv5
from simple_pose_torch.evalkit import fused as tfused
from simple_pose_torch.models import quant as tq
from simple_pose_torch.ops.decode import decode_basic
from simple_pose_tpu.detector import wrapper as jwrap
from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
from simple_pose_tpu.evalkit import fused as jfused
from simple_pose_tpu.models import quant as jq
from tests.test_torch_fused import DET_GT, DET_IMAGES, FUSED_KW, R18, weights  # noqa: F401
from tests.test_torch_quant import _untied
from tests.torch_jax_vars import abstract_flax_init, seeded_variables

torch.set_num_threads(1)

DET_HW = 128
# quantized pred, port vs JAX on shared scales, relative to max|JAX|.  The
# max is set by x8 flips on 1-ulp input differences that spread
# (tests/test_torch_quant.py): measured 8.0e-3 for the detector here and
# 1.2e-2 for the fused program's.  The median element stays at the f32
# rounding level, measured 1.7e-6, while the unquantized forward's sits at
# 1.8e-5 (the quantization's own error, which no bound on the max sees:
# 5.7e-3), so the median bound tells a quantized forward from a float one.
PRED_REL, PRED_MEDIAN_REL = 2e-2, 5e-6
# pose scales recorded on the detector's crops: measured 3.7e-7
POSE_SCALES_RTOL = 1e-5
# the fused program's quantized pose net on its crops against JAX's on the
# same crops and scales, relative to max|JAX|: max measured 1.3e-2 (x8
# flips), median 0.0; with dynamic scales the median is 2.3e-3, unquantized
# 2.7e-3.  decode_basic's keypoints are held on the maps no error of the
# measured size moves (_untied): 13% of them here (seeded R18, flat maps)
POSE_HEAT_REL, POSE_HEAT_MEDIAN_REL, UNTIED_SHARE = 3e-2, 5e-6, 0.1


def _scales_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    rng = np.random.default_rng(12)
    variables = seeded_variables(JYOLOv5(num_cls=80, scale_name="s"),
                                 np.zeros((1, DET_HW, DET_HW, 3), np.float32), rng)
    path = str(tmp_path_factory.mktemp("w") / "yolov5s.pth")
    torch.save({"ema": detector_flax_to_torch_state(variables, YOLOv5(80, "s"))}, path)
    cfg = dict(weights_path=path, scale_name="s", scale_size=(DET_HW, DET_HW), conf_thresh=0.001,
               canvas=256, amp=False, quant="w8a8")
    with abstract_flax_init():
        jdet = jwrap.YOLOv5Detector(**cfg)
    shapes = [(200, 200), (90, 250), (250, 120)]
    canvases = np.zeros((len(shapes), 256, 256, 3), np.uint8)
    for c, hw in zip(canvases, shapes):
        twrap.paste_with_border(c, rng.integers(0, 255, hw + (3,), dtype=np.uint8))
    return jdet, cfg, canvases, shapes


def test_detector_calibrate_and_predict_match_jax(detectors):
    """calibrate records JAX's scales (rtol 1e-5); on those scales the
    quantized pred is within PRED_REL (max) and PRED_MEDIAN_REL (median) of
    JAX's, which the unquantized pred's median is not, and predict_batch's
    detections match JAX's: per image the count within 20%, and three in
    four of JAX's boxes have a port box of IoU > 0.9 whose score is within
    4x the pred difference (the others: NMS merged another set of
    near-tied candidates)."""
    jdet, cfg, canvases, shapes = detectors
    jscales = jdet.calibrate(iter([(canvases, shapes)]), 1)
    tdet = twrap.YOLOv5Detector(**cfg, device="cpu")
    _scales_close(tdet.calibrate(iter([(canvases, shapes), (canvases, shapes)]), 1), jscales)
    tdet = twrap.YOLOv5Detector(**{**cfg, "quant_scales": jscales}, device="cpu")
    geom = [twrap.letterbox_params(h, w, (DET_HW, DET_HW)) for h, w in shapes]
    args = (canvases, *twrap._geom_to_arrays(geom))
    jp = np.asarray(jdet._forward(jdet.variables, *map(jnp.asarray, args)))
    tp = tdet.forward(*map(torch.from_numpy, args), DET_HW, DET_HW).numpy()
    assert _rel(tp, jp) < PRED_REL
    assert _median_rel(tp, jp) < PRED_MEDIAN_REL
    with torch.no_grad():
        fp = tdet.model(twrap.letterbox_input(*map(torch.from_numpy, args), DET_HW, DET_HW,
                                              tdet.lb_dtype)).numpy()
    assert _median_rel(fp, jp) > PRED_MEDIAN_REL
    tol = 4 * np.abs(tp[..., 4:] - jp[..., 4:]).max()
    want, got = jdet.predict_batch(canvases, shapes), tdet.predict_batch(canvases, shapes)
    for w, g in zip(want, got):
        assert abs(len(g) - len(w)) <= 0.2 * len(w), (len(g), len(w))  # measured: 3 of 28
        iou = _iou(w[:, :4], g[:, :4])  # [nw, ng]
        best = iou.argmax(1)
        ok = (iou.max(1) > 0.9) & (np.abs(g[best, 4] - w[:, 4]) <= tol)
        assert ok.mean() >= 0.75, ok.mean()  # measured here: 0.85 and up


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _median_rel(got, want):
    return float(np.median(np.abs(got - want)) / np.abs(want).max())


def _iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None, :] - inter)


def test_detector_quant_rules():
    with pytest.raises(ValueError, match="quant"):
        twrap.YOLOv5Detector(scale_name="s", quant="int4", device="cpu")
    det = twrap.YOLOv5Detector(scale_name="s", device="cpu")
    with pytest.raises(ValueError, match="quant mode"):
        det.calibrate(iter([]), 1)


def test_fused_eval_quant_matches_jax(weights, tmp_path, monkeypatch):  # noqa: F811
    """fused_eval(quant='w8a8', quant_calib=1) in both packages: the same
    detector scales (rtol 1e-5) and pose scales (POSE_SCALES_RTOL), both
    written as the per-net file; then the port on JAX's scales
    (``--scales``): its quantized pred within PRED_REL of JAX's, each
    image's 4 predictions with the scores of JAX's in order (within 4x the
    pred difference), AP within 0.05.  The quantized pose stage on JAX's
    boxes: the port's heatmaps on its own crops within POSE_HEAT_REL (max)
    and POSE_HEAT_MEDIAN_REL (median) of JAX's pose net on the same crops
    and scales (the pose net on dynamic scales fails the median bound), and
    its keypoints and confidences equal to the
    decode of JAX's heatmaps on every map that no error of the measured
    size can move (_untied)."""
    det_path, pose_path = weights
    monkeypatch.chdir(tmp_path)  # the JAX workflow writes ./filter_kps_predicts.json
    kw = dict(batch_size=8, input_shape=FUSED_KW["input_shape"], max_people=4, canvas=640,
              debug=8, quant="w8a8", quant_calib=1)
    fkw = dict(FUSED_KW, decoder="basic", quant="w8a8")
    with abstract_flax_init():
        jf = jfused.FusedDetectPose(R18, pose_path, det_path, **fkw)
    want = jfused.fused_eval(DET_IMAGES, DET_GT, R18, fused=jf, out_path=str(tmp_path / "j.json"),
                             quant_scales_out=str(tmp_path / "js.json"), **kw)
    tf = tfused.FusedDetectPose(R18, pose_path, det_path, device="cpu", **fkw)
    tfused.fused_eval(DET_IMAGES, DET_GT, R18, fused=tf, out_path=str(tmp_path / "t0.json"),
                      filtered_out_path=str(tmp_path / "t0_f.json"), use_native=True,
                      quant_scales_out=str(tmp_path / "ts.json"), **kw)
    js, ts = (tq.load_scales(str(tmp_path / f)) for f in ("js.json", "ts.json"))
    assert set(js) == set(ts) == {"detector", "pose"}
    _scales_close(ts["detector"], js["detector"])
    assert set(ts["pose"]) == set(js["pose"])
    pose_rel = max(abs(ts["pose"][k] / js["pose"][k] - 1) for k in js["pose"])
    assert pose_rel < POSE_SCALES_RTOL, pose_rel

    tf = tfused.FusedDetectPose(R18, pose_path, det_path, device="cpu", quant_scales=js, **fkw)
    got = tfused.fused_eval(DET_IMAGES, DET_GT, R18, fused=tf, out_path=str(tmp_path / "t.json"),
                            filtered_out_path=str(tmp_path / "t_f.json"), use_native=True,
                            **{**kw, "quant_calib": 0})
    for k in want:
        assert abs(got[k] - want[k]) < 0.05, (k, got[k], want[k])
    canvases, shapes = twrap.read_canvases(
        [os.path.join(DET_IMAGES, n) for n in sorted(os.listdir(DET_IMAGES))[:8]], 640)
    geom = jf.host_prep(shapes)
    with jq.quantized("w8a8", js["detector"]):
        jx = jwrap._letterbox_input(jnp.asarray(canvases), *map(jnp.asarray, geom[:2]),
                                    128, 128, jnp.float32)
        jp = np.asarray(jax.jit(jf.detector.model.apply)(jf.detector.variables, jx))
    args = tf.prepare(canvases, shapes)
    with torch.no_grad(), tf._contexts["detector"]:
        tp = tf.detector.model(tf.letterbox(*args[:3], 128, 128)).numpy()
    assert _rel(tp, jp) < PRED_REL and _median_rel(tp, jp) < PRED_MEDIAN_REL
    tol = 4 * np.abs(tp[..., 4:] - jp[..., 4:]).max()
    scores = lambda path: {  # noqa: E731
        i: sorted(p["score"] for p in json.load(open(path)) if p["img_id"] == i)
        for i in range(1, 9)}
    js_, ts_ = scores(tmp_path / "j.json"), scores(tmp_path / "t.json")
    for i in js_:
        assert len(js_[i]) == len(ts_[i]) == 4
        np.testing.assert_allclose(ts_[i], js_[i], rtol=0, atol=tol, err_msg=str(i))

    # the quantized pose stage on JAX's boxes, against JAX's pose net on the
    # port's crops and the same scales
    boxes = torch.from_numpy(np.array(jf(canvases, shapes)["boxes"]))
    x, trans_inv = tf.crops(args[0], boxes)
    with torch.no_grad():
        th = tf.pose_forward(x).numpy()
        with tq.quantized(tf.pose_model, "w8a8"):
            th_dynamic = tf.pose_model(x).float().numpy()
        out = tf.pose(args[0], boxes)
    with jq.quantized("w8a8", js["pose"]):
        jh = np.asarray(jax.jit(jf.pose_model.apply)(
            jf.pose_vars, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))).transpose(0, 3, 1, 2)
    assert _rel(th, jh) < POSE_HEAT_REL, _rel(th, jh)
    assert _median_rel(th, jh) < POSE_HEAT_MEDIAN_REL < _median_rel(th_dynamic, jh)
    err = np.abs(th - jh).max()
    keep = _untied(jh, err)
    assert keep.mean() > UNTIED_SHARE, keep.mean()
    jk, jc = decode_basic(torch.from_numpy(np.ascontiguousarray(jh)), trans_inv)
    tk, tc = out["kps"].reshape(jk.shape), out["kp_conf"].reshape(jc.shape)
    np.testing.assert_allclose(tk.numpy()[keep], jk.numpy()[keep], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tc.numpy(), jc.numpy(), rtol=0, atol=err)
