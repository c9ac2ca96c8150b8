"""The port's demos (python -m simple_pose_torch.demo_image / demo_video) run
end to end in a subprocess on the CPU, against the JAX package's flow
(examples/demo_image.py: JAX's detector or the given box, JAX's
PoseEvaluator once per box, utils/viz.draw_pose with cv2) on the same
seeded weights, and in the pattern of tests/test_demo.py for the video."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_pose_torch.convert.from_jax import detector_flax_to_torch_state, flax_to_torch_state
from simple_pose_torch.data.native import native_available
from simple_pose_torch.detector.yolov5 import YOLOv5
from simple_pose_torch.utils.viz import read_png
from tests.torch_jax_vars import abstract_flax_init, seeded_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_torch_jpeg")
R18 = {"type": "pose_resnet_dconv", "name": "resnet18", "num_joints": 17, "reduction": False}
# image, --box (the fixture's first person) or None for the detector
CASES = {"box": ("det/images/000000000001.jpg", "63.75,14.53,244.54,271.06"),
         "detector_progressive": ("progressive/p444.jpg", None)}
# port vs JAX keypoints, f32 on the CPU.  The seeded net's near-flat maps
# make Gauss-Taylor divide by near-singular Hessians (tests/test_torch_fused.py):
# there the two packages' steps part (by up to 451 px; 94% of the box case's
# joints agree and 88% of the detector case's 25 people's, measured).  Such a
# joint may disagree only where JAX's own step left the argmax's heatmap
# pixel ("untame"), and at least AGREE_MIN of all agree.
KP_TOL = 2e-3
AGREE_MIN = 0.85


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A seeded ResNet-18 pose checkpoint and a seeded YOLOv5-s 80-class
    checkpoint whose stride-32 anchor 2 is made sure of a person (objectness
    and class logits +4), so that the demo's conf 0.25 keeps boxes."""
    from simple_pose_tpu.detector.yolov5 import YOLOv5 as JYOLOv5
    from simple_pose_tpu.models.registry import build_from_cfg

    d = tmp_path_factory.mktemp("w")
    rng = np.random.default_rng(21)
    det_vars = seeded_variables(JYOLOv5(num_cls=80, scale_name="s"),
                                np.zeros((1, 128, 128, 3), np.float32), rng)
    for i, stride in enumerate((8, 16, 32)):
        b = np.zeros((3, 85), np.float32)
        b[:, 4] = np.log(8.0 / (640.0 / stride) ** 2)
        if i == 2:
            b[2, 4:6] += 4.0
        det_vars["params"]["head"][f"heads_{i}"]["bias"] = b.reshape(-1)
    det_path = str(d / "yolov5s.pth")
    torch.save({"ema": detector_flax_to_torch_state(det_vars, YOLOv5(80, "s"))}, det_path)
    pose_vars = seeded_variables(build_from_cfg(R18), np.zeros((1, 256, 192, 3), np.float32), rng)
    pose_path = str(d / "r18.pth")
    torch.save({"ema": flax_to_torch_state(pose_vars)}, pose_path)
    return det_path, pose_path


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}


def _jax_flow(img, det_path, pose_path, box):
    """JAX's demo flow on a BGR image: (boxes, kps, conf, tame), ``tame``
    where the Gauss-Taylor keypoint lies within a heatmap pixel of the
    argmax decode ('basic', a quarter pixel off the peak)."""
    from simple_pose_tpu.evalkit.workflows import PoseEvaluator
    from simple_pose_tpu.ops import affine as A

    h, w = img.shape[:2]
    with abstract_flax_init():
        if box is not None:
            boxes = [tuple(float(v) for v in box.split(","))]
        else:
            from simple_pose_tpu.detector.wrapper import YOLOv5Detector

            det = YOLOv5Detector(weights_path=det_path, scale_name="s", conf_thresh=0.25,
                                 iou_thresh=0.5, canvas=max(1280, h, w))
            boxes = [tuple(float(v) for v in b[:4]) for b in det.single_predict(img)]
        evs = [PoseEvaluator(R18, pose_path, (192, 256), decoder=d)
               for d in ("gauss_taylor", "basic")]
    edge = int(np.ceil(max(h, w) / 64) * 64)
    kps, confs, tame = [], [], []
    for x1, y1, x2, y2 in boxes:
        center, scale = A.box_to_center_scale(x1, y1, x2 - x1, y2 - y1, 192 / 256)
        trans, _ = A.get_affine_transform(center, scale, 0, (192, 256))
        _, trans_inv = A.get_affine_transform(center, scale, 0, (48, 64))
        canvas = np.zeros((1, edge, edge, 3), np.uint8)
        canvas[0, :h, :w] = img[..., ::-1]
        batch = {"canvas": canvas, "trans": np.asarray(trans, np.float32)[None],
                 "trans_inv": np.asarray(trans_inv, np.float32)[None]}
        out, basic = (ev(batch) for ev in evs)
        kps.append(np.asarray(out["kps"])[0])
        confs.append(np.asarray(out["conf"])[0])
        px = abs(float(trans_inv[0][0]))  # image px per heatmap px
        tame.append((np.abs(kps[-1] - np.asarray(basic["kps"])[0]) < px).all(-1))
    return np.asarray(boxes), np.asarray(kps), np.asarray(confs), np.asarray(tame)


@pytest.mark.parametrize("case", sorted(CASES))
def test_demo_image_matches_jax(case, weights, tmp_path):
    """The overlay PNG is the image's size and equals JAX's draw_pose of
    JAX's keypoints (every joint drawn: --kp-thresh 0) wherever the
    keypoints' int() pixels agree; the keypoints agree within KP_TOL px
    (see AGREE_MIN) and the detector's boxes within 1e-2 px."""
    import cv2 as cv

    if not native_available():
        pytest.skip("the native JPEG loader does not build here")
    rel, box = CASES[case]
    det_path, pose_path = weights
    image, out = os.path.join(FIXTURE, rel), str(tmp_path / "out.png")
    args = [sys.executable, "-m", "simple_pose_torch.demo_image", "--image", image,
            "--weights", pose_path, "--model-name", "resnet18", "--kp-thresh", "0",
            "--device", "cpu", "--out", out]
    args += ["--box", box] if box else ["--det-weights", det_path, "--scale-name", "s"]
    proc = subprocess.run(args, cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    people = json.loads(proc.stdout.strip().splitlines()[-1])["people"]
    img = cv.imread(image)
    jboxes, jkps, jconf, tame = _jax_flow(img, det_path, pose_path, box)
    got = read_png(out)[..., ::-1]
    assert got.shape == img.shape == (480, 640, 3)
    assert len(people) == len(jboxes) >= 1
    tboxes = np.asarray([p["box"] for p in people])
    tkps = np.asarray([np.reshape(p["keypoints"], (17, 3))[:, :2] for p in people])
    np.testing.assert_allclose(tboxes, jboxes, rtol=0, atol=1e-2)
    agree = (np.abs(tkps - jkps) <= KP_TOL).all(-1)
    assert agree.mean() >= AGREE_MIN, agree.mean()
    assert (agree | ~tame).all(), np.argwhere(~agree & tame)
    # JAX's draw_pose (cv2) of JAX's keypoints, with the port's in place of
    # the ones that part, every joint drawn as --kp-thresh 0 draws them
    from simple_pose_tpu.utils.viz import draw_pose

    kps = np.where(agree[..., None], jkps, tkps)
    want = img
    for b, k, c in zip(jboxes, kps, jconf):
        want = draw_pose(want, np.concatenate([k, (c > 0.0).astype(np.float32)], -1),
                         box=tuple(b))
    if (np.trunc(tkps) == np.trunc(kps)).all() and (np.trunc(tboxes) == np.trunc(jboxes)).all():
        np.testing.assert_array_equal(got, want)
    else:  # an int() flip moves a joint's disc and its bones by one pixel
        assert (got != want).any(-1).mean() < 1e-3


def test_demo_image_refuses_other_formats(weights, tmp_path):
    """--out must be a .png: the demo writes no other format."""
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.demo_image", "--image",
         os.path.join(FIXTURE, CASES["box"][0]), "--box", "1,1,50,80", "--device", "cpu",
         "--out", str(tmp_path / "out.jpg")],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and "PNG" in proc.stderr
    assert not os.path.exists(tmp_path / "out.jpg")


def test_demo_video_writes_overlay_video(weights, tmp_path):
    """demo_video on a synthetic mp4 (tests/test_demo.py's frames): the
    output has the input's frame count and size."""
    import cv2 as cv

    src = str(tmp_path / "in.mp4")
    wr = cv.VideoWriter(src, cv.VideoWriter_fourcc(*"mp4v"), 10, (96, 96))
    assert wr.isOpened(), "cv2 VideoWriter unavailable"
    for i in range(3):
        f = np.full((96, 96, 3), 30, np.uint8)
        cv.circle(f, (48, 30 + 5 * i), 10, (0, 0, 200), -1)
        cv.rectangle(f, (38, 40), (58, 80), (0, 150, 0), -1)
        wr.write(f)
    wr.release()
    det_path, pose_path = weights
    out = str(tmp_path / "out.mp4")
    proc = subprocess.run(
        [sys.executable, "-m", "simple_pose_torch.demo_video", "--video", src,
         "--weights", pose_path, "--det-weights", det_path, "--model-name", "resnet18",
         "--scale-name", "s", "--det-size", "128", "--batch", "2", "--max-people", "4",
         "--det-conf", "0.0001", "--device", "cpu", "--out", out],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cap = cv.VideoCapture(out)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (96, 96, 3)
        n += 1
    cap.release()
    assert n == 3, f"expected 3 frames, got {n}"
