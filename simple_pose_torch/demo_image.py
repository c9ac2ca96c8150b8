"""Single-image pose demo: detect (or take a box) -> crop -> pose -> draw.

Port of examples/demo_image.py.

    python -m simple_pose_torch.demo_image --image person.jpg --weights pose.pth \
        [--box x1,y1,x2,y2 | --det-weights yolov5l.pth] [--out out.png] [--device cpu]

With --box the detector is skipped (GT-box style inference); otherwise the
YOLOv5 person detector (conf 0.25, IoU 0.5, on a canvas of
max(1280, h, w)) proposes boxes.  Then PoseEvaluator (256x192 crops) runs
once over the boxes, and the skeletons and boxes are drawn with
utils/viz.py.  It runs on the card unless --device says otherwise.

A JPEG is decoded by the native loader (data/native.py: libjpeg where the
machine has it, else the port's own decoder, progressive files included);
other formats need cv2.  The loader gives RGB; the detector takes the BGR
canvas cv2.imread would give, and PoseEvaluator an RGB one.  The overlay is
written as PNG (utils/viz.write_png; a machine without cv2 has no other
image writer), so --out must end in .png.  It prints the people as one
JSON line: box, score (the detector's, or 1 for --box) and 17 x (x, y,
confidence).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from simple_pose_torch.data.native import NativeCanvasLoader
from simple_pose_torch.detector.wrapper import read_canvases
from simple_pose_torch.ops import affine as A
from simple_pose_torch.utils.viz import draw_pose, write_png

DET_CANVAS = 1280
INPUT_SHAPE = (192, 256)  # (w, h)


def read_image(path, loader):
    """A JPEG (or, with cv2, another format) -> (BGR canvas of edge
    max(1280, h, w) with the image at the origin and a replicated border,
    (h, w))."""
    edge = DET_CANVAS
    while True:
        canvases, shapes = read_canvases([path], edge, loader)
        h, w = shapes[0]
        if max(h, w) <= edge:
            return canvases[0], (h, w)
        edge = max(h, w)


def pose_batch(img_rgb, boxes):
    """PoseEvaluator's batch for ``boxes`` on one image: its canvas (edge a
    multiple of 64) once, each box's crop and inverse affines."""
    h, w = img_rgb.shape[:2]
    edge = int(np.ceil(max(h, w) / 64) * 64)
    canvas = np.zeros((1, edge, edge, 3), np.uint8)
    canvas[0, :h, :w] = img_rgb
    in_w, in_h = INPUT_SHAPE
    trans = np.zeros((len(boxes), 2, 3), np.float32)
    trans_inv = np.zeros((len(boxes), 2, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        center, scale = A.box_to_center_scale(x1, y1, x2 - x1, y2 - y1, in_w / in_h)
        trans[i], _ = A.get_affine_transform(center, scale, 0, (in_w, in_h))
        _, trans_inv[i] = A.get_affine_transform(center, scale, 0, (in_w // 4, in_h // 4))
    return {"canvas": canvas, "trans": trans, "trans_inv": trans_inv,
            "canvas_idx": np.zeros(len(boxes), np.int32)}


def run(args) -> dict:
    """The demo on parsed arguments: writes ``args.out``, returns the people."""
    from simple_pose_torch.evalkit.workflows import PoseEvaluator
    from simple_pose_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    loader = NativeCanvasLoader(1)
    try:
        try:
            canvas_bgr, (h, w) = read_image(args.image, loader)
        except FileNotFoundError:
            sys.exit(f"cannot read {args.image}")
        except ImportError:
            sys.exit(f"cannot read {args.image}: only JPEGs decode without cv2")
    finally:
        loader.close()
    img_bgr = canvas_bgr[:h, :w].copy()

    if args.box:
        boxes = [tuple(float(v) for v in args.box.split(","))]
        scores = [1.0]
    else:
        from simple_pose_torch.detector.wrapper import YOLOv5Detector

        det = YOLOv5Detector(weights_path=args.det_weights, scale_name=args.scale_name,
                             conf_thresh=0.25, iou_thresh=0.5, canvas=canvas_bgr.shape[0],
                             device=device)
        found = det.predict_batch(canvas_bgr[None], [(h, w)])[0]
        boxes = [tuple(float(v) for v in b[:4]) for b in found]
        scores = [float(b[4]) for b in found]
        print(f"detector: {len(boxes)} people", file=sys.stderr)
        if not boxes:
            sys.exit("no people found")

    model_cfg = {"type": args.model_type, "name": args.model_name,
                 "num_joints": 17, "reduction": args.reduction}
    ev = PoseEvaluator(model_cfg, args.weights, INPUT_SHAPE, flip_test=args.flip_test,
                       quant=args.quant, device=device)
    out = ev(pose_batch(img_bgr[..., ::-1], boxes))
    kps, conf = out["kps"].cpu().numpy(), out["conf"].cpu().numpy()

    out_img = img_bgr
    for i, box in enumerate(boxes):
        joints = np.concatenate([kps[i], (conf[i] > args.kp_thresh).astype(np.float32)], -1)
        out_img = draw_pose(out_img, joints, box=box)
    write_png(args.out, out_img[..., ::-1])
    print(f"wrote {args.out}", file=sys.stderr)
    return {"people": [
        {"box": list(boxes[i]), "score": scores[i],
         "keypoints": np.concatenate([kps[i], conf[i]], -1).reshape(-1).tolist()}
        for i in range(len(boxes))]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="single-image pose demo")
    ap.add_argument("--image", required=True, help="a JPEG (other formats need cv2)")
    ap.add_argument("--weights", default=None, help="pose checkpoint (.pth)")
    ap.add_argument("--model-type", default="pose_resnet_dconv")
    ap.add_argument("--model-name", default="resnet50")
    ap.add_argument("--reduction", action="store_true")
    ap.add_argument("--box", default=None, help="x1,y1,x2,y2 (skip the detector)")
    ap.add_argument("--det-weights", default=None)
    ap.add_argument("--scale-name", default="l")
    ap.add_argument("--flip-test", action="store_true")
    ap.add_argument("--quant", default=None, choices=["w8a8"],
                    help="int8 conv forward (models/quant.py)")
    ap.add_argument("--kp-thresh", type=float, default=0.2)
    ap.add_argument("--out", default="demo_out.png", help="the overlay, a .png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.out.lower().endswith(".png"):
        sys.exit(f"--out {args.out}: the demo writes PNG only; name the file .png")
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
