"""Serve poses from an exported artifact: no model code, no checkpoint.

Port of examples/serve_artifact.py.

    python -m simple_pose_torch.eval export --weights pose.pth --reduction \
        --out pose_eval.pt2                                  # once
    python -m simple_pose_torch.serve_artifact --artifact pose_eval.pt2 \
        --image person.jpg --box x1,y1,x2,y2 [--box ...] [--device cpu] \
        [--out overlay.png [--kp-thresh 0.2]]

The server loads the ``torch.export`` program (torch and the file; for an
artifact whose sidecar lists ``custom_ops``, those modules too, which
register K2's op and the int8 product's) on the card unless ``--device``
says otherwise, and owns only the host preprocessing: the JPEG decode,
through the port's native loader (data/native.py), and box -> affine
geometry (ops/affine.py).  The sidecar ``<artifact>.json`` that ``eval
export`` writes gives the batch, canvas and crop shapes.  It prints one JSON
object of people: box, score and 17 x (x, y, confidence).  ``--out`` also
draws the skeletons (joints above ``--kp-thresh``) and boxes on the image
(utils/viz.draw_pose) and writes it as PNG (utils/viz.write_png).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from simple_pose_torch.data.native import NativeCanvasLoader
from simple_pose_torch.evalkit.export import serving_fn
from simple_pose_torch.ops import affine as A
from simple_pose_torch.utils.device import resolve_device
from simple_pose_torch.utils.viz import draw_pose, write_png


def load_contract(artifact_path):
    """The input contract ``eval export`` writes beside the artifact."""
    with open(artifact_path + ".json") as rf:
        return json.load(rf)


def boxes_to_batch(canvas_rgb, hw, boxes, contract):
    """Host preprocessing: the image's canvas repeated over the batch, and
    each box's crop and inverse affines.  Slots past the boxes reuse the
    first box's geometry."""
    b = contract["batch"]
    if not isinstance(b, int):  # a batch of any size
        b = len(boxes)
    if len(boxes) > b:
        raise ValueError(f"{len(boxes)} boxes > artifact batch {b}; chunk the request")
    edge = contract["canvas"]
    h, w = hw
    if h > edge or w > edge:
        raise ValueError(f"image {w}x{h} exceeds the {edge} canvas; export a larger canvas "
                         "or downscale on the host")
    in_w, in_h = contract["input_shape"]
    canvas = np.broadcast_to(canvas_rgb, (b,) + canvas_rgb.shape).copy()
    trans = np.zeros((b, 2, 3), np.float32)
    trans_inv = np.zeros((b, 2, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        center, scale = A.box_to_center_scale(x1, y1, x2 - x1, y2 - y1, in_w / in_h)
        trans[i], _ = A.get_affine_transform(center, scale, 0, (in_w, in_h))
        _, trans_inv[i] = A.get_affine_transform(center, scale, 0, (in_w // 4, in_h // 4))
    trans[len(boxes):], trans_inv[len(boxes):] = trans[0], trans_inv[0]
    return canvas, trans, trans_inv


def serve(artifact, image, boxes, device=None, out=None, kp_thresh=0.2) -> dict:
    """One request: the artifact's people on ``image`` (a JPEG path), on
    ``device`` (None means CUDA; raises where no GPU is present); with
    ``out``, the overlay is written there as PNG."""
    if out is not None and not out.lower().endswith(".png"):
        raise ValueError(f"--out {out}: the overlay is written as PNG; name the file .png")
    contract = load_contract(artifact)
    if contract.get("external_weights"):
        raise ValueError("artifact was exported with --external-weights; this server "
                         "serves self-contained (baked) artifacts")
    if contract.get("decoder") == "dark_original":
        raise ValueError("dark_original artifacts return raw heatmaps (host decode); "
                         "export with --decoder gauss_taylor for direct serving")
    for module in contract.get("custom_ops", []):
        importlib.import_module(module)
    device = resolve_device(device)
    predict = serving_fn(artifact, device)
    loader = NativeCanvasLoader(1)
    try:
        canvases, heights, widths = loader.load_batch([image], contract["canvas"])
    finally:
        loader.close()
    canvas, trans, trans_inv = boxes_to_batch(canvases[0], (int(heights[0]), int(widths[0])),
                                              boxes, contract)
    res = predict(*(torch.from_numpy(a).to(device) for a in (canvas, trans, trans_inv)))
    n = len(boxes)
    kps, conf, scores = (res[k][:n].cpu().numpy() for k in ("kps", "conf", "scores"))
    if out is not None:
        h, w = int(heights[0]), int(widths[0])
        overlay = np.ascontiguousarray(canvases[0, :h, :w, ::-1])  # drawn in BGR, as JAX draws
        for i, box in enumerate(boxes):
            joints = np.concatenate([kps[i], (conf[i] > kp_thresh).astype(np.float32)], -1)
            overlay = draw_pose(overlay, joints, box=box)
        write_png(out, overlay[..., ::-1])
    return {"people": [
        {"box": list(boxes[i]), "score": float(scores[i]),
         "keypoints": np.concatenate([kps[i], conf[i]], -1).reshape(-1).round(2).tolist()}
        for i in range(n)]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve poses from an exported artifact")
    ap.add_argument("--artifact", required=True, help="eval export output")
    ap.add_argument("--image", required=True, help="a JPEG")
    ap.add_argument("--box", action="append", required=True,
                    help="x1,y1,x2,y2 (repeatable, up to the artifact batch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--kp-thresh", type=float, default=0.2)
    ap.add_argument("--out", default=None, help="write a skeleton overlay .png")
    args = ap.parse_args(argv)
    boxes = [tuple(float(v) for v in s.split(",")) for s in args.box]
    try:
        print(json.dumps(serve(args.artifact, args.image, boxes, args.device, args.out,
                               args.kp_thresh)))
    except ValueError as e:
        sys.exit(str(e))


if __name__ == "__main__":
    main()
