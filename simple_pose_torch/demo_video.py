"""Video pose demo: every frame through the one fused detect -> pose program.

Port of examples/demo_video.py.

    python -m simple_pose_torch.demo_video --video in.mp4 --weights pose.pth \
        --det-weights yolov5l.pth [--out out.mp4] [--quant w8a8] [--device cpu]

Frames go in batches through evalkit/fused.FusedDetectPose (device
letterbox -> YOLOv5 person detector -> NMS -> crops -> pose -> decode); the
skeletons and boxes are drawn with utils/viz.py.  The loop is
:func:`run_frames`, over any iterable of BGR frames and a frame sink; mp4
reading and writing are cv2's (``main``), so the command needs cv2, which
the H100 machine lacks: there chip_smoke.py drives ``run_frames`` on
synthetic frames.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from simple_pose_torch.detector.wrapper import paste_with_border
from simple_pose_torch.utils.viz import draw_pose


def canvas_edge(h: int, w: int) -> int:
    """The fused program's canvas for (h, w) frames: a multiple of 64."""
    return int(np.ceil(max(h, w, 64) / 64) * 64)


def run_frames(fused, frames, sink, batch: int, kp_thresh: float = 0.2,
               max_frames: int = 0) -> int:
    """Run BGR frames of one size through ``fused`` in padded batches of
    ``batch`` and hand each drawn frame to ``sink``, in order.

    :param max_frames: stop after this many frames (0: all)
    :returns: the number of frames written"""
    total, buf = 0, []

    def flush(frames):
        h, w = frames[0].shape[:2]
        canvases = np.zeros((batch, fused.canvas, fused.canvas, 3), np.uint8)
        for slot, f in zip(canvases, frames):
            paste_with_border(slot, f)
        out = fused(canvases, [(h, w)] * batch)
        for i, frame in enumerate(frames):
            for p in range(fused.max_people):
                if not out["det_valid"][i, p]:
                    continue
                joints = np.concatenate(
                    [out["kps"][i, p], (out["kp_conf"][i, p] > kp_thresh).astype(np.float32)],
                    axis=-1)
                frame = draw_pose(frame, joints, box=tuple(out["boxes"][i, p]))
            sink(frame)
        return len(frames)

    for frame in frames:
        if max_frames and total + len(buf) >= max_frames:
            break
        buf.append(frame)
        if len(buf) == batch:
            total += flush(buf)
            buf = []
    if buf:
        total += flush(buf)
    return total


def _read_frames(cap):
    while True:
        ok, frame = cap.read()
        if not ok:
            return
        yield frame


def main(argv=None):
    ap = argparse.ArgumentParser(description="video pose demo")
    ap.add_argument("--video", required=True, help="input video (anything cv2 opens)")
    ap.add_argument("--weights", default=None, help="pose checkpoint (.pth)")
    ap.add_argument("--model-type", default="pose_resnet_dconv")
    ap.add_argument("--model-name", default="resnet50")
    ap.add_argument("--reduction", action="store_true")
    ap.add_argument("--det-weights", default=None)
    ap.add_argument("--scale-name", default="l")
    ap.add_argument("--detector-family", default="yolov5", choices=["yolov5", "yolov4"])
    ap.add_argument("--batch", type=int, default=4, help="frames per device call")
    ap.add_argument("--max-people", type=int, default=16)
    ap.add_argument("--det-conf", type=float, default=0.25)
    ap.add_argument("--det-size", type=int, default=640,
                    help="detector letterbox edge (static program shape)")
    ap.add_argument("--kp-thresh", type=float, default=0.2)
    ap.add_argument("--quant", default=None, choices=["w8a8"])
    ap.add_argument("--max-frames", type=int, default=0, help="0 = whole video")
    ap.add_argument("--out", default="demo_out.mp4")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        import cv2 as cv
    except ImportError:
        sys.exit("demo_video reads and writes video with cv2, which is not installed")

    from simple_pose_torch.evalkit.fused import FusedDetectPose

    cap = cv.VideoCapture(args.video)
    if not cap.isOpened():
        sys.exit(f"cannot open {args.video}")
    fps = cap.get(cv.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv.CAP_PROP_FRAME_HEIGHT))
    fused = FusedDetectPose(
        {"type": args.model_type, "name": args.model_name, "num_joints": 17,
         "reduction": args.reduction},
        args.weights, args.det_weights, scale_name=args.scale_name,
        max_people=args.max_people, det_conf=args.det_conf, canvas=canvas_edge(h, w),
        det_size=(args.det_size, args.det_size), detector_family=args.detector_family,
        quant=args.quant, device=args.device)
    writer = cv.VideoWriter(args.out, cv.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        sys.exit(f"cannot open video writer for {args.out}")
    try:
        total = run_frames(fused, _read_frames(cap), writer.write, args.batch, args.kp_thresh,
                           args.max_frames)
    finally:
        cap.release()
        writer.release()
    print(f"wrote {args.out} ({total} frames @ {fps:.1f} fps)")


if __name__ == "__main__":
    main()
