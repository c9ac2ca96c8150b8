"""Time the port's NMS on the card: the greedy suppression as a fixed point
in a ``while_loop`` (detector/nms._greedy_keep, what the port runs, live
and exported) against the same fixed point as a Python loop that compares
each round on the host (``host_fixed_point``, the port's loop before it
could be exported) and the sequential loop of the JAX package (one step
per candidate, as nms.py:66-71 writes it), on the same pred, in the order
loop, host, while_loop, while_loop, host, loop.  Also prints the rounds.

    python scripts/time_torch_nms.py

The pred is a seeded YOLOv5-l's (bf16, 640^2 letterbox of 1280^2 canvases)
on the first 8 JPEGs of tests/data_torch_jpeg/det at conf 0.001, where
every one of the 512 candidates is valid.  Both settings are timed: the
fused program's (max_det 16) and gen-dets' (max_det 300), merge on.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from simple_pose_torch.data.native import NativeCanvasLoader  # noqa: E402
from simple_pose_torch.detector import nms  # noqa: E402
from simple_pose_torch.detector.wrapper import (  # noqa: E402
    YOLOv5Detector,
    _geom_to_arrays,
    letterbox_params,
    read_canvases,
)

IMAGES = os.path.join(REPO, "tests", "data_torch_jpeg", "det", "images")


def sequential_keep(valid, sup):
    """The JAX package's loop: step i lets a kept candidate i suppress."""
    keep = valid.clone()
    for i in range(valid.shape[-1]):
        keep &= ~((sup[:, i] > 0) & keep[:, i:i + 1])
    return keep


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_fixed_point(valid, sup, rounds=None):
    """The fixed point with a host test per round (``torch.equal``); appends
    its round count to ``rounds``."""
    keep, n = valid, 0
    while True:
        n += 1
        new = nms._suppress_step(keep, valid, sup)
        if torch.equal(new, keep):
            if rounds is not None:
                rounds.append(n)
            return keep
        keep = new


def time_loops(pred, timer=cuda_ms):
    """{max_det_<n>: {ms: {loop, host, while_loop: [two readings]}, rounds,
    same_result}} on one pred, at the fused program's max_det 16 and
    gen-dets' 300."""
    loops = {"loop": sequential_keep, "host": host_fixed_point, "while_loop": nms._greedy_keep}
    out = {}
    try:
        for max_det in (16, 300):
            kw = dict(conf_thresh=0.001, iou_thresh=0.5, max_det=max_det, multi_label=True,
                      merge=True)
            results, ms = {}, {name: [] for name in loops}
            for name in ("loop", "host", "while_loop", "while_loop", "host", "loop"):
                nms._greedy_keep = loops[name]
                results[name] = nms.non_max_suppression(pred, **kw)
                ms[name].append(timer(lambda: nms.non_max_suppression(pred, **kw)))
            rounds = []
            nms._greedy_keep = lambda valid, sup: host_fixed_point(valid, sup, rounds)
            nms.non_max_suppression(pred, **kw)
            same = all(torch.equal(a, b) for name in ("host", "while_loop")
                       for a, b in zip(results["loop"], results[name]))
            out[f"max_det_{max_det}"] = {"ms": ms, "rounds": rounds[-1], "same_result": same}
            assert same, f"max_det {max_det}: the loops disagree"
    finally:
        nms._greedy_keep = loops["while_loop"]
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("time_torch_nms: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    names = sorted(os.listdir(IMAGES))[:8]
    canvases, shapes = read_canvases([os.path.join(IMAGES, f) for f in names], 1280,
                                     NativeCanvasLoader(8))
    trans, region = _geom_to_arrays([letterbox_params(h, w) for h, w in shapes])
    det = YOLOv5Detector(scale_name="l", conf_thresh=0.001)
    pred = det.forward(*(torch.from_numpy(a).cuda() for a in (canvases, trans, region)), 640, 640)
    print(json.dumps({"card": card, "batch": 8, "pred_shape": list(pred.shape),
                      **time_loops(pred)}))


if __name__ == "__main__":
    main()
