"""COCO person-keypoints annotation loading (host side, no pycocotools).

Numpy copy of simple_pose_tpu/data/coco.py (pose records and detector
boxes), kept so the port imports nothing of the JAX package.

Record filtering mirrors datasets/coco.py:74-107 (__load_in): clip the box to
the image, drop zero-area/degenerate boxes, drop annotations without
keypoints, binarize visibility at v >= 1, drop instances with no visible
joint, skip iscrowd annotations.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["PoseRecord", "DetBoxRecord", "load_coco_keypoints", "load_detection_boxes",
           "JOINT_PAIRS"]

# left/right joint index pairs for horizontal flip (datasets/coco.py:26)
JOINT_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


@dataclass
class PoseRecord:
    img_path: str
    width: int
    height: int
    box: List[float]  # xyxy
    joints: np.ndarray  # [17, 3] float32, vis binarized
    img_id: int


@dataclass
class DetBoxRecord:
    """A detector-produced person box (datasets/naive_data.py:14-30)."""

    img_path: str
    box: List[float]  # xyxy
    score: float
    img_id: int


def _center_inconsistent(box, joints):
    """Center-consistency filter (datasets/coco.py:96-122, off by default in
    the reference too): drop instances whose keypoint centroid is far from
    the box center relative to the box area."""
    x1, y1, x2, y2 = box
    bbox_center = np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])
    bbox_area = (y2 - y1) * (x2 - x1)
    vis = joints[:, 2] > 0
    num = float(joints[:, 2].sum())
    kp_center = np.array(
        [np.sum(joints[:, 0] * vis) / num, np.sum(joints[:, 1] * vis) / num]
    )
    ks = np.exp(-2 * np.sum(np.square(bbox_center - kp_center)) / bbox_area)
    return (num / 80.0 + 47 / 80.0) > ks


def load_coco_keypoints(img_root: str, ann_path: str, debug: int = 0,
                        check_center: bool = False) -> List[PoseRecord]:
    with open(ann_path) as rf:
        data = json.load(rf)
    images = {img["id"]: img for img in data["images"]}
    anns_by_img = {}
    for a in data["annotations"]:
        if a.get("category_id", 1) != 1 or a.get("iscrowd", 0):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)

    records: List[PoseRecord] = []
    for img_id, entry in images.items():
        file_name = entry.get("coco_url", entry.get("file_name", "")).split("/")[-1]
        file_path = os.path.join(img_root, file_name)
        width, height = entry["width"], entry["height"]
        for obj in anns_by_img.get(img_id, []):
            x1, y1, w, h = obj["bbox"]
            x1, y1 = max(0, x1), max(0, y1)
            x2 = min(x1 + max(0, w - 1), width - 1)
            y2 = min(y1 + max(0, h - 1), height - 1)
            if obj.get("area", 0) <= 0 or x2 <= x1 or y2 <= y1:
                continue
            if obj.get("num_keypoints", 0) == 0:
                continue
            joints = np.array(obj["keypoints"], dtype=np.float32).reshape(-1, 3)
            joints[:, 2] = (joints[:, 2] >= 1).astype(np.float32)
            if joints[:, 2].sum() < 1.0:
                continue
            if check_center and _center_inconsistent((x1, y1, x2, y2), joints):
                continue
            records.append(PoseRecord(file_path, width, height, [x1, y1, x2, y2], joints, img_id))
            if debug and len(records) >= debug:
                return records
    return records


def load_detection_boxes(img_root: str, det_json_path: str, debug: int = 0,
                         img_ext: str = ".jpg") -> List[DetBoxRecord]:
    """Load a COCO detection-results JSON (person category only), mirroring
    datasets/naive_data.py:85-102: each image resolves to
    ``{img_root}/{image_id:012d}.jpg`` (``img_ext`` in place of ``.jpg``:
    ``.png`` for a corpus painted as PNGs); ``debug`` keeps the first N
    boxes."""
    with open(det_json_path) as rf:
        data = json.load(rf)
    records: List[DetBoxRecord] = []
    for item in data:
        if item.get("category_id", 1) != 1:
            continue
        x, y, w, h = item["bbox"]
        img_id = item["image_id"]
        file_path = os.path.join(img_root, "{0:012d}{1}".format(img_id, img_ext))
        records.append(DetBoxRecord(file_path, [x, y, x + w, y + h], item["score"], img_id))
        if debug and len(records) >= debug:
            break
    return records
