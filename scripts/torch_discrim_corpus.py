"""The discriminative held-out AP gate's corpora, painted without cv2.

The counterparts of ``tests/util_synth.make_discriminative_coco`` and
``make_flipsym_coco`` (the JAX gate's corpora, scripts/drive_discrim_ap.py)
for the PyTorch port, whose card has no cv2 and no JPEG encoder:

* the same signatures, defaults and arithmetic: the same
  ``numpy.random.default_rng`` draws in the same order, the rejection
  sampling, ``joint_sep``, occluders painted after all people, a float32
  canvas clipped to uint8;
* cv2's drawing is the port's own (``simple_pose_torch/utils/viz.py``,
  cv2's rasterization step for step): ``cv.circle(..., -1)`` is
  ``_circle`` and a thickness-2 ``cv.line`` is ``_thick_line``; the hue
  palettes are the BGR constants ``cv.cvtColor(HSV2BGR)`` gives;
* each image is written losslessly as ``{id:012d}.png`` (RGB, through
  ``write_png``): cv2 would read back the BGR array that was painted,
  which the JAX corpus holds before its q98 JPEG encode.  The annotations
  differ from the JAX corpus's only in the ``.png`` suffix.

Imports numpy and the port's viz module only.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from simple_pose_torch.utils.viz import _circle, _thick_line, write_png  # noqa: E402

# cv.cvtColor(np.uint8([[[int(j * 180 / 17), 255, 255]]]), cv.COLOR_HSV2BGR)
# for j in range(17): 17 maximally-separated hues, BGR
HUES_17 = [(0, 0, 255), (0, 85, 255), (0, 179, 255), (0, 255, 246), (0, 255, 153),
           (0, 255, 68), (26, 255, 0), (119, 255, 0), (204, 255, 0), (255, 212, 0),
           (255, 127, 0), (255, 34, 0), (255, 0, 60), (255, 0, 145), (255, 0, 238),
           (187, 0, 255), (93, 0, 255)]
# the same with int(c * 180 / 9) for c in range(9): the nose, then one hue
# per left/right pair
HUES_9 = [(0, 0, 255), (0, 170, 255), (0, 255, 170), (0, 255, 0), (170, 255, 0),
          (255, 170, 0), (255, 0, 0), (255, 0, 170), (170, 0, 255)]

# the flip-symmetric skeleton in units of the person's spread (x = the
# person's left = image +x; y grows downward): the nose, then (|x|, y) per
# left/right pair in COCO order
_FLIPSYM_LAYOUT = {
    0: (0.0, -2.4),
    1: (0.45, -1.8), 2: (1.05, -2.1), 3: (0.95, -1.0), 4: (1.55, -0.2),
    5: (1.75, 0.7), 6: (0.50, 0.45), 7: (0.65, 1.45), 8: (0.80, 2.4),
}
# limbs drawn in a gray per person (an edge set the left/right swap maps to
# itself)
_FLIPSYM_LIMBS = [
    (5, 7), (7, 9), (6, 8), (8, 10),
    (11, 13), (13, 15), (12, 14), (14, 16),
    (5, 6), (11, 12), (5, 11), (6, 12),
    (0, 5), (0, 6),
]
_PERSON_GRAYS = [150.0, 195.0, 120.0, 225.0]


def _image_entry(img_id, img_w, img_h):
    file_name = f"{img_id:012d}.png"
    return {"id": img_id, "width": img_w, "height": img_h,
            "coco_url": f"http://x/{file_name}", "file_name": file_name}


def _annotation(ann_id, img_id, kp):
    x0, y0 = kp[:, 0].min() - 5, kp[:, 1].min() - 5
    x1, y1 = kp[:, 0].max() + 5, kp[:, 1].max() + 5
    return {
        "id": ann_id, "image_id": img_id, "category_id": 1,
        "keypoints": kp.reshape(-1).tolist(), "num_keypoints": 17,
        "area": float((x1 - x0) * (y1 - y0)),
        "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
        "iscrowd": 0,
    }


def _occlude_and_write(img, occluders, path):
    """Paint the occluders (after every person, so one may hide a
    neighbour's joint) and write the BGR float canvas as an RGB PNG."""
    for (ox, oy, r) in occluders:
        img[int(max(0, oy - r)):int(oy + r) + 1, int(max(0, ox - r)):int(ox + r) + 1] = 96.0
    write_png(path, np.clip(img, 0, 255).astype(np.uint8)[..., ::-1])


def _write_ann(root, images, annotations):
    gt = {"images": images, "annotations": annotations,
          "categories": [{"id": 1, "name": "person"}]}
    ann_path = os.path.join(root, "ann.json")
    with open(ann_path, "w") as wf:
        json.dump(gt, wf)
    return ann_path, gt


def _disc(img, x, y, radius, color):
    """cv.circle(img, (round(x), round(y)), radius, color, -1)."""
    _circle(img, int(round(x)), int(round(y)), radius, color)


def paint_flipsym(root, num_images=24, img_w=192, img_h=160, seed=100, people_per_image=1,
                  scale_range=(10.0, 16.0), occlude_frac=0.0, blob_sigma=2.5,
                  draw_limbs=True, min_center_sep=2.8):
    """The flip-symmetric corpus (``make_flipsym_coco``): each left/right
    pair shares one hue and its identity comes from the body layout (the
    left member at +x of the body axis), so a mirrored image with swapped
    labels is another sample of the corpus.  Writes ``{root}/imgs/*.png``
    and ``{root}/ann.json``.

    :returns: (img_root, ann_path, gt)"""
    rng = np.random.default_rng(seed)
    img_root = os.path.join(root, "imgs")
    os.makedirs(img_root, exist_ok=True)
    if np.isscalar(people_per_image):
        people_per_image = [int(people_per_image)] * num_images
    if len(people_per_image) != num_images:
        raise ValueError(f"{len(people_per_image)} people counts for {num_images} images")
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        img = rng.integers(40, 120, size=(img_h, img_w, 3)).astype(np.float32)
        images.append(_image_entry(img_id, img_w, img_h))
        occluders, centers = [], []
        for pi in range(people_per_image[img_id - 1]):
            spread = rng.uniform(*scale_range)
            for _try in range(40):
                cx = rng.uniform(2.1 * spread, img_w - 2.1 * spread)
                cy = rng.uniform(2.9 * spread, img_h - 2.9 * spread)
                if all((cx - a) ** 2 + (cy - b) ** 2 > (min_center_sep * max(spread, sp)) ** 2
                       for a, b, sp in centers):
                    break
            centers.append((cx, cy, spread))
            kp = np.zeros((17, 3), dtype=np.float64)
            for j in range(17):
                if j == 0:
                    ox, oy = _FLIPSYM_LAYOUT[0]
                else:
                    mag, oy = _FLIPSYM_LAYOUT[1 + (j - 1) // 2]
                    ox = mag if j % 2 == 1 else -mag  # odd = left = +x
                jx = float(np.clip(rng.normal(0.0, 0.12), -0.30, 0.30))
                jy = float(np.clip(rng.normal(0.0, 0.15), -0.40, 0.40))
                if j == 0:
                    jx = float(np.clip(jx, -0.25, 0.25))
                kp[j, 0] = np.clip(cx + (ox + jx) * spread, 2.0, img_w - 3.0)
                kp[j, 1] = np.clip(cy + (oy + jy) * spread, 2.0, img_h - 3.0)
            kp[:, 2] = 2
            if draw_limbs:
                g = _PERSON_GRAYS[pi % len(_PERSON_GRAYS)]
                for a, b in _FLIPSYM_LIMBS:
                    _thick_line(img, (int(round(kp[a, 0])), int(round(kp[a, 1]))),
                                (int(round(kp[b, 0])), int(round(kp[b, 1]))), (g, g, g), caps=3)
            for j in range(17):
                ci = 0 if j == 0 else 1 + (j - 1) // 2
                _disc(img, kp[j, 0], kp[j, 1], max(2, int(round(blob_sigma))), HUES_9[ci])
            for j in range(17):
                if rng.uniform() < occlude_frac:
                    occluders.append((kp[j, 0], kp[j, 1], max(2.0, blob_sigma * 2.5)))
            annotations.append(_annotation(ann_id, img_id, kp))
            ann_id += 1
        _occlude_and_write(img, occluders, os.path.join(img_root, images[-1]["file_name"]))
    ann_path, gt = _write_ann(root, images, annotations)
    return img_root, ann_path, gt


def paint_discriminative(root, num_images=24, img_w=192, img_h=160, seed=100,
                         people_per_image=2, scale_range=(6.0, 26.0), occlude_frac=0.15,
                         blob_sigma=1.6, joint_sep=0.0):
    """The color corpus (``make_discriminative_coco``): 17 hues encode the
    joints' identity, discs painted at the rounded joint while the ground
    truth keeps the float position, a scale sweep per person, occluders.
    ``joint_sep`` > 0 rejection-samples each joint at least that far from
    the person's others (best of 40).  Writes ``{root}/imgs/*.png`` and
    ``{root}/ann.json``.

    :returns: (img_root, ann_path, gt)"""
    rng = np.random.default_rng(seed)
    img_root = os.path.join(root, "imgs")
    os.makedirs(img_root, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        img = rng.integers(40, 120, size=(img_h, img_w, 3)).astype(np.float32)
        centers = []
        images.append(_image_entry(img_id, img_w, img_h))
        occluders = []
        for _ in range(int(people_per_image)):
            spread = rng.uniform(*scale_range)
            for _try in range(20):
                cx = rng.uniform(2.2 * spread, img_w - 2.2 * spread)
                cy = rng.uniform(2.2 * spread, img_h - 2.2 * spread)
                if all((cx - a) ** 2 + (cy - b) ** 2 > (2.5 * spread) ** 2 for a, b in centers):
                    break
            centers.append((cx, cy))
            kp = np.zeros((17, 3), dtype=np.float64)
            if joint_sep > 0:
                pts = []
                for _j in range(17):
                    best, best_d = None, -1.0
                    for _try in range(40):
                        x = float(np.clip(rng.normal(cx, spread), 2.0, img_w - 3.0))
                        y = float(np.clip(rng.normal(cy, spread * 1.25), 2.0, img_h - 3.0))
                        d = min(((x - a) ** 2 + (y - b) ** 2) ** 0.5
                                for a, b in pts) if pts else float("inf")
                        if d >= joint_sep:
                            best = (x, y)
                            break
                        if d > best_d:
                            best_d, best = d, (x, y)
                    pts.append(best)
                kp[:, 0] = [p[0] for p in pts]
                kp[:, 1] = [p[1] for p in pts]
            else:
                kp[:, 0] = np.clip(rng.normal(cx, spread, 17), 2.0, img_w - 3.0)
                kp[:, 1] = np.clip(rng.normal(cy, spread * 1.25, 17), 2.0, img_h - 3.0)
            kp[:, 2] = 2
            for j in range(17):
                _disc(img, kp[j, 0], kp[j, 1], max(2, int(round(blob_sigma))), HUES_17[j])
            for j in range(17):
                if rng.uniform() < occlude_frac:
                    occluders.append((kp[j, 0], kp[j, 1], max(2.0, blob_sigma * 2.5)))
            annotations.append(_annotation(ann_id, img_id, kp))
            ann_id += 1
        _occlude_and_write(img, occluders, os.path.join(img_root, images[-1]["file_name"]))
    ann_path, gt = _write_ann(root, images, annotations)
    return img_root, ann_path, gt

