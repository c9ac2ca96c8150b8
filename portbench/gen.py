"""The general traffic generator: a traffic file's parameters and a seed in,
a pool of host batches in the pipeline's format out.

Every mix of ``traffic/`` is read by this one generator; a mix is data.
A batch is what the port's pipeline hands the device when canvases are
deduplicated (one 640x640 uint8 canvas per image, ``canvas_slots`` slots a
batch, ``canvas_idx`` naming each crop's slot), as numpy arrays in host
memory:

  * ``canvas``    u8  [slots, S, S, 3]: each image (``image_wh``, uniform
                      noise) pasted at the origin, zeros elsewhere;
  * ``canvas_idx`` i32 [batch]
  * ``trans``     f32 [batch, 2, 3]: image -> network input affine;
  * ``trans_inv`` f32 [batch, 2, 3]: heatmap -> image affine;
  * ``joints``    f32 [batch, J, 3]: joints in heatmap coordinates (x, y,
                      visibility), moved by the affine where visible;
  * ``center``, ``scale``, ``rot`` f32: the crop geometry, which the plain
                      reference rebuilds its affines from.

Each image holds 1 to 4 people with the mix's odds; a batch takes images
until it holds ``batch`` people (the last image gives only as many as fit).
The people-per-image draws of a batch are redrawn, from the same generator,
while more than ``canvas_slots`` images would be needed.  Boxes are
``box_w`` x ``box_h`` pixels, centred inside the image.  Joints lie in
their box; their visibility is 0, 1 or 2 with ``joint_vis_odds``.

With ``augment`` the geometry is drawn as the port's training pipeline
draws it (``data/pipeline._SampleTransform``: the DPG box jitter, a scale
factor, a rotation, a horizontal flip folded into the affine with the
joints flipped and their left/right pairs swapped); without it the box is
taken as it is, unrotated, as the eval pipeline does.  The affine
arithmetic is a copy of the port's ``ops/affine.py`` (itself a copy of the
reference's ``commons/joint_utils.py``).

The work of a batch (its shapes, the number of people, slots and joints)
is the same for every seed; the seed changes content and geometry only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_pool", "JOINT_PAIRS", "box_to_center_scale", "get_affine_transform"]

# left/right joint pairs of COCO's 17 keypoints
JOINT_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


def box_to_center_scale(x, y, w, h, aspect_ratio, scale_mult=1.25):
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.array([w, h], dtype=np.float32) * scale_mult


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float64)


def _solve_affine(src, dst):
    a = np.concatenate([np.asarray(src, np.float64), np.ones((3, 1))], axis=1)
    return np.ascontiguousarray(np.linalg.solve(a, np.asarray(dst, np.float64)).T)


def get_affine_transform(center, scale, rot, output_size):
    """(trans, trans_inv), 2x3 float64: source image <-> an output patch of
    ``output_size`` (w, h), by the reference's three-point construction."""
    scale = np.asarray(scale, np.float64).reshape(2)
    center = np.asarray(center, np.float64).reshape(2)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    rad = np.pi * float(rot) / 180.0
    sn, cs = np.sin(rad), np.cos(rad)
    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center
    src[1] = center + np.array([scale[0] * 0.5 * sn, -scale[0] * 0.5 * cs])
    src[2] = _third_point(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + np.array([0.0, -dst_w * 0.5])
    dst[2] = _third_point(dst[0], dst[1])
    return _solve_affine(src, dst), _solve_affine(dst, src)


def _hflip_affine(width):
    return np.array([[-1.0, 0.0, float(width) - 1.0], [0.0, 1.0, 0.0]])


def _compose(m2, m1):
    out = np.zeros((2, 3))
    out[:, :2] = m2[:, :2] @ m1[:, :2]
    out[:, 2] = m2[:, :2] @ m1[:, 2] + m2[:, 2]
    return out


def _box_jitter(bbox, img_w, img_h, rng):
    """The DPG box augmentation (reference commons/joint_utils.py:6-36)."""
    x1, y1, x2, y2 = (float(v) for v in bbox)
    width, ht = x2 - x1, y2 - y1
    path_scale = rng.uniform(0, 1)
    if path_scale > 0.85:
        ratio = ht / width
        if width < ht:
            pw = path_scale * width
            ph = pw * ratio
        else:
            ph = path_scale * ht
            pw = ph / ratio
        xmin = x1 + rng.uniform(0, 1) * (width - pw)
        ymin = y1 + rng.uniform(0, 1) * (ht - ph)
        return [xmin, ymin, xmin + pw + 1, ymin + ph + 1]
    xmin = max(1, min(x1 + rng.normal(-0.0142, 0.1158) * width, img_w - 3))
    ymin = max(1, min(y1 + rng.normal(0.0043, 0.068) * ht, img_h - 3))
    xmax = min(max(xmin + 2, x2 + rng.normal(0.0154, 0.1337) * width), img_w - 3)
    ymax = min(max(ymin + 2, y2 + rng.normal(-0.0013, 0.0711) * ht), img_h - 3)
    return [xmin, ymin, xmax, ymax]


def _people_counts(rng, mix):
    """People per image of one batch: exactly ``batch`` in at most
    ``canvas_slots`` images."""
    odds = np.asarray(mix["people_odds"], np.float64)
    while True:
        counts = rng.choice(np.arange(1, len(odds) + 1), size=mix["batch"], p=odds / odds.sum())
        total = np.cumsum(counts)
        n = int(np.searchsorted(total, mix["batch"])) + 1
        if n <= mix["canvas_slots"]:
            counts = counts[:n].copy()
            counts[-1] -= total[n - 1] - mix["batch"]
            return counts


def _geometry(rng, mix, box, joints, img_w, img_h):
    """One crop's (trans, trans_inv, joints in heatmap coords, center,
    scale, rot) as the port's pipeline computes them."""
    in_w, in_h = mix["input_wh"]
    heat_wh = (in_w // 4, in_h // 4)
    aug = mix.get("augment")
    bbox = list(box)
    if aug:
        bbox = _box_jitter(bbox, img_w, img_h, rng)
    x1, y1, x2, y2 = bbox
    center, scale = box_to_center_scale(x1, y1, x2 - x1, y2 - y1, in_w / in_h)
    rot = 0.0
    if aug:
        scale = scale * rng.uniform(*aug["scale"])
        rot = rng.uniform(*aug["rot"])
    flipped = bool(aug) and rng.uniform() < aug["flip"]
    if flipped:
        joints = joints.copy()
        joints[:, 0] = img_w - joints[:, 0] - 1
        for a, b in JOINT_PAIRS:
            joints[[a, b]] = joints[[b, a]]
        center = center.copy()
        center[0] = img_w - center[0] - 1
    trans, _ = get_affine_transform(center, scale, rot, (in_w, in_h))
    out_trans, out_inv = get_affine_transform(center, scale, rot, heat_wh)
    if flipped:
        trans = _compose(trans, _hflip_affine(img_w))
    j = joints.copy()
    vis = j[:, 2] > 0
    j[vis, :2] = np.concatenate([j[vis, :2], np.ones((vis.sum(), 1))], axis=1) @ out_trans.T
    return trans, out_inv, j, center, scale, rot


def make_pool(mix: dict, seed: int) -> list:
    """``mix["pool_batches"]`` host batches of the mix, from ``seed``."""
    rng = np.random.default_rng(int(seed))
    img_w, img_h = mix["image_wh"]
    s, slots, bs = mix["canvas"], mix["canvas_slots"], mix["batch"]
    nj = mix["num_joints"]
    vis_odds = np.asarray(mix["joint_vis_odds"], np.float64)
    pool = []
    for _ in range(mix["pool_batches"]):
        counts = _people_counts(rng, mix)
        canvas = np.zeros((slots, s, s, 3), np.uint8)
        canvas[:len(counts), :img_h, :img_w] = rng.integers(
            0, 256, (len(counts), img_h, img_w, 3), dtype=np.uint8)
        batch = {"canvas": canvas, "canvas_idx": np.zeros(bs, np.int32),
                 "trans": np.zeros((bs, 2, 3), np.float32),
                 "trans_inv": np.zeros((bs, 2, 3), np.float32),
                 "joints": np.zeros((bs, nj, 3), np.float32),
                 "center": np.zeros((bs, 2), np.float32), "scale": np.zeros((bs, 2), np.float32),
                 "rot": np.zeros(bs, np.float32)}
        k = 0
        for slot, n in enumerate(counts):
            for _ in range(n):
                bw, bh = rng.uniform(*mix["box_w"]), rng.uniform(*mix["box_h"])
                cx, cy = rng.uniform(0, img_w), rng.uniform(0, img_h)
                box = (cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2)
                joints = np.zeros((nj, 3))
                joints[:, 0] = rng.uniform(box[0], box[2], nj)
                joints[:, 1] = rng.uniform(box[1], box[3], nj)
                joints[:, 2] = rng.choice(len(vis_odds), size=nj, p=vis_odds / vis_odds.sum())
                geo = _geometry(rng, mix, box, joints, img_w, img_h)
                batch["canvas_idx"][k] = slot
                (batch["trans"][k], batch["trans_inv"][k], batch["joints"][k],
                 batch["center"][k], batch["scale"][k], batch["rot"][k]) = geo
                k += 1
        pool.append(batch)
    return pool
