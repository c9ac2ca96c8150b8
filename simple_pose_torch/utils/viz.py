"""Debug visualization: skeleton and heatmap overlays, and a PNG writer.

Port of simple_pose_tpu/utils/viz.py (the reference's KeyPoints.draw_img /
draw_heat_map, commons/transforms.py:33-61, with the COCO bone and joint
colour tables of datasets/coco.py:27-42), in numpy alone: the H100
machine has no cv2.  The shapes are cv2's own rasterization with LINE_8
and integer points (imgproc/drawing.cpp), repeated step for step:

* a filled circle (``cv.circle(img, c, r, color, -1)``): ``Circle``'s
  midpoint spans;
* a line of thickness 2 (``cv.line``): ``ThickLine``, the segment clipped
  to the image grown by 2 px, then a convex quad in 16-bit fixed point
  (``FillConvexPoly``: its edges drawn by ``Line2``, then a scan fill) and
  a radius-1 disc on each end;
* a rectangle of thickness 2 (``cv.rectangle``): ``PolyLine``, the four
  edges as such lines, a disc on each edge's end only;
* every shape clipped to the image (``clipLine`` for the edges).

``write_png`` writes an RGB or grayscale uint8 image with the standard
library's zlib; ``read_png`` reads what it writes back.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

__all__ = ["BONES", "JOINT_COLORS", "BONE_COLORS", "draw_pose", "draw_heat_map",
           "write_png", "read_png"]

BONES = (
    (0, 1), (0, 2), (1, 3), (2, 4),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10),
    (5, 11), (6, 12), (11, 12), (11, 13), (12, 14), (13, 15), (14, 16),
)

JOINT_COLORS = (
    (187, 183, 180), (149, 32, 71), (92, 113, 184), (131, 7, 201),
    (56, 20, 219), (243, 201, 77), (13, 74, 96), (79, 14, 44),
    (195, 150, 66), (2, 249, 42), (195, 135, 43), (105, 70, 66),
    (120, 107, 116), (122, 241, 22), (17, 19, 179), (162, 185, 124), (31, 65, 117),
)

BONE_COLORS = (
    (67, 68, 113), (130, 45, 169), (2, 202, 130), (127, 111, 90),
    (92, 136, 113), (33, 250, 7), (238, 92, 104), (0, 151, 197), (134, 9, 145),
    (253, 181, 88), (246, 11, 137), (55, 72, 220), (136, 8, 253), (56, 73, 180),
    (85, 241, 53), (153, 207, 15),
)

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _hline(img, y, x1, x2, color):
    """ICV_HLINE: x1..x2 inclusive on row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _put(img, x, y, color):
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color


def _circle(img, cx, cy, radius, color):
    """drawing.cpp Circle with fill: midpoint spans."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w, h, x1, y1, x2, y2):
    """drawing.cpp clipLine on a w x h area: the clipped ends, or None."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _line2(img, p1, p2, color):
    """drawing.cpp Line2: an 8-connected line between fixed-point ends."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img, v, color):
    """drawing.cpp FillConvexPoly for LINE_8 with XY_SHIFT points: the
    outline by Line2, then the scan fill between the left and right edge."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    y, edges = ymin, npts
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0, di = e["idx"], e["di"]
            idx = (idx0 + di) % npts
            while True:
                old, edges = edges, edges - 1
                if old <= 0:
                    break
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e.update(ye=ty, dx=_tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), x=xs,
                             idx=idx)
                    break
                idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, xx1, xx2, color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, color, caps):
    """drawing.cpp ThickLine with thickness 2 (LINE_8, integer points):
    ``caps`` 3 puts a disc on both ends, 2 on the second only.  cv2 first
    clips the segment to the image grown by 2 px on each side."""
    h, w = img.shape[:2]
    clipped = _clip_line(w + 4, h + 4, p0[0] + 2, p0[1] + 2, p1[0] + 2, p1[1] + 2)
    if clipped is None:
        return
    p0, p1 = (clipped[0] - 2, clipped[1] - 2), (clipped[2] - 2, clipped[3] - 2)
    p0 = (p0[0] << XY_SHIFT, p0[1] << XY_SHIFT)
    p1 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    half = 2 << (XY_SHIFT - 1)
    dx, dy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = half / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)  # cvRound: half to even
        _fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)], color)
    for i, p in enumerate((p0, p1)):
        if caps & (i + 1):
            _circle(img, (p[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p[1] + (XY_ONE >> 1)) >> XY_SHIFT,
                    (half + (XY_ONE >> 1)) >> XY_SHIFT, color)


def draw_pose(img, joints, box=None, bones=BONES, bone_colors=BONE_COLORS,
              joint_colors=JOINT_COLORS):
    """:param img: HxWx3 uint8 (a modified copy is returned); colours are
        written in the image's channel order, as cv2 writes them
    :param joints: [K, 3] (x, y, vis/conf); joints with column 2 == 0 skipped
    :param box: optional (x1, y1, x2, y2), drawn in (255, 0, 0)"""
    out = np.ascontiguousarray(np.array(img, dtype=np.uint8, copy=True))
    for idx, (a, b) in enumerate(bones):
        ja, jb = joints[a], joints[b]
        pa, pb = (int(ja[0]), int(ja[1])), (int(jb[0]), int(jb[1]))
        if ja[2] != 0:
            _circle(out, *pa, 2, joint_colors[a])
        if jb[2] != 0:
            _circle(out, *pb, 2, joint_colors[b])
        if ja[2] != 0 and jb[2] != 0:
            _thick_line(out, pa, pb, bone_colors[idx], caps=3)
    if box is not None:
        x1, y1, x2, y2 = (int(v) for v in box)
        corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
        for k in range(4):
            _thick_line(out, corners[k - 1], corners[k], (255, 0, 0), caps=2)
    return out


def draw_heat_map(heat_map, mask=None):
    """[K, H, W] float maps -> HxWx3 uint8 max-composite visualization
    (KeyPoints.draw_heat_map parity, transforms.py:56-61)."""
    heat_map = np.asarray(heat_map)
    if mask is not None:
        heat_map = heat_map * np.asarray(mask)[:, None, None]
    ret = (np.clip(heat_map.max(axis=0), 0, 1) * 255).astype(np.uint8)
    return np.repeat(ret[..., None], 3, axis=-1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img) -> int:
    """Write an HxWx3 RGB or HxW grayscale uint8 image as an 8-bit PNG
    (filter type 0, zlib level 6).  Returns the byte count."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes HxWx3 or HxW uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    colour = 2 if img.ndim == 3 else 0
    blob = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def read_png(path) -> np.ndarray:
    """Read a PNG that :func:`write_png` wrote (8-bit RGB or grayscale,
    filter type 0 on every row): HxWx3 or HxW uint8.

    :raises ValueError: on any other PNG, or a chunk whose CRC fails"""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        n, kind = struct.unpack(">I", blob[pos:pos + 4])[0], blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        if struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + data):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] not in ((8, 2, 0, 0, 0), (8, 0, 0, 0, 0)):
        raise ValueError(f"{path}: not an 8-bit RGB or grayscale PNG: {header}")
    w, h, colour = header[0], header[1], header[3]
    c = 3 if colour == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for {w}x{h}")
    rows = raw.reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    img = rows[:, 1:].reshape(h, w, c)
    return img if c == 3 else img[..., 0]
