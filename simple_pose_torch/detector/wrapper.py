"""Detector front end (the reference's YOLOv5Detector,
detector/yolov5_detector.py:129-239).

Port of simple_pose_tpu/detector/wrapper.py:

  * The letterbox (ScalePadding) runs on the device from the uint8 canvas:
    ops/warp.affine_crop_separable with cv2.resize's half-pixel centres,
    the 114 padding by a region mask, BGR -> RGB and /255.  Under amp the
    f32 resample is cast to the compute dtype before the mask and the /255,
    as the JAX package writes it in the compute dtype.
  * The default letterbox is the square ``scale_size``; ``rect=True`` groups
    images into mod-64 minimum-rectangle buckets (``rect_letterbox_params``:
    ``r`` against the full size, only the offset follows the bucket).
  * The person head is sliced at load time (``slice_person_head``: the head
    convs keep [x, y, w, h, obj, cls_i]) instead of the reference's MConv2D
    surgery.
  * NMS is detector/nms.non_max_suppression.
  * ``quant='w8a8'`` runs the detector's convs in int8 (models/quant.py);
    ``calibrate`` records static activation scales at the square letterbox
    (rect buckets reuse them: scales are per conv).

Canvases are BGR, as cv2.imread gives them, with the image at the origin
and a replicated 1-px border (``paste_with_border``) so that the
letterbox's edge taps clamp as cv2.resize does.  :func:`read_canvases`
makes them from image files: JPEGs through the native loader
(data/native.py, RGB, flipped here), other files through cv2.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from simple_pose_torch.data import pipeline
from simple_pose_torch.detector.nms import non_max_suppression
from simple_pose_torch.detector.yolov4 import YOLOv4
from simple_pose_torch.detector.yolov5 import YOLOv5
from simple_pose_torch.models.quant import ScaleRecorder, allreduce_scales_max, quantized
from simple_pose_torch.models.registry import resolve_amp_dtype
from simple_pose_torch.ops.warp import affine_crop_separable
from simple_pose_torch.utils.device import resolve_device

__all__ = ["letterbox_params", "rect_letterbox_params", "paste_with_border", "read_canvases",
           "image_batches",
           "slice_person_head", "load_detector_state", "build_detector", "letterbox_input",
           "YOLOv5Detector", "PersonDetector"]

DETECTORS = {"yolov5": YOLOv5, "yolov4": YOLOv4}


def _replicate_border(canvas: np.ndarray, ch: int, cw: int):
    """Copy the last pasted row and column one pixel outward."""
    if ch < canvas.shape[0]:
        canvas[ch, :cw] = canvas[ch - 1, :cw]
    if cw < canvas.shape[1]:
        canvas[:ch + 1, cw] = canvas[:ch + 1, cw - 1]


def paste_with_border(canvas: np.ndarray, img: np.ndarray):
    """Paste ``img`` at the canvas origin and replicate a 1-px border so the
    device letterbox's edge taps clamp like cv2.resize instead of reading
    the zero padding.

    :returns: (ch, cw) pasted extent"""
    ch = min(img.shape[0], canvas.shape[0])
    cw = min(img.shape[1], canvas.shape[1])
    canvas[:ch, :cw] = img[:ch, :cw]
    _replicate_border(canvas, ch, cw)
    return ch, cw


def read_canvases(paths, canvas: int, loader=None):
    """Image files -> (canvases u8 [n, canvas, canvas, 3] BGR, each image at
    the origin with paste_with_border's border, shapes [(h, w)]).

    JPEGs go through ``loader`` (a data/native.NativeCanvasLoader) when one
    is given; anything else through cv2."""
    n = len(paths)
    if loader is not None and n and pipeline._all_jpeg(paths):
        out, heights, widths = loader.load_batch(paths, canvas)
        shapes = [(int(h), int(w)) for h, w in zip(heights, widths)]
        for slot, (h, w) in zip(out, shapes):
            ch, cw = min(h, canvas), min(w, canvas)
            slot[:ch, :cw] = slot[:ch, :cw, ::-1]  # the loader gives RGB
            _replicate_border(slot, ch, cw)
        return out, shapes
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    shapes = []
    for slot, path in zip(out, paths):
        img = pipeline._imread_rgb(path)[..., ::-1]
        paste_with_border(slot, img)
        shapes.append(img.shape[:2])
    return out, shapes


def image_batches(img_root, images, batch_size: int, canvas: int, loader=None):
    """COCO ``images`` entries in fixed-size batches of canvases: yields
    (entries, canvases [batch_size, canvas, canvas, 3] BGR, shapes), the
    last batch padded with empty canvases of shape (canvas, canvas).  A
    ``None`` entry (a rank's equalization pad, at the end of ``images``)
    is an empty canvas too."""
    for start in range(0, len(images), batch_size):
        chunk = images[start:start + batch_size]
        real = [e for e in chunk if e is not None]
        assert chunk[:len(real)] == real, "None entries pad the end of images"
        paths = [os.path.join(img_root, e.get("coco_url", e.get("file_name", "")).split("/")[-1])
                 for e in real]
        canvases, shapes = read_canvases(paths, canvas, loader)
        pad = batch_size - len(real)
        if pad:
            canvases = np.concatenate([canvases, np.zeros((pad,) + canvases.shape[1:], np.uint8)])
        yield chunk, canvases, list(shapes) + [(canvas, canvas)] * pad


def letterbox_params(h, w, target=(640, 640), scale_up=True):
    """Scale/offset of the reference ScalePadding.make_border
    (yolov5_detector.py:145-166) with minimum_rectangle=False.

    :returns: (r, left, top, new_w, new_h)"""
    tw, th = target
    r = min(th / h, tw / w)
    if not scale_up:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (tw - new_w) / 2, (th - new_h) / 2
    left, top = int(round(dw - 0.1)), int(round(dh - 0.1))
    return r, left, top, new_w, new_h


def rect_letterbox_params(h, w, target=(640, 640), mod=64, scale_up=True):
    """Minimum-rectangle letterbox in mod-``mod`` buckets (the reference's
    minimum_rectangle mode, yolov5_detector.py:151-160): ``r`` against the
    full target, the canvas shrunk to the next multiple of ``mod``.

    :returns: ((bw, bh), r, left, top, new_w, new_h)"""
    tw, th = target
    r = min(th / h, tw / w)
    if not scale_up:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    bw = min(tw, -(-new_w // mod) * mod)
    bh = min(th, -(-new_h // mod) * mod)
    dw, dh = (bw - new_w) / 2, (bh - new_h) / 2
    left, top = int(round(dw - 0.1)), int(round(dh - 0.1))
    return (bw, bh), r, left, top, new_w, new_h


def _letterbox_trans(r, left, top):
    """src->dst affine with cv2.resize half-pixel centres:
    dst = r*(src + 0.5) - 0.5 + offset."""
    return np.array(
        [[r, 0.0, r * 0.5 - 0.5 + left], [0.0, r, r * 0.5 - 0.5 + top]], dtype=np.float32
    )


def _geom_to_arrays(geom):
    """[(r, left, top, new_w, new_h)] -> (trans [B,2,3], region [B,4])."""
    b = len(geom)
    trans = np.zeros((b, 2, 3), np.float32)
    region = np.zeros((b, 4), np.float32)
    for i, (r, left, top, new_w, new_h) in enumerate(geom):
        trans[i] = _letterbox_trans(r, left, top)
        region[i] = [left, top, left + new_w, top + new_h]
    return trans, region


def letterbox_input(canvases, trans, region, th, tw, lb_dtype=torch.float32):
    """Device letterbox: separable resample from the uint8 canvas, the 114
    pad outside ``region``, BGR -> RGB, /255.

    :returns: the network input, [B, 3, th, tw] in ``lb_dtype``"""
    crops = affine_crop_separable(canvases, trans, (th, tw)).to(lb_dtype)
    dev = crops.device
    xs = torch.arange(tw, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(th, dtype=torch.float32, device=dev)[None, :, None]
    lx, ty, rx, by = (region[:, i, None, None] for i in range(4))
    inside = (xs >= lx) & (xs < rx) & (ys >= ty) & (ys < by)
    crops = torch.where(inside[..., None], crops, torch.tensor(114.0, dtype=lb_dtype, device=dev))
    return (crops.flip(-1) / 255.0).permute(0, 3, 1, 2)


def slice_person_head(state: dict, num_cls=80, anchor_per_grid=3, slice_idx=0) -> dict:
    """Slice an ``num_cls``-class head's convs (``head.heads.{i}``) to
    [x, y, w, h, obj, cls_``slice_idx``]: a new state dict."""
    out = dict(state)
    num_out = num_cls + 5
    cols = [0, 1, 2, 3, 4, 5 + slice_idx]
    for key, t in state.items():
        if not key.startswith("head.heads."):
            continue
        per_anchor = t.reshape(anchor_per_grid, num_out, *t.shape[1:])
        out[key] = per_anchor[:, cols].reshape(anchor_per_grid * len(cols), *t.shape[1:]).clone()
    return out


def load_detector_state(weights, num_cls=80, slice_idx=0) -> dict:
    """A reference checkpoint (a path or a state dict; ``['ema']`` where
    present, ``module.`` prefixes dropped), with its head sliced to one
    class unless ``slice_idx`` < 0."""
    raw = torch.load(weights, map_location="cpu", weights_only=False) \
        if isinstance(weights, str) else weights
    if isinstance(raw, dict) and "ema" in raw:
        raw = raw["ema"]
    state = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in raw.items()}
    return slice_person_head(state, num_cls, slice_idx=slice_idx) if slice_idx >= 0 else state


def build_detector(family: str = "yolov5", num_cls: int = 1, scale_name: str = "l",
                   weights=None, source_num_cls: int = 80, slice_idx: int = 0, dtype=None):
    """The detector in eval mode on the CPU: seeded init, then ``weights``
    (see :func:`load_detector_state`) where given."""
    if family not in DETECTORS:
        raise KeyError(f"unknown detector family {family!r}")
    model = DETECTORS[family](num_cls=num_cls, scale_name=scale_name, dtype=dtype)
    if weights is not None:
        missing, unexpected = model.load_state_dict(
            load_detector_state(weights, source_num_cls, slice_idx), strict=False)
        if missing or unexpected:
            print(f"detector load: {len(missing)} missing, {len(unexpected)} unexpected")
    return model.eval()


class YOLOv5Detector:
    """Person detector for the detect -> crop -> pose pipeline.

    :param weights_path: a reference checkpoint path or state dict (an
        ``num_cls``-class head, sliced to class ``slice_idx``; ``slice_idx``
        < 0 keeps every class); None means the seeded init
    :param model_family: 'yolov5' or 'yolov4' (one head and one checkpoint
        layout, so loading and slicing are the same)
    :param device: None means CUDA (raises where no GPU is present)
    :param amp: 'auto' (bf16 on CUDA, f32 on the CPU), True or False
    :param quant: None or 'w8a8'; quant_scales: static {flax module path:
        s_x} scales (:meth:`calibrate`), convs without one stay dynamic"""

    def __init__(self, weights_path=None, num_cls: int = 80, scale_name: str = "l",
                 scale_size: Tuple[int, int] = (640, 640), iou_thresh: float = 0.6,
                 conf_thresh: float = 0.001, slice_idx: int = 0, canvas: int = 1280,
                 model_family: str = "yolov5", amp="auto", rect: bool = False,
                 device=None, quant=None, quant_scales=None):
        self.device = resolve_device(device)
        self.rect = rect
        self.scale_size = scale_size
        self.iou_thresh = iou_thresh
        self.conf_thresh = conf_thresh
        self.canvas = canvas
        self.num_cls = num_cls if slice_idx < 0 else 1
        dtype = resolve_amp_dtype(amp, self.device)
        self.model = build_detector(model_family, self.num_cls, scale_name, weights_path,
                                    num_cls, slice_idx, dtype).to(self.device)
        self.lb_dtype = dtype or torch.float32
        self.quant = quant
        self.quant_scales = quant_scales
        self.quant_ctx = quantized(self.model, quant, quant_scales)

    @torch.no_grad()
    def forward(self, canvases, trans, region, th, tw):
        """Letterbox + network on device tensors -> pred [B, N, 5 + nc] f32."""
        x = letterbox_input(canvases, trans, region, th, tw, self.lb_dtype)
        with self.quant_ctx:
            return self.model(x)

    def _device_geometry(self, geom):
        trans, region = _geom_to_arrays(geom)
        return torch.from_numpy(trans).to(self.device), torch.from_numpy(region).to(self.device)

    @torch.no_grad()
    def calibrate(self, batches, num_batches: int = 2) -> dict:
        """Record static w8a8 activation scales on the first ``num_batches``
        of ``batches`` ((canvases_u8 [B,c,c,3] BGR, shapes [(h, w)]) pairs, as
        :meth:`predict_batch` takes) with the float forward at the square
        letterbox, then run with them (JAX detector/wrapper.py:240-274).
        Max-reduced over the ranks of an initialised torch.distributed
        group.  Returns the {flax module path: s_x} dict."""
        if self.quant is None:
            raise ValueError("calibrate() requires a quant mode (quant='w8a8')")
        tw, th = self.scale_size
        rec, n = ScaleRecorder(self.model), 0
        with rec:
            for canvases_u8, shapes in batches:
                if n >= num_batches:
                    break
                trans, region = self._device_geometry(
                    [letterbox_params(h, w, self.scale_size) for h, w in shapes])
                canvases = torch.as_tensor(np.ascontiguousarray(canvases_u8)).to(self.device)
                self.model(letterbox_input(canvases, trans, region, th, tw, self.lb_dtype))
                n += 1
        if n == 0:
            raise ValueError("calibrate() got an empty batch stream")
        self.quant_scales = allreduce_scales_max(rec.scales())
        self.quant_ctx = quantized(self.model, self.quant, self.quant_scales)
        return self.quant_scales

    def _run_group(self, canvases_u8, geom, th, tw, merge, max_det):
        """Forward + NMS + box unmapping for one letterbox shape.

        geom: [(r, left, top, new_w, new_h)] per image.
        :returns: list of [n, 6] arrays in original pixel coords"""
        trans, region = self._device_geometry(geom)
        if not torch.is_tensor(canvases_u8):
            canvases_u8 = torch.from_numpy(np.ascontiguousarray(canvases_u8))
        pred = self.forward(canvases_u8.to(self.device), trans, region, th, tw)
        dets, valid = non_max_suppression(pred, conf_thresh=self.conf_thresh,
                                          iou_thresh=self.iou_thresh, max_det=max_det,
                                          multi_label=True, merge=merge)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        out = []
        for i, (r, left, top, _, _) in enumerate(geom):
            d = dets[i][valid[i]].copy()
            d[:, [0, 2]] = np.clip(d[:, [0, 2]], 0, tw)
            d[:, [1, 3]] = np.clip(d[:, [1, 3]], 0, th)
            d[:, [0, 2]] = (d[:, [0, 2]] - left) / r
            d[:, [1, 3]] = (d[:, [1, 3]] - top) / r
            out.append(d)
        return out

    def predict_batch(self, canvases_u8, shapes, merge=True, max_det=300):
        """:param canvases_u8: [B, canvas, canvas, 3] uint8 BGR (numpy or a
            tensor), images at the origin
        :param shapes: [(h, w)] original sizes
        :returns: list of [n, 6] numpy arrays (x1, y1, x2, y2, conf, cls) in
            original pixel coords"""
        if not self.rect:
            tw, th = self.scale_size
            geom = [letterbox_params(h, w, self.scale_size) for h, w in shapes]
            return self._run_group(canvases_u8, geom, th, tw, merge, max_det)
        # rect mode: one group per mod-64 bucket
        buckets, infos = {}, []
        for i, (h, w) in enumerate(shapes):
            (bw, bh), r, left, top, new_w, new_h = rect_letterbox_params(h, w, self.scale_size)
            buckets.setdefault((bh, bw), []).append(i)
            infos.append((r, left, top, new_w, new_h))
        out = [None] * len(shapes)
        for (bh, bw), idxs in buckets.items():
            group = self._run_group(canvases_u8[np.asarray(idxs)], [infos[i] for i in idxs],
                                    bh, bw, merge, max_det)
            for i, d in zip(idxs, group):
                out[i] = d
        return out

    def single_predict(self, img_bgr: np.ndarray):
        """Reference-parity API (yolov5_detector.py:217-239): BGR image in,
        [n, 6] boxes in original pixel coords out."""
        h, w = img_bgr.shape[:2]
        canvas = np.zeros((self.canvas, self.canvas, 3), np.uint8)
        paste_with_border(canvas, img_bgr)
        return self.predict_batch(canvas[None], [(h, w)])[0]


# the wrapper serves both detector families; the reference's name is the
# canonical one and this alias reads better where the family is chosen
PersonDetector = YOLOv5Detector
