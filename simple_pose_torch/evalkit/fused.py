"""Fused detect -> crop -> pose on one device, per image batch.

Port of simple_pose_tpu/evalkit/fused.py.  The reference chains two
processes through JSON files (eval.py:69-98, then 101-150); here one
batch of canvases goes through both networks without leaving the device:

  * the detect stage (:meth:`FusedDetectPose.detect`): device letterbox ->
    YOLOv5/YOLOv4 forward -> fixed-size NMS (the top ``max_people`` person
    boxes) -> boxes in source-canvas coordinates;
  * the pose stage (:meth:`FusedDetectPose.pose`): box -> affine geometry
    (ops/affine_device.boxes_to_crop_affines) -> P crops per image
    (affine_crop_separable_multi) -> BGR -> RGB, /255 - mean -> pose
    forward -> decode -> ``instance_scores``.

Both stages run as one ``nn.Module``, :class:`FusedProgram`, whose
submodules are the two networks: ``FusedDetectPose.__call__`` runs it, and
evalkit/export.export_fused traces the same module, so the live and the
exported program are one code path.

Ragged person counts stay fixed-size with validity masks throughout.  Under
amp both networks run in bf16 autocast and the crops are written in bf16;
the detector's head decodes in f32.  There is no flip-test and no
``fused_layer1`` here, as in the JAX program.  With ``quant='w8a8'`` both
networks' convs run in int8 (models/quant.py) on per-net scales
``{"detector": {...}, "pose": {...}}``; ``calibrate`` records them with one
recorder around each net, so the pose scales come from the crops of the
detector's own boxes.

Under an initialised torch.distributed group of more than one rank
``fused_eval`` takes this rank's stride of the images, padded with empty
canvases to the same batch count on every rank, and ``FusedDetectPose``
gathers every rank's outputs and image ids (JAX fused.py:230-268, 315-330),
so every rank builds the full prediction list; a ``rect`` batch takes the
largest bucket over the ranks, as the JAX program does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from simple_pose_torch.data.pipeline import RGB_MEAN, _native_loader
from simple_pose_torch.detector.nms import non_max_suppression
from simple_pose_torch.detector.wrapper import (
    YOLOv5Detector,
    _letterbox_trans,
    letterbox_input,
    image_batches,
    letterbox_params,
    rect_letterbox_params,
)
from simple_pose_torch.evalkit.workflows import (
    _write_json,
    calibrate_then_replay,
    load_model_variables,
    rescore_and_filter,
)
from simple_pose_torch.models.quant import ScaleRecorder, allreduce_scales_max, quantized
from simple_pose_torch.models.registry import resolve_amp_dtype
from simple_pose_torch.ops.affine import box_to_center_scale
from simple_pose_torch.ops.affine_device import affine_crop_separable_multi, boxes_to_crop_affines
from simple_pose_torch.ops.decode import decode_basic, decode_gauss_taylor, instance_scores
from simple_pose_torch.parallel import distributed as D
from simple_pose_torch.utils.device import resolve_device

__all__ = ["FusedDetectPose", "FusedProgram", "fused_eval"]


class FusedProgram(torch.nn.Module):
    """The fused device program of a :class:`FusedDetectPose`: letterbox ->
    detector -> NMS -> crops -> pose -> decode, under the program's quant
    contexts.  The detector and the pose network are submodules, so an
    export of this module bakes both networks' weights in.

    forward(canvases u8 [B,canvas,canvas,3], lb_trans f32 [B,2,3],
    lb_region f32 [B,4], lb_inv_scale f32 [B], lb_offset f32 [B,2], th, tw)
    -> {boxes, det_scores, det_valid, kps, kp_conf, pose_scores}; the
    detect stage runs at (th, tw), ``det_size`` when they are left out."""

    def __init__(self, fused):
        super().__init__()
        self.detector = fused.detector.model
        self.pose_model = fused.pose_model
        self._fused = fused

    def forward(self, canvases, lb_trans, lb_region, lb_inv_scale, lb_offset, th=None, tw=None):
        fused = self._fused
        if th is None:
            tw, th = fused.det_size
        det = fused.detect(canvases, lb_trans, lb_region, lb_inv_scale, lb_offset, th, tw)
        return {**det, **fused.pose(canvases, det["boxes"])}


class FusedDetectPose:
    """End-to-end person detection + pose estimation on one device.

    :param rect: minimum-rectangle letterboxing: the detect stage runs at
        the batch's largest mod-64 bucket instead of ``det_size`` (the
        reference's minimum_rectangle mode, yolov5_detector.py:151-160)
    :param device: None means CUDA (raises where no GPU is present)
    :param amp: 'auto' (bf16 on CUDA, f32 on the CPU), True or False
    :param quant: None or 'w8a8'; quant_scales: {"detector": {...},
        "pose": {...}} static scales (:meth:`calibrate`), either optional"""

    def __init__(self, pose_model_cfg: dict, pose_weights=None, detector_weights=None,
                 scale_name: str = "l", det_size=(640, 640), input_shape=(192, 256),
                 max_people: int = 16, det_conf: float = 0.25, det_iou: float = 0.5,
                 decoder: str = "gauss_taylor", canvas: int = 1280,
                 detector_family: str = "yolov5", amp="auto", rect: bool = False,
                 device=None, quant=None, quant_scales=None):
        self.device = resolve_device(device)
        self.canvas = canvas
        self.det_size = det_size
        self.input_shape = input_shape
        self.max_people = max_people
        self.det_conf = det_conf
        self.det_iou = det_iou
        self.rect = rect
        self.detector = YOLOv5Detector(
            weights_path=detector_weights, scale_name=scale_name, scale_size=det_size,
            conf_thresh=det_conf, iou_thresh=det_iou, canvas=canvas,
            model_family=detector_family, amp=amp, device=self.device)
        self.crop_shape = (input_shape[1], input_shape[0])
        dtype = resolve_amp_dtype(amp, self.device)
        self.pose_model = load_model_variables(pose_model_cfg, pose_weights, dtype, self.device)
        self._decode = decode_basic if decoder == "basic" else decode_gauss_taylor
        # the crops and the letterbox are written in the compute dtype
        self.lb_dtype = dtype or torch.float32
        self._mean = torch.as_tensor(RGB_MEAN).to(self.device, self.lb_dtype)
        self.quant = quant
        self._set_scales(quant_scales)
        self.program = FusedProgram(self)

    def _set_scales(self, quant_scales):
        self.quant_scales = quant_scales
        qs = quant_scales or {}
        self._contexts = {
            "detector": quantized(self.detector.model, self.quant, qs.get("detector")),
            "pose": quantized(self.pose_model, self.quant, qs.get("pose")),
        }

    def host_prep(self, shapes, run_size=None):
        """Per-image letterbox geometry: (lb_trans [B,2,3], lb_region [B,4],
        lb_inv_scale [B], lb_offset [B,2]) numpy f32.

        run_size: (w, h) the detect stage runs at (a rect bucket <=
        det_size); the scale is always against det_size, so only the
        centring offset follows the bucket."""
        b = len(shapes)
        tw, th = run_size or self.det_size
        lb_trans = np.zeros((b, 2, 3), np.float32)
        lb_region = np.zeros((b, 4), np.float32)
        lb_inv_scale = np.zeros((b,), np.float32)
        lb_offset = np.zeros((b, 2), np.float32)
        for i, (h, w) in enumerate(shapes):
            r, _, _, new_w, new_h = letterbox_params(h, w, self.det_size)
            left = int(round((tw - new_w) / 2 - 0.1))
            top = int(round((th - new_h) / 2 - 0.1))
            lb_trans[i] = _letterbox_trans(r, left, top)
            lb_region[i] = [left, top, left + new_w, top + new_h]
            lb_inv_scale[i] = 1.0 / r
            lb_offset[i] = [left, top]
        return lb_trans, lb_region, lb_inv_scale, lb_offset

    def _pick_bucket(self, shapes):
        """(th, tw) of a rect batch: the largest mod-64 bucket over it."""
        bw = bh = 0
        for h, w in shapes:
            (w_i, h_i), *_ = rect_letterbox_params(h, w, self.det_size)
            bw, bh = max(bw, w_i), max(bh, h_i)
        return bh, bw

    # ---- the detect stage, in its three steps
    def letterbox(self, canvases, lb_trans, lb_region, th, tw):
        return letterbox_input(canvases, lb_trans, lb_region, th, tw, self.lb_dtype)

    def nms(self, pred):
        return non_max_suppression(pred, conf_thresh=self.det_conf, iou_thresh=self.det_iou,
                                   max_det=self.max_people, multi_label=True, merge=True)

    @torch.no_grad()
    def detect(self, canvases, lb_trans, lb_region, lb_inv_scale, lb_offset, th, tw) -> dict:
        """Device tensors -> {boxes [B,P,4] xyxy in canvas pixels,
        det_scores [B,P], det_valid [B,P] bool}."""
        x = self.letterbox(canvases, lb_trans, lb_region, th, tw)
        with self._contexts["detector"]:
            pred = self.detector.model(x)
        dets, valid = self.nms(pred)
        limit = torch.tensor([tw, th, tw, th], dtype=torch.float32, device=dets.device)
        boxes = torch.minimum(dets[..., :4].clamp(min=0.0), limit)
        boxes = (boxes - lb_offset.repeat(1, 2)[:, None, :]) * lb_inv_scale[:, None, None]
        return {"boxes": boxes, "det_scores": dets[..., 4], "det_valid": valid}

    # ---- the pose stage, in its three steps
    def crops(self, canvases, boxes):
        """-> (network input [B*P, 3, h, w], trans_inv [B*P, 2, 3])."""
        in_w, in_h = self.input_shape
        trans, trans_inv = boxes_to_crop_affines(boxes, self.input_shape, (in_w // 4, in_h // 4))
        crops = affine_crop_separable_multi(canvases, trans, self.crop_shape,
                                            out_dtype=self.lb_dtype)  # [B, P, h, w, C]
        b, p = crops.shape[:2]
        # canvases are BGR (cv2.imread); the pose net eats RGB, mean-subtracted
        x = crops.reshape((b * p,) + self.crop_shape + (3,)).flip(-1) / 255.0 - self._mean
        return x.permute(0, 3, 1, 2), trans_inv.reshape(b * p, 2, 3)

    def pose_forward(self, x):
        with self._contexts["pose"]:
            return self.pose_model(x).float()

    @torch.no_grad()
    def pose(self, canvases, boxes) -> dict:
        """Device tensors -> {kps [B,P,J,2], kp_conf [B,P,J,1],
        pose_scores [B,P]} for the boxes [B,P,4] in canvas pixels."""
        b, p = boxes.shape[:2]
        x, trans_inv = self.crops(canvases, boxes)
        kps, conf = self._decode(self.pose_forward(x), trans_inv)
        pp = lambda a: a.reshape((b, p) + a.shape[1:])  # noqa: E731
        return {"kps": pp(kps), "kp_conf": pp(conf), "pose_scores": pp(instance_scores(conf))}

    def prepare(self, canvases_u8, shapes):
        """Host geometry and device tensors for one batch:
        (canvases, lb_trans, lb_region, lb_inv_scale, lb_offset, th, tw)."""
        if self.rect:
            th, tw = (int(v) for v in D.allreduce_max(self._pick_bucket(shapes)))
            geom = self.host_prep(shapes, run_size=(tw, th))
        else:
            tw, th = self.det_size
            geom = self.host_prep(shapes)
        if not torch.is_tensor(canvases_u8):
            canvases_u8 = torch.from_numpy(np.ascontiguousarray(canvases_u8))
        return (canvases_u8.to(self.device),
                *(torch.from_numpy(a).to(self.device) for a in geom), th, tw)

    @torch.no_grad()
    def calibrate(self, batches, num_batches: int = 2) -> dict:
        """Record static w8a8 scales for both nets on the first
        ``num_batches`` of ``batches`` ((canvases_u8, shapes) pairs, as
        :meth:`__call__` takes): the program runs with float forwards and a
        recorder around each net, so the pose scales come from the crops of
        the detector's own boxes (JAX fused.py:155-190); then it runs with
        them.  Max-reduced over the ranks of an initialised
        torch.distributed group.  Returns {"detector": {...}, "pose": {...}}."""
        if self.quant is None:
            raise ValueError("calibrate() requires a quant mode (quant='w8a8')")
        recs = {"detector": ScaleRecorder(self.detector.model),
                "pose": ScaleRecorder(self.pose_model)}
        self._contexts, n = recs, 0
        try:
            for canvases_u8, shapes in batches:
                if n >= num_batches:
                    break
                self.program(*self.prepare(canvases_u8, shapes))
                n += 1
        finally:
            self._set_scales(self.quant_scales)
        if n == 0:
            raise ValueError("calibrate() got an empty batch stream")
        self._set_scales({net: allreduce_scales_max(rec.scales())
                          for net, rec in recs.items()})
        return self.quant_scales

    def __call__(self, canvases_u8, shapes, img_ids=None) -> dict:
        """:param canvases_u8: [B, canvas, canvas, 3] uint8 BGR at the origin
        :param shapes: [(h, w)] true image sizes
        :param img_ids: optional per-image ids, returned as ``img_ids``
        :returns: dict of numpy arrays, every rank's under a group; entries
            masked by det_valid"""
        out = self.program(*self.prepare(canvases_u8, shapes))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if img_ids is not None:
            out["img_ids"] = np.asarray(img_ids, np.int64)
        return D.allgather_tiled(out)


def fused_eval(img_root, ann_path, pose_model_cfg, pose_weights=None,
               detector_weights=None, scale_name="l", det_conf=0.25,
               det_iou=0.5, batch_size=8, input_shape=(192, 256),
               max_people: int = 16, canvas: int = 1280, det_size=(640, 640),
               decoder: str = "gauss_taylor", detector_family: str = "yolov5",
               amp="auto", rect: bool = False, in_vis_thre: float = 0.2,
               oks_thre: float = 0.9, debug: int = 0,
               out_path: str = "fused_kps_temp.json",
               filtered_out_path: str = "fused_filter_kps_predicts.json", fused=None,
               device=None, use_native=None, quant=None, quant_calib: int = 0,
               quant_scales=None, quant_scales_out=None):
    """End-to-end AP eval through :class:`FusedDetectPose`, then the host
    rescoring chain (temp_read_in_and_filter parity, eval.py:153-197).

    Batches have a fixed size; the last is padded with empty canvases of id
    -1.  Per-instance area and score follow the detector-box convention
    (naive_data.py:33-56): area = padded-scale product, score = detector box
    score.  The raw predictions go to ``out_path`` and the rescored ones to
    ``filtered_out_path``.  JPEGs decode through the native loader (see
    data/pipeline's ``use_native``).

    quant_calib: with quant='w8a8', calibrate per-net scales on the first N
    batches (FusedDetectPose.calibrate), then run them again with those
    scales; the {"detector", "pose"} dict goes to ``quant_scales_out`` as
    JSON and comes back through ``quant_scales``.  Returns the stats dict."""
    if fused is None:
        fused = FusedDetectPose(
            pose_model_cfg, pose_weights, detector_weights, scale_name=scale_name,
            det_size=det_size, input_shape=input_shape, max_people=max_people,
            det_conf=det_conf, det_iou=det_iou, decoder=decoder, canvas=canvas,
            detector_family=detector_family, amp=amp, rect=rect, device=device, quant=quant,
            quant_scales=quant_scales)
    with open(ann_path) as rf:
        images = json.load(rf)["images"]
    if debug:
        images = images[:debug]
    rank, world = D.rank_world()
    if world > 1:  # this rank's stride, padded to the same count on every rank
        per_rank = -(-len(images) // world)
        images = list(images[rank::world])
        images += [None] * (per_rank - len(images))
    loader = _native_loader(use_native, 8)

    in_w, in_h = input_shape
    predictions = []
    stream = image_batches(img_root, images, batch_size, canvas, loader)
    if quant_calib and fused.quant:
        stream = calibrate_then_replay(fused, stream, quant_calib, quant_scales_out)
    for chunk, canvases, shapes in stream:
        ids = [-1 if e is None else int(e["id"]) for e in chunk] + [-1] * (batch_size - len(chunk))
        out = fused(canvases, shapes, img_ids=ids)
        for i, img_id in enumerate(out["img_ids"]):
            if img_id < 0:
                continue
            for p in range(max_people):
                if not out["det_valid"][i, p]:
                    continue
                x1, y1, x2, y2 = out["boxes"][i, p]
                _, scale = box_to_center_scale(float(x1), float(y1), float(x2 - x1),
                                               float(y2 - y1), in_w / in_h)
                kc = np.concatenate([out["kps"][i, p], out["kp_conf"][i, p]], axis=-1)
                predictions.append({
                    "kps": kc.reshape(-1).tolist(),
                    "area": float(scale[0] * scale[1]),
                    "score": float(out["det_scores"][i, p]),
                    "img_id": int(img_id),
                })
    _write_json(out_path, predictions)
    return rescore_and_filter(predictions, ann_path, in_vis_thre, oks_thre, filtered_out_path)
