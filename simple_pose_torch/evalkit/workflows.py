"""Evaluation workflows: the serving path, GT-box and detector-box eval.

Port of simple_pose_tpu/evalkit/workflows.py:53-72, 146-474.

  * PoseEvaluator          -> batched crop -> forward -> (flip-test) ->
                              decode, on one device; with ``fused_layer1``
                              layer1 runs as the folded Bottleneck-chain
                              kernel (ops/bottleneck_chain); decoder
                              'dark_original' decodes on the host; with
                              ``quant='w8a8'`` the convs run in int8
                              (models/quant.py), ``calibrate`` records
                              static activation scales
  * predicts_by_gt         -> eval.py:30-66: GT-box eval on the keypoints
                              val set, COCO AP through metrics/cocoeval
  * predicts_by_detections -> eval.py:101-150: eval on a person-detection
                              JSON, then rescore_and_filter
  * rescore_and_filter     -> eval.py:153-197: per-image rescoring
                              (box score * mean(kp conf > 0.2)) + OKS-NMS
                              at 0.9, then COCO AP
  * kps_to_dicts           -> COCO result dicts
  * gen_detections         -> eval.py:69-98: the person detector over the
                              val images, written as COCO detection results
  * detect_then_pose       -> gen_detections chained into
                              predicts_by_detections (README.md:94-106)

Flip-test forwards the horizontally flipped crop, flips the heatmaps back,
swaps left/right channels, shifts them one pixel right (the SimpleBaselines
convention) and averages.  ``weights`` is a reference .pth checkpoint
(``['ema']`` if present) or an in-memory state_dict under the reference's
key names; none means the seeded init.

The fused detect -> pose program is evalkit/fused.py; the serving export
of PoseEvaluator is evalkit/export.py.

Under an initialised torch.distributed group of more than one rank
(parallel/distributed.py, the JAX ``mesh=`` with several processes) the
GT-box and detector-box workflows take this rank's stride of the records
(``_process_shard_kwargs``), gather every rank's outputs per batch
(``_gather_results``), so every rank builds the full prediction list and
returns the same stats, and rank 0 alone writes each output file before
any rank reads it.  As in JAX, ``fused_layer1`` and ``gen_detections`` run
on one rank only.
"""

from __future__ import annotations

import itertools
import json
import os
from collections import defaultdict
from typing import Union

import numpy as np
import torch

from simple_pose_torch.data.coco import JOINT_PAIRS, load_coco_keypoints, load_detection_boxes
from simple_pose_torch.data.pipeline import RGB_MEAN, DetBoxPipeline, PosePipeline, _native_loader
from simple_pose_torch.metrics.cocoeval import evaluate_map
from simple_pose_torch.models.quant import (
    ScaleRecorder,
    allreduce_scales_max,
    quantized,
    save_scales,
)
from simple_pose_torch.models.registry import build_from_cfg, resolve_amp_dtype
from simple_pose_torch.ops.bottleneck_chain import fold_bottleneck_blocks, prepare_blocks
from simple_pose_torch.ops.decode import (
    decode_basic,
    decode_dark_original,
    decode_gauss_taylor,
    instance_scores,
)
from simple_pose_torch.ops.oks import oks_nms
from simple_pose_torch.ops.warp import affine_crop_separable
from simple_pose_torch.parallel import distributed as D
from simple_pose_torch.utils import tracing
from simple_pose_torch.utils.device import resolve_device

__all__ = ["PoseEvaluator", "predicts_by_gt", "predicts_by_detections", "rescore_and_filter",
           "kps_to_dicts", "load_model_variables", "gen_detections", "detect_then_pose"]

_DECODERS = {"basic": decode_basic, "gauss_taylor": decode_gauss_taylor,
             "dark_original": None}  # None: decoded on the host


def _flip_perm(num_joints: int):
    perm = list(range(num_joints))
    for a, b in JOINT_PAIRS:
        if a < num_joints and b < num_joints:
            perm[a], perm[b] = perm[b], perm[a]
    return tuple(perm)


def kps_to_dicts(kps, conf, scores, img_ids, out_list):
    """COCO result dicts; score = mean(conf) + max(conf)
    (kps_to_dict_ parity, pose_metrics.py:172-179)."""
    for kp, cf, sc, img_id in zip(kps, conf, scores, img_ids):
        out_list.append(
            {
                "image_id": int(img_id),
                "score": float(sc),
                "category_id": 1,
                "keypoints": np.concatenate([kp, cf], axis=-1).reshape(-1).tolist(),
            }
        )


def _gather_results(out: dict, meta: dict) -> dict:
    """One numpy dict of evaluator outputs and host metadata for the global
    batch: every rank's, concatenated in rank order (JAX workflows.py:75-95);
    this rank's alone without a group."""
    host = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in out.items()}
    return D.allgather_tiled({**host, **{k: np.asarray(v) for k, v in meta.items()}})


def _process_shard_kwargs() -> dict:
    """Pipeline kwargs for this rank's stride of the records (JAX
    workflows.py:98-103)."""
    return D.shard_kwargs()


def _write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, written once: by rank 0 under a group."""
    def write(p):
        with open(p, "w") as wf:
            json.dump(obj, wf)

    D.write_once(path, write)


def load_model_variables(model_cfg: dict, weights: Union[str, dict, None] = None,
                         dtype=None, device=None):
    """Build the eval model (init seeded with 0) and load ``weights``: a torch .pth
    (reference layout, ``['ema']`` key if present) or a state_dict.  Returns
    the module in eval mode on ``device`` (None means CUDA, which raises
    where no GPU is present); its state_dict is the variables."""
    device = resolve_device(device)
    model = build_from_cfg(model_cfg, dtype=dtype)
    if weights is not None:
        if isinstance(weights, str):
            raw = torch.load(weights, map_location="cpu", weights_only=False)
            if isinstance(raw, dict) and "ema" in raw:
                raw = raw["ema"]
        else:
            raw = weights
        raw = {(k[len("module."):] if k.startswith("module.") else k): v
               for k, v in raw.items()}
        missing, unexpected = model.load_state_dict(raw, strict=False)
        if missing or unexpected:
            print(f"load: {len(missing)} missing, {len(unexpected)} unexpected")
    return model.to(device).eval()


class PoseEvaluator:
    """Batched crop -> forward -> (flip-test) -> decode on one device.

    :param device: None means CUDA (raises where no GPU is present);
        pass "cpu" explicitly to run on the CPU
    :param amp: 'auto' (bf16 on CUDA, f32 on the CPU), True or False
    :param fused_layer1: fold eval-mode BN into layer1's Bottleneck chain
        and run it through ops/bottleneck_chain (the CUDA kernel on a GPU);
        with ``quant='w8a8'`` the folded layer1 stays in the compute dtype
    :param decoder: 'basic' or 'gauss_taylor' on the device, or
        'dark_original': the heatmaps come to the host and
        ops/decode.decode_dark_original decodes them in numpy
    :param quant: None or 'w8a8' (models/quant.py)
    :param quant_scales: static {flax module path: s_x} activation scales
        (:meth:`calibrate`, models/quant.load_scales); convs without one
        use the dynamic per-batch scale
    """

    def __init__(self, model_cfg: dict, weights: Union[str, dict, None] = None,
                 input_shape=(192, 256), decoder: str = "gauss_taylor",
                 flip_test: bool = False, amp="auto", fused_layer1: bool = False,
                 device=None, quant=None, quant_scales=None):
        if decoder not in _DECODERS:
            raise ValueError(f"decoder {decoder!r}; expected one of {sorted(_DECODERS)}")
        self.device = resolve_device(device)
        self.crop_shape = (input_shape[1], input_shape[0])
        self.dtype = resolve_amp_dtype(amp, self.device)
        self.model = load_model_variables(model_cfg, weights, self.dtype, self.device)
        self.num_joints = model_cfg.get("num_joints", 17)
        self.flip_test = flip_test
        self._decode = _DECODERS[decoder]
        self._flip_perm = torch.tensor(_flip_perm(self.num_joints), device=self.device)
        self._mean = torch.as_tensor(RGB_MEAN, device=self.device)
        self.quant = quant
        self.quant_scales = quant_scales
        self._quant = quantized(self.model, quant, quant_scales)
        self._layer1_folded = None
        self._calls = 0
        if fused_layer1:
            if D.rank_world()[1] > 1:
                raise ValueError(
                    "fused_layer1 runs on one rank, as the JAX package's runs on one "
                    "device (no mesh); drop fused_layer1 or run a single process")
            names = self.model.layer1_block_names()
            if not names:
                raise ValueError(
                    f"fused_layer1: {model_cfg.get('type')} {model_cfg.get('name')} has no "
                    "foldable Bottleneck layer1 (BasicBlock trunks and grouped convs "
                    "don't qualify)")
            self._layer1_folded = prepare_blocks(
                fold_bottleneck_blocks([self.model.get_submodule(n) for n in names]),
                self.dtype or torch.float32)

    def _to_device(self, v):
        t = torch.as_tensor(v)
        if (tracing.enabled() and t.device.type == "cpu" and self.device.type != "cpu"
                and not t.is_pinned()):
            tracing.add("pageable_bytes", t.nbytes)
        return t.to(self.device, non_blocking=True)

    def _forward(self, x, params=None):
        """The pose net (quantized when set) -> f32 heatmaps; ``params``:
        a state dict to run in place of the model's own
        (``torch.func.functional_call``, the external-weights export)."""
        with self._quant:
            if params is None:
                y = self.model(x, layer1_folded=self._layer1_folded)
            else:
                y = torch.func.functional_call(self.model, params, (x,),
                                               {"layer1_folded": self._layer1_folded})
        return y.float()

    def _inputs(self, canvas, trans, canvas_idx=None):
        """Device canvases and affines -> the network input [B, 3, h, w]."""
        if canvas_idx is not None:  # dedup'd batch: one canvas per image
            canvas = canvas[canvas_idx.long()]
        crops = affine_crop_separable(canvas, trans, self.crop_shape)
        return (crops / 255.0 - self._mean).permute(0, 3, 1, 2).contiguous()

    def _heatmaps(self, canvas, trans, canvas_idx=None, params=None):
        x = self._inputs(canvas, trans, canvas_idx)
        heat = self._forward(x, params)
        if self.flip_test:
            hf = self._forward(x.flip(3), params)
            hf = hf[:, self._flip_perm].flip(3)
            # SimpleBaselines convention: shift flipped maps 1px right
            hf = torch.cat([hf[..., :1], hf[..., :-1]], dim=-1)
            heat = (heat + hf) * 0.5
        return heat

    @torch.no_grad()
    def step(self, canvas, trans, trans_inv, canvas_idx=None, params=None) -> dict:
        """The device program on device tensors: {kps [B,J,2], conf [B,J,1],
        scores [B]}, or {heat [B,J,h,w]} for 'dark_original' (decoded on the
        host by __call__).  evalkit/export.py exports this."""
        heat = self._heatmaps(canvas, trans, canvas_idx, params)
        if self._decode is None:
            return {"heat": heat}
        kps, conf = self._decode(heat, trans_inv)
        return {"kps": kps, "conf": conf, "scores": instance_scores(conf)}

    def _batch_tensors(self, batch):
        idx = batch.get("canvas_idx")
        return (self._to_device(batch["canvas"]), self._to_device(batch["trans"]),
                None if idx is None else self._to_device(idx))

    @torch.no_grad()
    def heatmaps(self, batch) -> torch.Tensor:
        """[B, J, h, w] f32 heatmaps (flip-test averaged when enabled)."""
        return self._heatmaps(*self._batch_tensors(batch))

    @torch.no_grad()
    def calibrate(self, batches, num_batches: int = 2) -> dict:
        """Record static w8a8 activation scales on the first ``num_batches``
        of ``batches`` (pipeline batches, e.g. ``pipe.epoch(0)``) with the
        float forward (layer1 unfolded, the flipped input too under
        flip-test), then run with them (JAX workflows.py:260-293).  Under an
        initialised torch.distributed group the scales are max-reduced over
        the ranks.  Returns the {flax module path: s_x} dict
        (models/quant.save_scales)."""
        if self.quant is None:
            raise ValueError("calibrate() requires a quant mode (quant='w8a8')")
        rec, n = ScaleRecorder(self.model), 0
        with rec:
            for batch in batches:
                if n >= num_batches:
                    break
                x = self._inputs(*self._batch_tensors(batch))
                self.model(x)
                if self.flip_test:  # the flipped forward quantizes too
                    self.model(x.flip(3))
                n += 1
        if n == 0:
            raise ValueError("calibrate() got an empty batch stream")
        self.quant_scales = allreduce_scales_max(rec.scales())
        self._quant = quantized(self.model, self.quant, self.quant_scales)
        return self.quant_scales

    @torch.no_grad()
    def __call__(self, batch) -> dict:
        """batch: {canvas u8 [U,S,S,3], trans [B,2,3], trans_inv [B,2,3],
        optional canvas_idx [B]} as numpy arrays or tensors.  Returns device
        tensors {kps [B,J,2], conf [B,J,1], scores [B]}.

        Traced (utils/tracing): ``serve.call`` (id: the call's number) holds
        ``serve.h2d``, the batch's copies to the device with the bytes that
        came from pageable host memory (``pageable_bytes``), then
        ``serve.device``, the launches of the device program."""
        self._calls += 1
        with tracing.span("serve.call", id=self._calls):
            dark = self._decode is None
            with tracing.span("serve.h2d"):
                canvas, trans, idx = self._batch_tensors(batch)
                trans_inv = None if dark else self._to_device(batch["trans_inv"])
            with tracing.span("serve.device"):
                if not dark:
                    return self.step(canvas, trans, trans_inv, idx)
                # dark_original, on the host (JAX workflows.py:302-316)
                heat = self._heatmaps(canvas, trans, idx)
                trans_inv = torch.as_tensor(batch["trans_inv"]).cpu().numpy()
                kps, conf = decode_dark_original(heat.cpu().numpy(), trans_inv)
                scores = conf[..., 0].mean(-1) + conf[..., 0].max(-1)
                return {"kps": torch.from_numpy(kps), "conf": torch.from_numpy(conf),
                        "scores": torch.from_numpy(scores)}


def _dedup_plan(batch_size: int, dedup: bool) -> dict:
    """One canvas per image, batch_size // 2 canvas slots in one bucket: the
    JAX package's single-device plan (evalkit/workflows.py:319-332)."""
    return {"dedup_canvases": max(1, batch_size // 2)} if dedup else {}


def _maybe_calibrate(ev: PoseEvaluator, pipe, quant_calib: int, quant_scales_out) -> None:
    """Workflow-level static-scale calibration: the evaluator's recorder over
    the first ``quant_calib`` batches of a fresh (unshuffled) epoch, the
    scales then written to ``quant_scales_out`` where given."""
    if not quant_calib:
        return
    ev.calibrate(pipe.epoch(0), quant_calib)
    if quant_scales_out:
        save_scales(ev.quant_scales, quant_scales_out)


def calibrate_then_replay(target, stream, num_batches: int, scales_out=None):
    """Calibrate ``target`` (a detector or FusedDetectPose: anything with
    ``calibrate(batches, n)`` and ``quant_scales``) on the first
    ``num_batches`` (chunk, canvases, shapes) batches of ``stream``, write
    its scales to ``scales_out`` where given, and return the stream with
    those batches in front again, so they are run on the new scales (JAX
    workflows.py:535-543)."""
    head = list(itertools.islice(stream, num_batches))
    target.calibrate(((c, s) for _, c, s in head), num_batches)
    if scales_out:
        save_scales(target.quant_scales, scales_out)
    return itertools.chain(head, stream)


def predicts_by_gt(img_root, ann_path, model_cfg, weights=None, batch_size=32,
                   input_shape=(192, 256), decoder="gauss_taylor", flip_test=False,
                   out_path="test_gt_kpt.json", canvas=640, debug=0, dedup=True, amp="auto",
                   fused_layer1=False, device=None, quant=None, quant_calib=0,
                   quant_scales=None, quant_scales_out=None):
    """GT-box eval (eval.py:30-66).  Returns the stats dict.

    quant_calib: calibrate static w8a8 scales on the first N batches before
    the eval loop (PoseEvaluator.calibrate); quant_scales feeds precomputed
    scales; quant_scales_out writes the calibrated ones."""
    records = load_coco_keypoints(img_root, ann_path, debug=debug)
    pipe = PosePipeline(records, batch_size, input_shape=input_shape,
                        output_shape=(input_shape[0] // 4, input_shape[1] // 4),
                        canvas=canvas, augment=False, shuffle=False, drop_last=False,
                        **_process_shard_kwargs(), **_dedup_plan(batch_size, dedup))
    ev = PoseEvaluator(model_cfg, weights, input_shape, decoder, flip_test, amp=amp,
                       fused_layer1=fused_layer1, device=device, quant=quant,
                       quant_scales=quant_scales)
    _maybe_calibrate(ev, pipe, quant_calib, quant_scales_out)
    results = []
    for batch in pipe.epoch(0):
        g = _gather_results(ev(batch), {"img_id": batch["img_id"], "valid": batch["valid"]})
        keep = g["valid"] > 0.5
        kps_to_dicts(g["kps"][keep], g["conf"][keep], g["scores"][keep], g["img_id"][keep],
                     results)
    _write_json(out_path, results)
    return evaluate_map(out_path, ann_path)


def predicts_by_detections(img_root, det_json_path, gt_ann_path, model_cfg, weights=None,
                           batch_size=32, input_shape=(192, 256), decoder="gauss_taylor",
                           flip_test=False, out_path="predicts_kps_temp.json", canvas=640,
                           in_vis_thre=0.2, oks_thre=0.9, debug=0, dedup=True, amp="auto",
                           fused_layer1=False, device=None,
                           filtered_out_path="filter_kps_predicts.json", use_native=None,
                           quant=None, quant_calib=0, quant_scales=None,
                           quant_scales_out=None, img_ext=".jpg"):
    """Detector-box eval + OKS-NMS rescoring (eval.py:101-150 + 153-197).

    Writes the raw predictions to ``out_path`` and the rescored, filtered
    ones to ``filtered_out_path``.  ``use_native`` as for data/pipeline;
    the ``quant*`` arguments as for predicts_by_gt; ``img_ext`` as for
    data/coco.load_detection_boxes.  Returns the stats dict of the
    latter."""
    records = load_detection_boxes(img_root, det_json_path, debug=debug, img_ext=img_ext)
    pipe = DetBoxPipeline(records, batch_size, input_shape=input_shape,
                          output_shape=(input_shape[0] // 4, input_shape[1] // 4),
                          canvas=canvas, use_native=use_native, **_process_shard_kwargs(),
                          **_dedup_plan(batch_size, dedup))
    ev = PoseEvaluator(model_cfg, weights, input_shape, decoder, flip_test, amp=amp,
                       fused_layer1=fused_layer1, device=device, quant=quant,
                       quant_scales=quant_scales)
    _maybe_calibrate(ev, pipe, quant_calib, quant_scales_out)
    predictions = []
    for batch in pipe.epoch(0):
        out = ev(batch)
        g = _gather_results({"kps": out["kps"], "conf": out["conf"]},
                            {k: batch[k] for k in ("img_id", "valid", "area", "score")})
        for b in np.flatnonzero(g["valid"] > 0.5):
            predictions.append({
                "kps": np.concatenate([g["kps"][b], g["conf"][b]], -1).reshape(-1).tolist(),
                "area": float(g["area"][b]),
                "score": float(g["score"][b]),
                "img_id": int(g["img_id"][b]),
            })
    _write_json(out_path, predictions)
    return rescore_and_filter(predictions, gt_ann_path, in_vis_thre, oks_thre,
                              filtered_out_path)


def rescore_and_filter(predictions, gt_ann_path, in_vis_thre=0.2, oks_thre=0.9,
                       out_path="filter_kps_predicts.json"):
    """Per-image rescoring + greedy OKS-NMS (temp_read_in_and_filter parity,
    eval.py:153-197): each pose scores box score x the mean of its joint
    confidences above ``in_vis_thre``, then OKS-NMS at ``oks_thre``.
    ``predictions`` is a path or the list itself.  Writes the kept poses as
    COCO results to ``out_path`` (rank 0 under a group) and returns their
    stats dict."""
    if isinstance(predictions, str):
        with open(predictions) as rf:
            predictions = json.load(rf)
    by_img = defaultdict(list)
    for p in predictions:
        by_img[p["img_id"]].append(p)

    filtered = []
    for img_id, img_kpts in by_img.items():
        kpts_list, score_list, area_list = [], [], []
        for n_p in img_kpts:
            kpt_item = np.array(n_p["kps"]).reshape(-1, 3)
            kpt_scores = kpt_item[:, -1]
            valid = kpt_scores > in_vis_thre
            kpt_score = kpt_scores[valid].mean() if valid.sum() > 0 else 0.0
            kpts_list.append(kpt_item)
            score_list.append(n_p["score"] * kpt_score)
            area_list.append(n_p["area"])
        kpts_arr = np.stack(kpts_list, axis=0)
        scores = np.array(score_list)
        areas = np.array(area_list)
        keep = oks_nms(kpts_arr, scores, areas, oks_thre)
        if len(keep) != 0:
            kpts_arr = kpts_arr[keep]
            scores = scores[keep]
        for kpt, sc in zip(kpts_arr, scores):
            filtered.append({
                "image_id": int(img_id),
                "score": float(sc),
                "category_id": 1,
                "keypoints": kpt.reshape(-1).tolist(),
            })
    _write_json(out_path, filtered)
    return evaluate_map(out_path, gt_ann_path)


def gen_detections(img_root, ann_path, detector=None, out_path="person_detections.json",
                   batch_size=8, conf_thresh=0.25, iou_thresh=0.5, canvas=1280,
                   weights_path=None, scale_name="l", debug=0, detector_family="yolov5",
                   amp="auto", device=None, use_native=None, quant_calib=0,
                   quant_scales_out=None):
    """Run the person detector over the val images and write COCO detection
    results (gen_data_by_detector parity, eval.py:69-98, in the standard
    schema, so the output feeds predicts_by_detections).

    ``detector`` is a detector/wrapper.YOLOv5Detector; without one it is
    built from the other arguments.  Batches have a fixed size; the last is
    padded with empty canvases.  JPEGs decode through the native loader
    (see data/pipeline's ``use_native``).

    quant_calib: with a quant='w8a8' detector, calibrate static activation
    scales on the first N batches (YOLOv5Detector.calibrate), then detect
    on them again with those scales (JAX workflows.py:535-543);
    quant_scales_out writes the scales.  Returns the result list."""
    from simple_pose_torch.detector.wrapper import YOLOv5Detector, image_batches

    if D.rank_world()[1] > 1:  # as JAX workflows.py:498-505 refuses a multi-host mesh
        raise NotImplementedError(
            "gen_detections runs on one rank; run it in a single process (its output "
            "json then feeds predicts_by_detections on several ranks)")
    if detector is None:
        detector = YOLOv5Detector(weights_path=weights_path, scale_name=scale_name,
                                  conf_thresh=conf_thresh, iou_thresh=iou_thresh, canvas=canvas,
                                  model_family=detector_family, amp=amp, device=device)
    with open(ann_path) as rf:
        images = json.load(rf)["images"]
    if debug:
        images = images[:debug]
    loader = _native_loader(use_native, 8)
    stream = image_batches(img_root, images, batch_size, canvas, loader)
    if quant_calib and detector.quant:
        stream = calibrate_then_replay(detector, stream, quant_calib, quant_scales_out)
    results = []
    for chunk, canvases, shapes in stream:
        for entry, boxes in zip(chunk, detector.predict_batch(canvases, shapes)):
            for x1, y1, x2, y2, score, _cls in boxes:
                results.append({
                    "image_id": entry["id"], "category_id": 1,
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(score),
                })
    with open(out_path, "w") as wf:
        json.dump(results, wf)
    return results


def detect_then_pose(img_root, ann_path, pose_model_cfg, pose_weights=None,
                     detector_weights=None, scale_name="l", det_conf=0.25, det_iou=0.5,
                     batch_size=32, input_shape=(192, 256), flip_test=False, work_dir=".",
                     debug=0, detector_family="yolov5", amp="auto", fused_layer1=False,
                     decoder="gauss_taylor", device=None, use_native=None, quant=None,
                     quant_calib=0, quant_scales=None, quant_scales_out=None):
    """End-to-end detect -> crop -> pose -> rescoring AP (README.md:94-106):
    gen_detections into ``work_dir``/person_detections.json, then
    predicts_by_detections on it, with ``flip_test``, ``fused_layer1`` and
    the ``quant*`` arguments passed through (the pose net's, as in JAX: the
    detector stays float here).  Returns the stats dict."""
    det_path = os.path.join(work_dir, "person_detections.json")
    gen_detections(img_root, ann_path, out_path=det_path, conf_thresh=det_conf,
                   iou_thresh=det_iou, weights_path=detector_weights, scale_name=scale_name,
                   debug=debug, detector_family=detector_family, amp=amp, device=device,
                   use_native=use_native)
    return predicts_by_detections(
        img_root, det_path, ann_path, pose_model_cfg, weights=pose_weights,
        batch_size=batch_size, input_shape=input_shape, decoder=decoder, flip_test=flip_test,
        out_path=os.path.join(work_dir, "predicts_kps_temp.json"), amp=amp,
        fused_layer1=fused_layer1, device=device, use_native=use_native,
        filtered_out_path=os.path.join(work_dir, "filter_kps_predicts.json"), quant=quant,
        quant_calib=quant_calib, quant_scales=quant_scales, quant_scales_out=quant_scales_out)
