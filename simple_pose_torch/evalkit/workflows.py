"""Evaluation workflows: the serving path and GT-box eval.

Port of simple_pose_tpu/evalkit/workflows.py:53-72, 146-316, 359-389.

  * PoseEvaluator   -> batched crop -> forward -> (flip-test) -> decode, on
                       one device; with ``fused_layer1`` layer1 runs as the
                       folded Bottleneck-chain kernel (ops/bottleneck_chain)
  * predicts_by_gt  -> eval.py:30-66: GT-box eval on the keypoints val set,
                       COCO AP through metrics/cocoeval
  * kps_to_dicts    -> COCO result dicts

Flip-test forwards the horizontally flipped crop, flips the heatmaps back,
swaps left/right channels, shifts them one pixel right (the SimpleBaselines
convention) and averages.  ``weights`` is a reference .pth checkpoint
(``['ema']`` if present) or an in-memory state_dict under the reference's
key names; none means the seeded init.

The detections and rescore workflows, decode_dark_original, quantization and
the multi-device mesh are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
from typing import Union

import numpy as np
import torch

from simple_pose_torch.data.coco import JOINT_PAIRS, load_coco_keypoints
from simple_pose_torch.data.pipeline import RGB_MEAN, PosePipeline
from simple_pose_torch.metrics.cocoeval import evaluate_map
from simple_pose_torch.models.registry import build_from_cfg, resolve_amp_dtype
from simple_pose_torch.ops.bottleneck_chain import fold_bottleneck_blocks, prepare_blocks
from simple_pose_torch.ops.decode import decode_basic, decode_gauss_taylor, instance_scores
from simple_pose_torch.ops.warp import affine_crop_separable
from simple_pose_torch.utils.device import resolve_device

__all__ = ["PoseEvaluator", "predicts_by_gt", "kps_to_dicts", "load_model_variables"]

_DECODERS = {"basic": decode_basic, "gauss_taylor": decode_gauss_taylor}


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


def load_model_variables(model_cfg: dict, weights: Union[str, dict, None] = None,
                         dtype=None, device="cpu"):
    """Build the eval model (init seeded with 0) and load ``weights``: a torch .pth
    (reference layout, ``['ema']`` key if present) or a state_dict.  Returns
    the module in eval mode on ``device``; its state_dict is the variables."""
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
        and run it through ops/bottleneck_chain (the CUDA kernel on a GPU)
    """

    def __init__(self, model_cfg: dict, weights: Union[str, dict, None] = None,
                 input_shape=(192, 256), decoder: str = "gauss_taylor",
                 flip_test: bool = False, amp="auto", fused_layer1: bool = False,
                 device=None):
        if decoder not in _DECODERS:
            raise NotImplementedError(
                f"decoder {decoder!r}: only {sorted(_DECODERS)} are ported "
                "(decode_dark_original: ROADMAP.md, 'Modules still to port')")
        self.device = resolve_device(device)
        self.crop_shape = (input_shape[1], input_shape[0])
        self.dtype = resolve_amp_dtype(amp, self.device)
        self.model = load_model_variables(model_cfg, weights, self.dtype, self.device)
        self.num_joints = model_cfg.get("num_joints", 17)
        self.flip_test = flip_test
        self._decode = _DECODERS[decoder]
        self._flip_perm = torch.tensor(_flip_perm(self.num_joints), device=self.device)
        self._mean = torch.as_tensor(RGB_MEAN, device=self.device)
        self._layer1_folded = None
        if fused_layer1:
            names = self.model.layer1_block_names()
            if not names:
                raise ValueError(
                    f"fused_layer1: {model_cfg.get('type')} {model_cfg.get('name')} has no "
                    "foldable Bottleneck layer1 (BasicBlock trunks and grouped convs "
                    "don't qualify)")
            self._layer1_folded = prepare_blocks(
                fold_bottleneck_blocks(list(self.model.layer1)),
                self.dtype or torch.float32)

    def _to_device(self, v):
        return torch.as_tensor(v).to(self.device, non_blocking=True)

    def _forward(self, x):
        return self.model(x, layer1_folded=self._layer1_folded).float()

    @torch.no_grad()
    def heatmaps(self, batch) -> torch.Tensor:
        """[B, J, h, w] f32 heatmaps (flip-test averaged when enabled)."""
        canvas = self._to_device(batch["canvas"])
        trans = self._to_device(batch["trans"])
        if "canvas_idx" in batch:  # dedup'd batch: one canvas per image
            canvas = canvas[self._to_device(batch["canvas_idx"]).long()]
        crops = affine_crop_separable(canvas, trans, self.crop_shape)
        x = (crops / 255.0 - self._mean).permute(0, 3, 1, 2).contiguous()
        heat = self._forward(x)
        if self.flip_test:
            hf = self._forward(x.flip(3))
            hf = hf[:, self._flip_perm].flip(3)
            # SimpleBaselines convention: shift flipped maps 1px right
            hf = torch.cat([hf[..., :1], hf[..., :-1]], dim=-1)
            heat = (heat + hf) * 0.5
        return heat

    @torch.no_grad()
    def __call__(self, batch) -> dict:
        """batch: {canvas u8 [U,S,S,3], trans [B,2,3], trans_inv [B,2,3],
        optional canvas_idx [B]} as numpy arrays or tensors.  Returns device
        tensors {kps [B,J,2], conf [B,J,1], scores [B]}."""
        heat = self.heatmaps(batch)
        kps, conf = self._decode(heat, self._to_device(batch["trans_inv"]))
        return {"kps": kps, "conf": conf, "scores": instance_scores(conf)}


def predicts_by_gt(img_root, ann_path, model_cfg, weights=None, batch_size=32,
                   input_shape=(192, 256), decoder="gauss_taylor", flip_test=False,
                   out_path="test_gt_kpt.json", canvas=640, debug=0, amp="auto",
                   fused_layer1=False, device=None):
    """GT-box eval (eval.py:30-66).  Returns the stats dict."""
    records = load_coco_keypoints(img_root, ann_path, debug=debug)
    # one canvas per image, batch_size // 2 canvas slots (the JAX package's
    # single-device plan, evalkit/workflows.py:319-332)
    pipe = PosePipeline(records, batch_size, input_shape=input_shape,
                        output_shape=(input_shape[0] // 4, input_shape[1] // 4),
                        canvas=canvas, augment=False, shuffle=False, drop_last=False,
                        dedup_canvases=max(1, batch_size // 2))
    ev = PoseEvaluator(model_cfg, weights, input_shape, decoder, flip_test, amp=amp,
                       fused_layer1=fused_layer1, device=device)
    results = []
    for batch in pipe.epoch(0):
        out = {k: v.cpu().numpy() for k, v in ev(batch).items()}
        keep = batch["valid"] > 0.5
        kps_to_dicts(out["kps"][keep], out["conf"][keep], out["scores"][keep],
                     batch["img_id"][keep], results)
    with open(out_path, "w") as wf:
        json.dump(results, wf)
    return evaluate_map(out_path, ann_path)
