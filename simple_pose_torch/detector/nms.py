"""Fixed-size batched NMS in plain torch.

Port of simple_pose_tpu/detector/nms.py (itself the replacement of
torchvision.ops.nms and the reference's detector/yolov5_detector.py:52-126;
neither machine has torchvision).  Same semantics: the obj-conf candidate
filter, conf = obj * cls, multi-label expansion, class-offset batched NMS,
the top ``pre_nms`` (box, class) pairs, greedy suppression over their IoU
matrix, optional merge-NMS weighted box fusion with the redundancy rule,
and outputs padded to [B, max_det, 6] (x1, y1, x2, y2, conf, cls) with a
validity mask.

Ties: ``jax.lax.top_k`` puts the lower index first among equal values and
``torch.topk`` promises no order, so both selections are a stable
descending sort, then a slice.  Equal scores are common (the head's logits
are bf16 under amp), and their order decides which box suppresses which.

The greedy suppression keeps candidate ``i`` iff it is valid and no kept
candidate ``j < i`` overlaps it.  Instead of ``pre_nms`` sequential steps
(three launches each), it iterates that rule for all candidates of all
images at once, keep = valid & ~(keep @ suppresses), from keep = valid
until nothing changes.  Entry ``i`` depends only on entries before it, so
after ``t`` rounds the first ``t`` entries are final: the fixed point is
the greedy result, reached in at most ``pre_nms`` rounds (one product
each): 31 on a seeded bf16 YOLOv5-l's 512 candidates per image of eight
fixture JPEGs (scripts/time_torch_nms.py on an H100).  The loop is
``torch.ops.higher_order.while_loop`` over (keep, previous keep), so the
round count follows the data both live and in a ``torch.export`` program
(evalkit/export.export_fused): run eagerly it tests its condition on the
host once per round, as a Python loop would; exported, it is one node.
A fixed round count would have to be ``pre_nms`` to stay exact (on a chain
where each box suppresses the next, the first ``m`` kept boxes settle only
after ``2m - 2`` rounds, and ``merge`` drops boxes after the loop, so
``max_det`` bounds nothing).
"""

from __future__ import annotations

import torch
from torch._higher_order_ops.while_loop import while_loop_op

__all__ = ["xywh2xyxy", "box_iou", "non_max_suppression"]

_MAX_WH = 4096.0


def xywh2xyxy(x):
    xy, wh = x[..., :2], x[..., 2:4]
    return torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)


def box_iou(a, b):
    """[..., N, 4] x [..., M, 4] -> [..., N, M] IoU (xyxy)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter + 1e-12)


def _top(scores, k):
    """The ``k`` largest along the last axis, lower index first among ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_step(keep, valid, sup):
    """One round: valid & ~(keep @ sup).  Sums of 0/1 products are exact in
    f32 (and TF32)."""
    return valid & ~(torch.bmm(keep.to(sup.dtype)[:, None, :], sup)[:, 0] > 0.0)


def _changed(keep, prev, valid, sup):
    return (keep != prev).any()


def _next_round(keep, prev, valid, sup):
    return _suppress_step(keep, valid, sup), keep.clone()  # a loop output may not alias its input


def _greedy_keep(valid, sup):
    """Greedy suppression as a fixed point (see the module docstring).  The
    operator itself is called, not ``torch._higher_order_ops.while_loop``,
    which runs an eager call through ``torch.compile``.

    :param valid: [B, k] bool
    :param sup: [B, k, k] f32, 1 where candidate i (row) suppresses j > i
    :returns: [B, k] bool, the kept candidates"""
    # no two operands may be one tensor: the previous keep starts as a copy
    keep, _ = while_loop_op(_changed, _next_round,
                            (_suppress_step(valid, valid, sup), valid.clone()), (valid, sup))
    return keep


@torch.no_grad()
def non_max_suppression(prediction, conf_thresh=0.1, iou_thresh=0.6, max_det=300,
                        pre_nms=512, multi_label=True, agnostic=False, merge=False):
    """:param prediction: [B, N, 5 + nc] decoded head output (any float
        dtype; the NMS runs in f32 with autocast off)
    :returns: (dets [B, max_det, 6] f32, valid [B, max_det] bool)"""
    args = (prediction.float(), conf_thresh, iou_thresh, max_det, pre_nms, multi_label,
            agnostic, merge)
    dev = prediction.device.type
    if not torch.is_autocast_enabled(dev):  # no context: an exported program keeps no node
        return _nms(*args)
    with torch.autocast(device_type=dev, enabled=False):
        return _nms(*args)


def _nms(pred, conf_thresh, iou_thresh, max_det, pre_nms, multi_label, agnostic, merge):
    b, n, _ = pred.shape
    nc = pred.shape[-1] - 5
    obj = pred[..., 4]
    cls_conf = pred[..., 5:] * obj[..., None]  # [B, N, nc]
    cand = obj > conf_thresh
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    if multi_label:
        scores_flat = torch.where(cand[..., None] & (cls_conf > conf_thresh), cls_conf,
                                  zero).reshape(b, -1)
    else:
        best, best_cls = cls_conf.max(dim=-1)  # first index among ties, as jnp.argmax
        onehot = torch.nn.functional.one_hot(best_cls, nc).to(pred.dtype)
        scores_flat = (torch.where(cand & (best > conf_thresh), best, zero)[..., None]
                       * onehot).reshape(b, -1)

    k = min(pre_nms, scores_flat.shape[-1])
    top_scores, top_idx = _top(scores_flat, k)
    box_idx = top_idx // nc
    cls_idx = (top_idx % nc).to(pred.dtype)
    boxes = xywh2xyxy(torch.gather(pred[..., :4], 1, box_idx[..., None].expand(b, k, 4)))
    valid = top_scores > 0.0

    off = torch.zeros_like(cls_idx) if agnostic else cls_idx * _MAX_WH
    iou = box_iou(boxes + off[..., None], boxes + off[..., None])  # [B, k, k]
    over = iou > iou_thresh
    later = torch.ones(k, k, dtype=torch.bool, device=pred.device).triu(1)
    sup = (over & later).to(pred.dtype)  # sup[:, i, j]: i suppresses j if i is kept

    keep = _greedy_keep(valid, sup)

    out_boxes = boxes
    if merge:
        # weighted box fusion over overlapping candidates (yolov5_detector.py:113-122)
        w = over.to(pred.dtype) * (top_scores * valid)[:, None, :]
        merged = torch.bmm(w, boxes) / w.sum(dim=-1, keepdim=True).clamp(min=1e-12)
        redundant = over.sum(dim=-1) > 1
        out_boxes = torch.where(keep[..., None], merged, boxes)
        keep = keep & redundant

    final_scores = torch.where(keep, top_scores, zero)
    md = min(max_det, k)
    sel_scores, sel = _top(final_scores, md)
    dets = torch.cat([torch.gather(out_boxes, 1, sel[..., None].expand(b, md, 4)),
                      sel_scores[..., None], torch.gather(cls_idx, 1, sel)[..., None]], dim=-1)
    if md < max_det:  # pad to the fixed max_det shape
        dets = torch.cat([dets, dets.new_zeros(b, max_det - md, 6)], dim=1)
        sel_scores = torch.cat([sel_scores, sel_scores.new_zeros(b, max_det - md)], dim=1)
    return dets, sel_scores > 0.0
