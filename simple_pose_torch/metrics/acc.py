"""Training-time PCK-style heatmap accuracy.

Port of simple_pose_tpu/metrics/acc.py (reference HeatMapAcc,
metrics/pose_metrics.py:212-245): argmax both maps, distance normalized by
(w, h)/norm_frac, a joint counts as correct when the normalized distance is
below distance_thresh; labels at x<=1 or y<=1 are invalid; per-joint
accuracy averaged over joints that have >=1 valid label.  Stays on the
device (a 0-d tensor).
"""

from __future__ import annotations

import torch

from simple_pose_torch.ops.decode import heatmap_to_coords

__all__ = ["heatmap_accuracy", "heatmap_accuracy_counts", "accuracy_from_counts"]


def heatmap_accuracy_counts(predicts, targets, distance_thresh=0.5, norm_frac=10.0):
    """Per joint: (correct labels, valid labels) as f32 [C] tensors, the sums
    that :func:`heatmap_accuracy` divides (summed over ranks, they give the
    global batch's accuracy)."""
    preds, _ = heatmap_to_coords(predicts)
    labels, _ = heatmap_to_coords(targets)
    h, w = predicts.shape[-2:]
    norm = torch.tensor([w, h], dtype=torch.float32, device=predicts.device) / norm_frac
    valid = (labels[..., 0] > 1) & (labels[..., 1] > 1)  # [B, C]
    distance = torch.linalg.vector_norm(preds / norm - labels / norm, dim=-1)  # [B, C]
    correct = (distance < distance_thresh) & valid
    return correct.sum(dim=0).float(), valid.sum(dim=0).float()


def accuracy_from_counts(correct, valid):
    """The mean over joints with a valid label of correct / valid."""
    per_joint_acc = correct / valid.clamp_min(1)
    has_valid = valid >= 1
    cnt = has_valid.sum()
    acc = torch.where(has_valid, per_joint_acc, torch.zeros_like(per_joint_acc)).sum()
    acc = acc / cnt.clamp_min(1)
    return torch.where(cnt > 0, acc, torch.zeros_like(acc))


def heatmap_accuracy(predicts, targets, distance_thresh=0.5, norm_frac=10.0):
    """:param predicts: [B, C, H, W]; :param targets: [B, C, H, W]
    :returns: 0-d f32 tensor, accuracy in [0, 1]."""
    return accuracy_from_counts(*heatmap_accuracy_counts(predicts, targets, distance_thresh,
                                                         norm_frac))
