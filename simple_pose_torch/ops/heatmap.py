"""On-device Gaussian heatmap target encoding.

Port of simple_pose_tpu/ops/heatmap.py (reference commons/transforms.py:
80-116 biased, :167-191 DarkPose-unbiased): one broadcasted exp over
[B, K, H, W], so target encoding never touches the host.

Semantics parity notes (vs RefineSimpleTransform.get_heat_map):
  * tmp_size = 3*sigma; the bounds test truncates like python int() on
    (mu - tmp_size) / (mu + tmp_size + 1) (``torch.trunc``); a joint whose
    Gaussian is fully out of bounds gets weight 0 and an all-zero map.
  * Maps are rendered only when vis > 0.5; weights keep the raw vis value
    for in-bounds joints.
  * The unbiased variant renders a dense Gaussian at the continuous
    (mu_x, mu_y); the biased variant snaps to int(mu/stride + 0.5) and only
    fills a (6*sigma+1)^2 window.
"""

from __future__ import annotations

import torch

__all__ = ["encode_unbiased", "encode_biased"]


def _grids(shape, device):
    h, w = shape
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]  # [H, 1]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]  # [1, W]
    return ys, xs


def _in_bounds_weight(mu_x, mu_y, vis, w, h, tmp_size):
    ul_x = torch.trunc(mu_x - tmp_size)
    ul_y = torch.trunc(mu_y - tmp_size)
    br_x = torch.trunc(mu_x + tmp_size + 1)
    br_y = torch.trunc(mu_y + tmp_size + 1)
    oob = (ul_x >= w) | (ul_y >= h) | (br_x < 0) | (br_y < 0)
    return torch.where(oob, torch.zeros_like(vis), vis)


def encode_unbiased(joints, shape=(64, 48), sigma=2.0):
    """DarkPose unbiased dense-Gaussian encoding.

    :param joints: [..., K, 3] (x, y, vis) in heatmap coordinates
    :param shape: (H, W) of the target maps
    :returns: (targets [..., K, H, W] float32, weights [..., K] float32)
    """
    h, w = shape
    joints = torch.as_tensor(joints).to(torch.float32)
    mu_x, mu_y, vis = joints[..., 0], joints[..., 1], joints[..., 2]
    tmp_size = sigma * 3.0
    weight = _in_bounds_weight(mu_x, mu_y, vis, w, h, tmp_size)
    render = (vis > 0.5) & (weight > 0.0)
    ys, xs = _grids((h, w), joints.device)
    d2 = (xs - mu_x[..., None, None]) ** 2 + (ys - mu_y[..., None, None]) ** 2
    g = torch.exp(-d2 / (2.0 * sigma**2))
    targets = torch.where(render[..., None, None], g, torch.zeros_like(g))
    return targets, weight


def encode_biased(joints, shape=(64, 48), sigma=2.0, stride=4):
    """Classic biased encoding: snap the center to int(mu/stride + 0.5) and
    fill only a (6*sigma+1)^2 window around it (BasicSimpleTransform,
    commons/transforms.py:80-116)."""
    h, w = shape
    joints = torch.as_tensor(joints).to(torch.float32)
    mu_x = torch.trunc(joints[..., 0] / stride + 0.5)
    mu_y = torch.trunc(joints[..., 1] / stride + 0.5)
    vis = joints[..., 2]
    tmp_size = sigma * 3.0
    weight = _in_bounds_weight(mu_x, mu_y, vis, w, h, tmp_size)
    render = (vis > 0.5) & (weight > 0.0)
    ys, xs = _grids((h, w), joints.device)
    dx = xs - mu_x[..., None, None]
    dy = ys - mu_y[..., None, None]
    g = torch.exp(-(dx**2 + dy**2) / (2.0 * sigma**2))
    window = (dx.abs() <= tmp_size) & (dy.abs() <= tmp_size)
    targets = torch.where(render[..., None, None] & window, g, torch.zeros_like(g))
    return targets, weight
