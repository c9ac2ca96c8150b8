"""Batched on-device crop geometry for the fused detect -> crop -> pose
program.

Port of simple_pose_tpu/ops/affine_jax.py:

  * ``boxes_to_crop_affines``      -- box_to_center_scale + get_affine_transform
                                      (rot 0) of ops/affine.py in closed form:
                                      for axis-aligned transforms the 3-point
                                      construction is a scale + translation.
  * ``affine_crop_separable_multi`` -- P crops per image from one canvas,
                                      without copying the canvas P times.

The crops are two dense interpolation products, as in ops/warp.
affine_crop_separable; the JAX package leaves them to XLA, so the port
leaves them to torch.bmm, in f32 with autocast off.
"""

from __future__ import annotations

import torch

from simple_pose_torch.ops.warp import _interp_matrix, invert_affine_batch

__all__ = ["boxes_to_crop_affines", "affine_crop_separable_multi"]


def boxes_to_crop_affines(boxes, input_shape=(192, 256), output_shape=(48, 64), scale_mult=1.25):
    """[..., 4] xyxy boxes -> (trans [..., 2, 3] into the input crop,
    trans_inv [..., 2, 3] from the output heatmap back to source coords).

    input_shape/output_shape are (w, h) like the reference."""
    in_w, in_h = float(input_shape[0]), float(input_shape[1])
    out_w, out_h = float(output_shape[0]), float(output_shape[1])
    aspect = in_w / in_h
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    cx = x1 + w * 0.5
    cy = y1 + h * 0.5
    w_snap = torch.where(w < aspect * h, h * aspect, w)
    sw = w_snap * scale_mult
    zeros = torch.zeros_like(cx)

    def affine(sx, sy, tx, ty):
        return torch.stack([torch.stack([sx, zeros, tx], dim=-1),
                            torch.stack([zeros, sy, ty], dim=-1)], dim=-2)

    # src -> crop: uniform scale k = in_w / sw (aspect snapped, so the y
    # scale in_h / sh is the same)
    k = in_w / sw
    trans = affine(k, k, in_w * 0.5 - k * cx, in_h * 0.5 - k * cy)
    # heatmap -> src
    k_inv = sw / out_w
    trans_inv = affine(k_inv, k_inv, cx - k_inv * out_w * 0.5, cy - k_inv * out_h * 0.5)
    return trans, trans_inv


def affine_crop_separable_multi(images, trans, out_hw, out_dtype=None):
    """P crops per image without replicating the images.

    :param images: [B, H, W, C] (uint8 fine)
    :param trans: [B, P, 2, 3] axis-aligned src->dst affines
    :param out_dtype: optional narrowed output (the resample is f32 either way)
    :returns: [B, P, out_h, out_w, C] float32 (or out_dtype)"""
    b, h, w, c = images.shape
    p = trans.shape[1]
    oh, ow = out_hw
    with torch.autocast(device_type=images.device.type, enabled=False):
        inv = invert_affine_batch(trans.to(torch.float32).reshape(b * p, 2, 3))
        ry = _interp_matrix(inv[:, 1, 2], inv[:, 1, 1], oh, h).reshape(b, p * oh, h)
        cx = _interp_matrix(inv[:, 0, 2], inv[:, 0, 0], ow, w)  # [B*P, ow, W]
        img = images.to(torch.float32).reshape(b, h, w * c)
        tmp = torch.bmm(ry, img).reshape(b * p, oh, w, c)  # [B*P, oh, W, C]
        # contract W with cx: out[n, o, x, c] = sum_w cx[n, x, w] tmp[n, o, w, c]
        tmp = tmp.transpose(1, 2).reshape(b * p, w, oh * c)
        out = torch.bmm(cx, tmp).reshape(b, p, ow, oh, c).transpose(2, 3)
    return out if out_dtype is None else out.to(out_dtype)
