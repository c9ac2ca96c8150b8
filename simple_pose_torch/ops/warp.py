"""Batched on-device affine crop.

Port of simple_pose_tpu/ops/warp.py.  cv2.warpAffine INTER_LINEAR with
BORDER_CONSTANT 0, in exact float bilinear:

  * ``affine_crop``            -- any affine, 4-neighbour gather (the exact
                                  training crop, ``crop_impl='gather'``, and
                                  the oracle of the two-stage crop).
  * ``affine_crop_separable``  -- axis-aligned affines (the eval crop): the
                                  warp factorizes exactly into two
                                  interpolation matmuls out = R_y @ img @ C_x^T.
  * ``decompose_affine`` + ``stage1_resample`` -- the first stage of the
                                  two-stage rotated crop; the second stage is
                                  the K1 kernel (ops/rotate_resample.py).

The interpolation matmuls are plain batched matmuls (the JAX package leaves
them to XLA, so the port leaves them to torch.matmul).  ``affine_crop_mxu``
and ``_onehot_lerp`` are not ported: they exist because gathers are slow on
a TPU, and on the GPU the K1 kernel gathers its 4 taps directly.

Matrices follow the cv2.warpAffine convention: ``trans`` maps SOURCE coords
to DESTINATION coords and is inverted on the device.
"""

from __future__ import annotations

import torch

__all__ = ["invert_affine_batch", "affine_crop", "affine_crop_separable",
           "decompose_affine", "stage1_resample"]


def invert_affine_batch(m):
    """Invert [..., 2, 3] affines."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    tx, ty = m[..., 0, 2], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _src_coords(inv, out_hw):
    """Map the output pixel grid through [B, 2, 3] dst->src affines.

    Returns (src_x, src_y), each [B, oh, ow] f32."""
    oh, ow = out_hw
    dev = inv.device
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    inv = inv.to(torch.float32)
    src_x = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    src_y = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    return src_x, src_y


def affine_crop(images, trans, out_hw):
    """General batched bilinear affine crop (4-neighbour gather).

    :param images: [B, H, W, C] (any real dtype; uint8 fine)
    :param trans: [B, 2, 3] source->dest affines (cv2 convention)
    :param out_hw: (out_h, out_w)
    :returns: [B, out_h, out_w, C] float32
    """
    b, h, w, c = images.shape
    oh, ow = out_hw
    inv = invert_affine_batch(trans.to(torch.float32))
    src_x, src_y = _src_coords(inv, out_hw)
    x0f, y0f = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0f)[..., None]
    wy = (src_y - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    img = images.to(torch.float32).reshape(b, h * w, c)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = torch.gather(img, 1, idx.reshape(b, oh * ow, 1).expand(b, oh * ow, c))
        return vals.reshape(b, oh, ow, c) * valid[..., None].to(torch.float32)

    top = tap(x0, y0) * (1.0 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1.0 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def _interp_matrix(starts, steps, out_size, src_size):
    """[B, out_size, src_size] bilinear interpolation matrices.

    Row ``o`` holds weight (1-frac) at floor(p) and frac at floor(p)+1 where
    p = starts + o*steps; out-of-range taps get zero weight (BORDER_CONSTANT).
    """
    dev = starts.device
    o = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    p = starts[:, None] + o * steps[:, None]  # [B, O]
    p0 = torch.floor(p)
    frac = (p - p0)[..., None]
    s = torch.arange(src_size, dtype=torch.float32, device=dev)[None, None, :]
    p0 = p0[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(s == p0, 1.0 - frac, zero) + torch.where(s == p0 + 1.0, frac, zero)


def affine_crop_separable(images, trans, out_hw):
    """Axis-aligned batched bilinear crop as two batched f32 matmuls.

    Requires trans[:, 0, 1] == trans[:, 1, 0] == 0 (no rotation/shear), which
    holds for every eval transform.

    :param images: [B, H, W, C] (uint8 fine)
    :param trans: [B, 2, 3] source->dest affines
    :param out_hw: (out_h, out_w)
    :returns: [B, out_h, out_w, C] float32
    """
    b, h, w, c = images.shape
    oh, ow = out_hw
    inv = invert_affine_batch(trans.to(torch.float32))
    sx, tx = inv[:, 0, 0], inv[:, 0, 2]
    sy, ty = inv[:, 1, 1], inv[:, 1, 2]
    ry = _interp_matrix(ty, sy, oh, h)  # [B, oh, H]
    cx = _interp_matrix(tx, sx, ow, w)  # [B, ow, W]
    img = images.to(torch.float32).reshape(b, h, w * c)
    tmp = torch.bmm(ry, img).reshape(b, oh, w, c)  # [B, oh, W, C]
    # contract W with cx: out[b, o, x, c] = sum_w cx[b, x, w] tmp[b, o, w, c]
    tmp = tmp.transpose(1, 2).reshape(b, w, oh * c)
    out = torch.bmm(cx, tmp).reshape(b, ow, oh, c)  # [B, ow, oh, C]
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Two-stage crop for rotated affines (warp.py:181-223).
#
#   inv = [A | t],  A = D @ R   with D = diag(row norms), R unit-row.
#   Stage 1: intermediate I(u) = canvas(D u + t - D u0) -- axis-aligned, the
#            two separable interpolation matmuls (exact bilinear).
#   Stage 2: out(x) = I(R x + u0) -- the rotation resample, K1
#            (ops/rotate_resample.py).
#
# The rotated output rect spans < hypot(oh, ow) + 2 px in each u axis for any
# affine, so the intermediate edge is static.  u0 is an integer, so an
# axis-aligned affine makes stage 2 an exact integer passthrough.
# ---------------------------------------------------------------------------


def decompose_affine(trans, out_hw, inter):
    """inv = [A|t], A = D R split used by the two-stage crop.

    :returns: (d0, d1, r_mat [B,2,2], u0 [B,2] integer-valued, t1x, t1y)"""
    oh, ow = out_hw
    inv = invert_affine_batch(trans.to(torch.float32))
    a_mat = inv[:, :, :2]
    t_vec = inv[:, :, 2]
    d0 = torch.linalg.vector_norm(a_mat[:, 0, :], dim=-1) + 1e-12
    d1 = torch.linalg.vector_norm(a_mat[:, 1, :], dim=-1) + 1e-12
    r_mat = a_mat / torch.stack([d0, d1], dim=-1)[..., None]
    corners = torch.tensor([[0.0, 0.0], [ow - 1.0, 0.0], [0.0, oh - 1.0], [ow - 1.0, oh - 1.0]],
                           dtype=torch.float32, device=inv.device)
    u_corners = torch.einsum("bij,kj->bki", r_mat, corners)
    u0 = torch.ceil(-u_corners.amin(dim=1)) + 1.0
    t1x = t_vec[:, 0] - d0 * u0[:, 0]
    t1y = t_vec[:, 1] - d1 * u0[:, 1]
    return d0, d1, r_mat, u0, t1x, t1y


def stage1_resample(images, d0, d1, t1x, t1y, inter):
    """Separable axis-aligned resample canvas -> [B, inter, inter, C] f32.

    The JAX package's numerics (warp.py:214-223): interpolation matrices and
    the image rounded to bf16, the first product accumulated in f32 and
    rounded to bf16, the second accumulated in f32.  Both products run as f32
    matmuls on operands already rounded to bf16: a bf16 x bf16 product is
    exact in f32 (and in TF32), so no flag or backend can reduce them in
    bf16.  Each output is a sum of two nonzero products, so the result does
    not depend on the order of the sums either.  Autocast is off inside: it
    would run the products in bf16."""
    b, h, w, c = images.shape
    bf16 = torch.bfloat16
    with torch.autocast(device_type=images.device.type, enabled=False):
        ry = _interp_matrix(t1y, d1, inter, h).to(bf16).float()  # [B, inter, H]
        cx = _interp_matrix(t1x, d0, inter, w).to(bf16).float()  # [B, inter, W]
        img = images.to(bf16).float().reshape(b, h, w * c)
        tmp = torch.bmm(ry, img).to(bf16).float().reshape(b, inter, w, c)
        # contract W with cx: out[b, o, x, c] = sum_w cx[b, x, w] tmp[b, o, w, c]
        tmp = tmp.transpose(1, 2).reshape(b, w, inter * c)
        out = torch.bmm(cx, tmp).reshape(b, inter, inter, c)  # [B, x, o, C]
    return out.transpose(1, 2)
