"""On-device keypoint decoders: heatmap -> sub-pixel image coordinates.

Port of simple_pose_tpu/ops/decode.py:45-242 (reference
metrics/pose_metrics.py:10-169):

  * heatmap_to_coords      -> argmax and peak value per map
  * decode_basic           -> argmax + 0.25px shift toward the higher
                              neighbor + inverse affine
  * decode_gauss_taylor    -> the DarkPose decoder: depthwise 11x11 Gaussian
                              blur, renormalize to the pre-blur max, log,
                              finite-difference gradient/Hessian at the peak,
                              Newton step -H^-1 grad (closed-form 2x2
                              inverse), masked where the Hessian is singular
                              or the peak is too close to the border.
  * decode_dark_original   -> the reference's DarkPoseOriginalKeyPointDecoder
                              on the host in numpy (f64 blur, no clamp on
                              the Taylor step)

All gathers are ``torch.gather`` on the flattened H*W axis; masked updates
are ``torch.where``.  Everything runs in float32 (the blur in float64).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "gaussian_kernel_1d",
    "heatmap_to_coords",
    "decode_basic",
    "decode_gauss_taylor",
    "decode_dark_original",
    "apply_trans_inv",
    "instance_scores",
]

# cv2.getGaussianKernel fixed binomial tables for small even-symmetric kernels
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0, device=None):
    """cv2.getGaussianKernel semantics: sigma<=0 derives sigma from ksize,
    and kernel sizes <= 7 use the fixed binomial tables."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        k = _SMALL_GAUSSIAN_TAB[ksize]
    else:
        if sigma <= 0:
            sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
        xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
        k = np.exp(-(xs**2) / (2.0 * sigma**2))
        k = k / np.sum(k)
    return torch.as_tensor(k, dtype=torch.float32, device=device)


def heatmap_to_coords(heat):
    """Per-map argmax -> (x, y) coords and peak value.

    :param heat: [B, C, H, W]
    :returns: (coords [B, C, 2] float32, max_val [B, C, 1] float32)
    Coords are zeroed where the peak value is <= 0 (pose_metrics.py:23).
    """
    b, c, h, w = heat.shape
    flat = heat.reshape(b, c, h * w)
    max_val = flat.amax(dim=-1, keepdim=True)
    idx = flat.argmax(dim=-1)  # first maximum, as jnp.argmax
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    coords = torch.stack([x, y], dim=-1)
    coords = coords * (max_val > 0.0).to(torch.float32)
    return coords, max_val


def apply_trans_inv(coords, trans_inv):
    """Map [B, C, 2] heatmap coords through per-sample 2x3 inverse affines:
    out[b,c,a] = sum_d xyz[b,c,d] * T[b,a,d]."""
    xyz = torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)
    return torch.einsum("bcd,bad->bca", xyz, trans_inv.to(torch.float32))


def decode_basic(heat, trans_inv):
    """Argmax + quarter-pixel shift decoder (pose_metrics.py:26-52)."""
    heat = heat.to(torch.float32)
    b, c, h, w = heat.shape
    coords, max_val = heatmap_to_coords(heat)
    x = coords[..., 0].long()
    y = coords[..., 1].long()
    valid = (x > 1) & (x < w - 1) & (y > 1) & (y < h - 1)

    flat = heat.reshape(b, c, h * w)
    xc = x.clamp(1, w - 2)
    yc = y.clamp(1, h - 2)
    idx = torch.stack([yc * w + xc + 1, yc * w + xc - 1,
                       (yc + 1) * w + xc, (yc - 1) * w + xc], dim=-1)
    v = torch.gather(flat, -1, idx)
    diff_x = torch.sign(v[..., 0] - v[..., 1])
    diff_y = torch.sign(v[..., 2] - v[..., 3])
    shift = torch.stack([diff_x, diff_y], dim=-1) * 0.25
    coords = torch.where(valid[..., None], coords + shift, coords)
    return apply_trans_inv(coords, trans_inv), max_val


def _blur(heat, ksize):
    """Depthwise Gaussian blur + pre/post maxes (pose_metrics.py:68-71).

    The renorm, clamp and log are applied lazily at the gathered Taylor taps
    in decode_gauss_taylor (elementwise functions commute with gather).  The
    two small convs run in f64, so cuDNN's TF32 default for f32 convs never
    touches them.
    """
    b, c, h, w = heat.shape
    k1 = gaussian_kernel_1d(ksize, device=heat.device).double()
    pad = (ksize - 1) // 2
    x = heat.double().reshape(b * c, 1, h, w)
    x = F.conv2d(x, k1.reshape(1, 1, 1, ksize), padding=(0, pad))
    x = F.conv2d(x, k1.reshape(1, 1, ksize, 1), padding=(pad, 0))
    blur = x.float().reshape(b, c, h, w)
    ori_max = heat.reshape(b, c, -1).amax(dim=-1)
    blur_max = blur.reshape(b, c, -1).amax(dim=-1)
    return blur, ori_max, blur_max


_TAYLOR_TAPS = ((1, 0), (-1, 0), (0, 1), (0, -1), (2, 0), (-2, 0),
                (1, 1), (1, -1), (-1, 1), (-1, -1), (0, 2), (0, -2), (0, 0))


def decode_gauss_taylor(heat, trans_inv, ksize: int = 11):
    """DarkPose Gauss-Taylor decoder (pose_metrics.py:55-107)."""
    heat = heat.to(torch.float32)
    b, c, h, w = heat.shape
    coords, max_val = heatmap_to_coords(heat)
    blur, ori_max, blur_max = _blur(heat, ksize)
    flat = blur.reshape(b, c, h * w)

    x = coords[..., 0].long()
    y = coords[..., 1].long()
    valid = (x > 1) & (x < w - 2) & (y > 1) & (y < h - 2)
    xc = x.clamp(2, w - 3)
    yc = y.clamp(2, h - 3)

    # one batched gather of all 13 Taylor taps, then renorm -> clamp -> log
    # on just those values
    idx = torch.stack([(yc + dy) * w + (xc + dx) for dx, dy in _TAYLOR_TAPS], dim=-1)
    vals = torch.gather(flat, -1, idx)
    vals = torch.log(torch.clamp(vals * ori_max[..., None] / blur_max[..., None], min=1e-10))
    tap = {t: vals[..., i] for i, t in enumerate(_TAYLOR_TAPS)}
    g = lambda dx, dy: tap[(dx, dy)]  # noqa: E731
    dx_ = 0.5 * (g(1, 0) - g(-1, 0))
    dy_ = 0.5 * (g(0, 1) - g(0, -1))
    dxx = 0.25 * (g(2, 0) - 2.0 * g(0, 0) + g(-2, 0))
    dxy = 0.25 * (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1))
    dyy = 0.25 * (g(0, 2) - 2.0 * g(0, 0) + g(0, -2))

    det = dxx * dyy - dxy * dxy
    solvable = det != 0.0
    safe_det = torch.where(solvable, det, torch.ones_like(det))
    # offset = -H^-1 @ grad with H = [[dxx, dxy], [dxy, dyy]]
    off_x = -(dyy * dx_ - dxy * dy_) / safe_det
    off_y = -(-dxy * dx_ + dxx * dy_) / safe_det
    update = valid & solvable
    new_x = torch.clamp(coords[..., 0] + off_x, min=0.0)
    new_y = torch.clamp(coords[..., 1] + off_y, min=0.0)
    coords = torch.where(update[..., None], torch.stack([new_x, new_y], dim=-1), coords)
    return apply_trans_inv(coords, trans_inv), max_val


def _cv2_gaussian_kernel_f64(ksize: int):
    """cv2.getGaussianKernel(ksize, 0, CV_64F): sigma = 0.3*((k-1)/2-1)+0.8
    (2.0 at k=11) beyond the fixed tables, a sequential sum and a multiply
    by its reciprocal, in float64."""
    if ksize in _SMALL_GAUSSIAN_TAB:
        return np.asarray(_SMALL_GAUSSIAN_TAB[ksize], dtype=np.float64)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp((-0.5 / (sigma * sigma)) * xs * xs)
    total = 0.0
    for v in k:
        total += v
    return k * (1.0 / total)


def _blur_zero_padded_f64(heat, ksize):
    """cv2.GaussianBlur(ksize x ksize, sigma 0) of each float64 map padded
    with zeros by the kernel radius, kept region only: with the pad equal
    to the radius no border rule reaches a kept pixel, so this is the
    separable convolution with zeros outside the map (rows, then columns)."""
    b, c, h, w = heat.shape
    k = _cv2_gaussian_kernel_f64(ksize)
    pad = (ksize - 1) // 2
    src = np.zeros((b, c, h, w + 2 * pad))
    src[..., pad:pad + w] = heat
    rows = sum(k[i] * src[..., i:i + w] for i in range(ksize))
    src = np.zeros((b, c, h + 2 * pad, w))
    src[..., pad:pad + h, :] = rows
    return sum(k[i] * src[..., i:i + h, :] for i in range(ksize))


def decode_dark_original(heat, trans_inv, ksize: int = 11):
    """Host DarkPose decoder, the reference's DarkPoseOriginalKeyPointDecoder
    (pose_metrics.py:110-169), in numpy without cv2 (JAX ops/decode.py:
    179-236 blurs with cv2).

    It differs from :func:`decode_gauss_taylor` in two ways: the blur is
    float64 on a zero-padded map (downcast to float32 before the renorm and
    the log, as the reference's float32 array does), and the Taylor step is
    applied without the clamp to >= 0.  Peaks with ``not (1 < px < w-2 and
    1 < py < h-2)`` keep their argmax.

    :param heat: [B, C, H, W] heatmaps (numpy or a CPU tensor)
    :param trans_inv: [B, 2, 3] heatmap -> image affines
    :returns: (keypoints f32 [B, C, 2], peak values f32 [B, C, 1]) as numpy
    """
    heat = np.asarray(heat, dtype=np.float32)
    trans_inv = np.asarray(trans_inv, dtype=np.float32)
    b, c, h, w = heat.shape
    flat = heat.reshape(b, c, -1)
    peak_idx = flat.argmax(-1)
    max_val = flat.max(-1)
    coords = np.stack([(peak_idx % w).astype(np.float32),
                       np.floor(peak_idx / w).astype(np.float32)], axis=-1)
    coords *= (max_val > 0)[..., None]

    blurred = _blur_zero_padded_f64(heat.astype(np.float64), ksize).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # an all-zero map: 0/0, never read
        blurred *= max_val[..., None, None] / blurred.max(axis=(-2, -1), keepdims=True)
        logmaps = np.log(np.maximum(blurred, np.float32(1e-10)))

    px, py = coords[..., 0].astype(np.int64), coords[..., 1].astype(np.int64)
    refine = (1 < px) & (px < w - 2) & (1 < py) & (py < h - 2)
    pxc, pyc = np.clip(px, 2, w - 3), np.clip(py, 2, h - 3)
    bi, ci = np.indices((b, c))

    def lm(dx, dy):
        return logmaps[bi, ci, pyc + dy, pxc + dx]

    gx = 0.5 * (lm(1, 0) - lm(-1, 0))
    gy = 0.5 * (lm(0, 1) - lm(0, -1))
    gxx = 0.25 * (lm(2, 0) - 2 * lm(0, 0) + lm(-2, 0))
    gxy = 0.25 * (lm(1, 1) - lm(1, -1) - lm(-1, 1) + lm(-1, -1))
    gyy = 0.25 * (lm(0, 2) - 2 * lm(0, 0) + lm(0, -2))
    det = gxx * gyy - gxy * gxy
    step = refine & (det != 0.0)
    safe = np.where(step, det, np.float32(1.0))
    with np.errstate(invalid="ignore"):  # taps of skipped peaks may be nan
        off_x = -(gyy * gx - gxy * gy) / safe
        off_y = -(-gxy * gx + gxx * gy) / safe
    coords[..., 0] = np.where(step, coords[..., 0] + off_x, coords[..., 0])
    coords[..., 1] = np.where(step, coords[..., 1] + off_y, coords[..., 1])

    xyz = np.concatenate([coords, np.ones_like(coords[..., :1])], axis=-1)
    return np.einsum("bcd,bad->bca", xyz, trans_inv), max_val[..., None]


def instance_scores(max_val):
    """Reference scoring rule: mean(conf) + max(conf) per instance
    (pose_metrics.py:176)."""
    return max_val[..., 0].mean(dim=-1) + max_val[..., 0].amax(dim=-1)
