"""Plain float32 PyTorch and NumPy versions of the steps around the model:
the crops, the normalization, flip-test, the Gauss-Taylor decode, the
heatmap targets and the training loss.

Written from the reference repository's definitions (liangheming/
simple_pose: ``commons/transforms.py``, ``metrics/pose_metrics.py``,
``datasets/coco.py``, ``dp_pose_resnet_solver.py``), imports torch and
numpy alone, and runs in float32 (the blur in float64).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["exact_f32", "crop", "crop_two_stage", "decompose", "normalize", "flip_merge", "decode", "targets",
           "masked_mse", "FLIP_PERM"]

RGB_MEAN = (0.485, 0.456, 0.406)
_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))
FLIP_PERM = list(range(17))
for _a, _b in _PAIRS:
    FLIP_PERM[_a], FLIP_PERM[_b] = _b, _a


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 (cuDNN's convs default to it)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def crop(canvas, trans, out_hw):
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT 0) of each canvas by its
    source -> patch affine: each output pixel maps back through the
    inverted affine and takes the bilinear mix of its four neighbours
    (zero outside the canvas).  canvas [B, H, W, C] uint8, trans [B, 2, 3];
    returns [B, oh, ow, C] float32."""
    b, h, w, c = canvas.shape
    oh, ow = out_hw
    t = trans.double()
    a = t[:, :, :2]
    inv_a = torch.linalg.inv(a)
    inv_t = -(inv_a @ t[:, :, 2:])[..., 0]
    inv = torch.cat([inv_a, inv_t[..., None]], dim=-1).float()
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=canvas.device),
                            torch.arange(ow, dtype=torch.float32, device=canvas.device),
                            indexing="ij")
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    img = canvas.float().reshape(b, h * w, c)

    def tap(xi, yi):
        ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(b, oh * ow, 1)
        return torch.gather(img, 1, idx.expand(b, oh * ow, c)).reshape(b, oh, ow, c) * ok

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def decompose(trans, out_hw, inter):
    """The two-stage crop's split of each source -> patch affine.  With
    inv = [A | t] its inverse and A = D R, D the row norms of A: stage 1
    resamples the canvas axis-aligned into an ``inter`` x ``inter``
    intermediate at (d0 x + t1x, d1 y + t1y); stage 2 samples that at
    R p + u0, u0 the integer offset that keeps every output pixel's sample
    inside it.  Returns (d0, d1, R, u0, t1x, t1y)."""
    oh, ow = out_hw
    t = trans.double()
    inv_a = torch.linalg.inv(t[:, :, :2])
    inv_t = -(inv_a @ t[:, :, 2:])[..., 0]
    inv_a, inv_t = inv_a.float(), inv_t.float()
    d0 = torch.linalg.vector_norm(inv_a[:, 0], dim=-1) + 1e-12
    d1 = torch.linalg.vector_norm(inv_a[:, 1], dim=-1) + 1e-12
    r = inv_a / torch.stack([d0, d1], -1)[..., None]
    corners = torch.tensor([[0.0, 0.0], [ow - 1.0, 0.0], [0.0, oh - 1.0], [ow - 1.0, oh - 1.0]],
                           device=trans.device)
    u0 = torch.ceil(-torch.einsum("bij,kj->bki", r, corners).amin(dim=1)) + 1.0
    return d0, d1, r, u0, inv_t[:, 0] - d0 * u0[:, 0], inv_t[:, 1] - d1 * u0[:, 1]


def _lerp_matrix(start, step, n_out, n_src):
    """[B, n_out, n_src]: row o mixes source floor(p) and floor(p) + 1 at
    p = start + o step, zero weight outside the source."""
    o = torch.arange(n_out, dtype=torch.float32, device=start.device)[None, :, None]
    p = start[:, None, None] + o * step[:, None, None]
    p0 = torch.floor(p)
    s = torch.arange(n_src, dtype=torch.float32, device=start.device)[None, None, :]
    return (s == p0) * (1 - (p - p0)) + (s == p0 + 1) * (p - p0)


def crop_two_stage(canvas, trans, out_hw):
    """The training crop (the configurations' trainer crops rotated boxes in
    two resamples): stage 1 an axis-aligned bilinear resample of the canvas
    into the ``ceil(hypot(out)) + 8`` square intermediate, stage 2 a
    bilinear resample of the intermediate at the rotated grid, zero outside
    it.  canvas [B, H, W, C] uint8; returns [B, oh, ow, C] float32."""
    b, h, w, c = canvas.shape
    oh, ow = out_hw
    inter = int(np.ceil(np.hypot(oh, ow))) + 8
    d0, d1, r, u0, t1x, t1y = decompose(trans, out_hw, inter)
    ry = _lerp_matrix(t1y, d1, inter, h)
    cx = _lerp_matrix(t1x, d0, inter, w)
    tmp = torch.bmm(ry, canvas.float().reshape(b, h, w * c)).reshape(b, inter, w, c)
    tmp = torch.bmm(cx, tmp.transpose(1, 2).reshape(b, w, inter * c))
    mid = tmp.reshape(b, inter, inter, c).transpose(1, 2).reshape(b, inter * inter, c)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=canvas.device),
                            torch.arange(ow, dtype=torch.float32, device=canvas.device),
                            indexing="ij")
    ux = r[:, 0, 0, None, None] * xs + r[:, 0, 1, None, None] * ys + u0[:, 0, None, None]
    uy = r[:, 1, 0, None, None] * xs + r[:, 1, 1, None, None] * ys + u0[:, 1, None, None]
    x0, y0 = torch.floor(ux), torch.floor(uy)
    fx, fy = (ux - x0)[..., None], (uy - y0)[..., None]

    def tap(xi, yi):
        ok = ((xi >= 0) & (xi < inter) & (yi >= 0) & (yi < inter))[..., None]
        idx = (yi.clamp(0, inter - 1) * inter + xi.clamp(0, inter - 1)).long()
        return torch.gather(mid, 1, idx.reshape(b, oh * ow, 1).expand(b, oh * ow, c)).reshape(
            b, oh, ow, c) * ok

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def normalize(crops):
    """[B, H, W, 3] in [0, 255] -> NCHW network input: /255, mean
    subtracted, no std divide (datasets/coco.py)."""
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=crops.device)
    return (crops / 255.0 - mean).permute(0, 3, 1, 2).contiguous()


def flip_merge(heat, heat_flipped):
    """Flip-test: the flipped input's maps flipped back, left/right joints
    swapped, shifted one pixel right, averaged with the maps."""
    hf = heat_flipped[:, FLIP_PERM].flip(3)
    hf = torch.cat([hf[..., :1], hf[..., :-1]], dim=-1)
    return (heat + hf) * 0.5


def _gaussian_kernel(ksize=11):
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def decode(heat, ksize=11):
    """The DarkPose Gauss-Taylor decoder (pose_metrics.py:55-107) in heatmap
    coordinates: argmax of each map, an 11x11 Gaussian blur renormalized to
    the map's max, its log, and one Newton step -H^-1 g from the argmax,
    taken where the argmax is 2 or more pixels inside the border and the
    Hessian is invertible (the step's x and y clamped at 0 as the JAX
    decoder does).

    :returns: (coords [B, J, 2], peak [B, J], step [B, J, 2]: the Newton
        step taken, 0 where none)"""
    heat = heat.float()
    b, c, h, w = heat.shape
    flat = heat.reshape(b, c, h * w)
    peak, idx = flat.max(dim=-1)
    x, y = idx % w, idx // w
    coords = torch.stack([x, y], -1).float() * (peak > 0)[..., None].float()
    k = torch.as_tensor(_gaussian_kernel(ksize), device=heat.device)
    pad = (ksize - 1) // 2
    blur = F.conv2d(heat.double().reshape(b * c, 1, h, w), k.reshape(1, 1, 1, -1), padding=(0, pad))
    blur = F.conv2d(blur, k.reshape(1, 1, -1, 1), padding=(pad, 0)).float().reshape(b, c, h, w)
    blur = blur * (peak / blur.reshape(b, c, -1).amax(-1))[..., None, None]
    logm = torch.log(blur.clamp(min=1e-10)).reshape(b, c, h * w)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    ok = (xi > 1) & (xi < w - 2) & (yi > 1) & (yi < h - 2)
    xc, yc = xi.clamp(2, w - 3), yi.clamp(2, h - 3)

    def g(dx, dy):
        return torch.gather(logm, -1, ((yc + dy) * w + xc + dx)[..., None])[..., 0]

    gx, gy = 0.5 * (g(1, 0) - g(-1, 0)), 0.5 * (g(0, 1) - g(0, -1))
    gxx = 0.25 * (g(2, 0) - 2 * g(0, 0) + g(-2, 0))
    gyy = 0.25 * (g(0, 2) - 2 * g(0, 0) + g(0, -2))
    gxy = 0.25 * (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1))
    det = gxx * gyy - gxy * gxy
    ok = ok & (det != 0)
    safe = torch.where(ok, det, torch.ones_like(det))
    step = torch.stack([-(gyy * gx - gxy * gy) / safe, -(-gxy * gx + gxx * gy) / safe], -1)
    new = (coords + step).clamp(min=0.0)
    coords = torch.where(ok[..., None], new, coords)
    step = torch.where(ok[..., None], step, torch.zeros_like(step))
    return coords, peak, step


def targets(joints, shape=(64, 48), sigma=2.0):
    """DarkPose's unbiased targets (RefineSimpleTransform.get_heat_map): a
    dense Gaussian at each joint's continuous position, rendered where the
    joint is visible (> 0.5) and its 3-sigma window is not wholly outside
    the map; weights are the visibility, 0 for such an outside joint."""
    h, w = shape
    mx, my, vis = joints[..., 0], joints[..., 1], joints[..., 2]
    t = sigma * 3
    outside = ((torch.trunc(mx - t) >= w) | (torch.trunc(my - t) >= h)
               | (torch.trunc(mx + t + 1) < 0) | (torch.trunc(my + t + 1) < 0))
    weight = torch.where(outside, torch.zeros_like(vis), vis)
    ys = torch.arange(h, dtype=torch.float32, device=joints.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=joints.device)[None, :]
    d2 = (xs - mx[..., None, None]) ** 2 + (ys - my[..., None, None]) ** 2
    g = torch.exp(-d2 / (2 * sigma ** 2))
    render = (vis > 0.5) & (weight > 0)
    return torch.where(render[..., None, None], g, torch.zeros_like(g)), weight


def masked_mse(pred, tgt, weight):
    """0.5 * mean((pred * m - tgt * m)^2), m the joint weight
    (dp_pose_resnet_solver.py:107)."""
    m = weight[..., None, None]
    return 0.5 * torch.mean((pred * m - tgt * m) ** 2)
