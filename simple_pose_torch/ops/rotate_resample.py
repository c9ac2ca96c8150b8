"""Two-stage rotated affine crop: the whole-crop kernel and the stage-2 kernel K1.

Port of simple_pose_tpu/ops/pallas_warp.py.  Which kernel runs where:

  * :func:`affine_crop_two_stage` (the training crop, the counterpart of
    ``affine_crop_pallas``): on a CUDA tensor, one hand-written Hopper kernel
    (``rotate_resample_crop_kernel`` in ``csrc/rotate_resample.cu``) takes
    the uint8 canvases and writes the crops, computing each stage-1
    intermediate pixel in shared memory where stage 2 needs it; on a CPU
    tensor, :func:`affine_crop_two_stage_reference`, the plain composition
    ``decompose_affine`` -> ``stage1_resample`` (ops/warp.py) -> channel-major
    bf16 intermediate -> :func:`rotate_resample_reference`.
  * :func:`rotate_resample` (stage 2 alone, the counterpart of
    ``rotate_resample_pallas``): on a CUDA tensor the kernel
    ``rotate_resample_kernel`` in the same source, on a CPU tensor
    :func:`rotate_resample_reference`.  The training step no longer runs it.

There is no fallback: a CUDA tensor reaches its kernel or raises.  Both
kernels replace ``_stage2_kernel`` (pallas_warp.py:45).  The TPU kernel's row
band, 96-wide column blocks, 128-lane x-window, lane padding and one-hot
matmul are TPU tiling that only drop terms which are exactly zero; every
version here gathers the 4 nonzero taps directly.  What bounds each kernel on
the card, and what its design does about it, is in the kernel source's header.

Stage 1, per intermediate pixel (iy, ix), channel c, of the uint8 canvas G
(the arithmetic of ops/warp.py ``stage1_resample``; the crop kernel repeats it):
  py = t1y + iy*d1, px = t1x + ix*d0          f32, multiply then add (unfused)
  wy = (bf16(1 - fy), bf16(fy)) at rows floor(py) + {0, 1}; wx likewise
  tmp_k = bf16(wy0*G[y0, x0+k] + wy1*G[y0+1, x0+k])    rows first
  I = bf16(wx0*tmp_0 + wx1*tmp_1)                       then columns
with canvas taps outside the canvas contributing 0.

Stage 2, per output pixel (y, x), channel c:
  ux = fma(r00, x, r01*y) + u0x, uy = fma(r10, x, r11*y) + u0y    f32
  wx_k = bf16(hat(x0 + k - ux)), wy_k = hat(y0 + k - uy)  x0, y0 = floor(u)
  row_j = I[y0+j, x0]*wx_0 + I[y0+j, x0+1]*wx_1           f32, exact products
  out = wy_0*row_0 + wy_1*row_1                            f32, rounded once
with hat(s) = max(0, 1 - |s|) and taps outside [0, inter) reading 0 (not an
extrapolated stage-1 value).  The fused multiply-add in u is how XLA compiles
the JAX package's ``r00 * x + r01 * y + u0x`` (measured against the Pallas
kernel in interpret mode: the unfused form flips the bf16 x-weight of ~8% of
the pixels).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from simple_pose_torch.ops.warp import decompose_affine, stage1_resample
from simple_pose_torch.utils.cuda_build import counts_launches, load_library

__all__ = ["rotate_resample", "rotate_resample_reference", "affine_crop_two_stage",
           "affine_crop_two_stage_reference", "crop_scalars", "crop_box_edge", "CROP_TILE"]

_KERNEL = "rotate_resample"
_OUT_DTYPES = (torch.float32, torch.bfloat16)
CROP_TILE = (32, 32)  # the crop kernel's output tile (rows, columns): kTileH, kTileW
_CROP_MAX_CHANNELS = 4  # kMaxChannels


def crop_box_edge(tile_h: int, tile_w: int) -> int:
    """Edge of the crop kernel's shared-memory box of intermediate pixels for
    a (tile_h x tile_w) output tile (kEdge in the kernel source).  R has unit
    rows, so one tile's stage-2 taps span less than hypot(tile_h - 1,
    tile_w - 1) + 2 pixels per axis at any rotation; the box adds one tap of
    padding on each side for the rounding of u."""
    return math.ceil(math.hypot(tile_h, tile_w)) + 4


def _fma(a, b, c):
    """f32 fma(a, b, c), rounded once: a*b of an f32 and a small integer is
    exact in f64, and so is the sum unless c is far below a*b (then the one
    rounding to f32 agrees with the FMA's except on an exact f32 tie)."""
    return (a.double() * b.double() + c.double()).float()


def _hat(tap, u):
    return torch.clamp_min(1.0 - (tap - u).abs(), 0.0)


def rotate_resample_reference(inter_img, r_mat, u0, out_hw, out_dtype=torch.float32):
    """Plain PyTorch stage 2: [B, C, H, W] bf16 -> [B, oh, ow, C] out_dtype,
    with the kernel's arithmetic (module docstring)."""
    b, c, h, w = inter_img.shape
    oh, ow = out_hw
    dev = inter_img.device
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[None, :, None]
    r = r_mat.to(torch.float32)
    u0 = u0.to(torch.float32)
    ux = _fma(r[:, 0, 0, None, None], xs, r[:, 0, 1, None, None] * ys) + u0[:, 0, None, None]
    uy = _fma(r[:, 1, 0, None, None], xs, r[:, 1, 1, None, None] * ys) + u0[:, 1, None, None]
    fx0, fy0 = torch.floor(ux), torch.floor(uy)
    wx = [_hat(fx0 + k, ux).to(torch.bfloat16).float() for k in (0, 1)]
    wy = [_hat(fy0 + k, uy) for k in (0, 1)]
    x0, y0 = fx0.long(), fy0.long()
    planes = inter_img.reshape(b, c, h * w).float()

    def tap(yi, xi):  # [B, C, oh, ow], 0 outside the intermediate
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, oh * ow)
        vals = torch.gather(planes, 2, idx.expand(b, c, oh * ow)).reshape(b, c, oh, ow)
        return vals * valid[:, None].to(torch.float32)

    rows = [tap(y0 + j, x0) * wx[0][:, None] + tap(y0 + j, x0 + 1) * wx[1][:, None]
            for j in (0, 1)]
    out = wy[0][:, None] * rows[0] + wy[1][:, None] * rows[1]
    return out.permute(0, 2, 3, 1).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use), with its C signature."""
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rotate_resample_forward.argtypes = [p] * 3 + [i] * 7 + [p]
    lib.rotate_resample_forward.restype = i
    lib.rotate_resample_crop_forward.argtypes = [p] * 3 + [i] * 8 + [p]
    lib.rotate_resample_crop_forward.restype = i
    return lib


def _rotate_resample_cuda(inter_img, scalars, out_hw, out_dtype):
    b, c, h, w = inter_img.shape
    oh, ow = out_hw
    out = torch.empty((b, oh, ow, c), device=inter_img.device, dtype=out_dtype)
    stream = torch.cuda.current_stream(inter_img.device).cuda_stream
    rc = _lib().rotate_resample_forward(
        inter_img.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, c, h, w, oh, ow,
        int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"rotate_resample_forward failed: cudaError {rc}")
    return out


@counts_launches
def rotate_resample(inter_img, r_mat, u0, out_hw, out_dtype=torch.float32):
    """Stage-2 rotation resample: [B, C, H, W] bf16 -> [B, oh, ow, C] in
    ``out_dtype`` (f32 or bf16; the accumulation is f32 either way).

    :param r_mat: [B, 2, 2] unit-row rotation part of the dst->src affine
    :param u0: [B, 2] offset of the output origin in the intermediate
    CPU tensors take :func:`rotate_resample_reference`; CUDA tensors launch
    the kernel (``rotate_resample.launches`` counts those calls) or raise."""
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes f32 or bf16")
    if inter_img.dtype != torch.bfloat16 or inter_img.dim() != 4:
        raise ValueError(f"inter_img must be a bf16 [B, C, H, W] tensor, got "
                         f"{inter_img.dtype} {tuple(inter_img.shape)}")
    if inter_img.device.type == "cpu":
        return rotate_resample_reference(inter_img, r_mat, u0, out_hw, out_dtype)
    if inter_img.device.type != "cuda":
        raise ValueError(f"rotate_resample runs on cpu or cuda tensors, got {inter_img.device}")
    b = inter_img.shape[0]
    if not 0 < b <= 65535 or min(out_hw) <= 0:
        raise ValueError(f"batch {b} (1..65535) / out_hw {out_hw}")
    scalars = torch.cat([r_mat.reshape(b, 4), u0.reshape(b, 2)], dim=-1)
    scalars = scalars.to(device=inter_img.device, dtype=torch.float32).contiguous()
    out = _rotate_resample_cuda(inter_img.contiguous(), scalars, out_hw, out_dtype)
    rotate_resample.launches += 1
    return out


def affine_crop_two_stage_reference(images, trans, out_hw, inter: int = 328,
                                    out_dtype=torch.float32):
    """Plain PyTorch two-stage crop: stage 1 as two matmuls (ops/warp.py), the
    channel-major bf16 intermediate, then :func:`rotate_resample_reference`.
    Arguments as :func:`affine_crop_two_stage`; ``images`` may be any real
    dtype."""
    d0, d1, r_mat, u0, t1x, t1y = decompose_affine(trans, out_hw, inter)
    inter_img = stage1_resample(images, d0, d1, t1x, t1y, inter)
    inter_img = inter_img.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()  # channel-major
    return rotate_resample_reference(inter_img, r_mat, u0, out_hw, out_dtype)


def crop_scalars(trans, out_hw, inter):
    """[B, 10] f32 per-sample scalars of the crop kernel: d0 d1 t1x t1y r00
    r01 r10 r11 u0x u0y, from ``decompose_affine``."""
    d0, d1, r_mat, u0, t1x, t1y = decompose_affine(trans, out_hw, inter)
    b = r_mat.shape[0]
    return torch.cat([torch.stack([d0, d1, t1x, t1y], dim=-1), r_mat.reshape(b, 4),
                      u0.reshape(b, 2)], dim=-1).to(torch.float32).contiguous()


def _rotate_resample_crop_cuda(images, scalars, out_hw, inter, out_dtype):
    """One launch of the whole-crop kernel on a contiguous uint8 CUDA batch
    and its :func:`crop_scalars` (no checks, no count)."""
    b, h, w, c = images.shape
    oh, ow = out_hw
    out = torch.empty((b, oh, ow, c), device=images.device, dtype=out_dtype)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    rc = _lib().rotate_resample_crop_forward(
        images.data_ptr(), scalars.data_ptr(), out.data_ptr(), b, c, h, w, inter, oh, ow,
        int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"rotate_resample_crop_forward failed: cudaError {rc}")
    return out


@counts_launches
def affine_crop_two_stage(images, trans, out_hw, inter: int = 328, out_dtype=torch.float32):
    """Two-stage batched bilinear affine crop (training augmentation warp).

    Same semantics as ops/warp.affine_crop within the interpolation
    tolerance of two composed resamples; an axis-aligned affine gives a
    single resample (stage 2 is then an exact integer passthrough).

    :param images: [B, H, W, C] uint8 canvases (C <= 4 on the card)
    :param trans: [B, 2, 3] source->dest affines (cv2 convention)
    :param inter: static intermediate edge; hypot(out_h, out_w) <= inter - 4
        (328 covers 256x192 crops under any rotation: hypot = 320)
    :returns: [B, out_h, out_w, C] in out_dtype (f32 or bf16)
    CPU tensors take :func:`affine_crop_two_stage_reference`; CUDA tensors
    launch the whole-crop kernel (``affine_crop_two_stage.launches`` counts
    those calls) or raise.
    """
    oh, ow = out_hw
    if math.hypot(oh, ow) > inter - 4:
        raise ValueError(f"intermediate {inter} too small for a {oh}x{ow} crop")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes f32 or bf16")
    if images.device.type == "cpu":
        return affine_crop_two_stage_reference(images, trans, out_hw, inter, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"affine_crop_two_stage runs on cpu or cuda tensors, got {images.device}")
    if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] > _CROP_MAX_CHANNELS:
        raise ValueError(f"images must be a uint8 [B, H, W, C<={_CROP_MAX_CHANNELS}] tensor, got "
                         f"{images.dtype} {tuple(images.shape)}")
    b = images.shape[0]
    if not 0 < b <= 65535 or min(out_hw) <= 0:
        raise ValueError(f"batch {b} (1..65535) / out_hw {out_hw}")
    scalars = crop_scalars(trans.to(images.device, torch.float32), out_hw, inter)
    out = _rotate_resample_crop_cuda(images.contiguous(), scalars, out_hw, inter, out_dtype)
    affine_crop_two_stage.launches += 1
    return out
