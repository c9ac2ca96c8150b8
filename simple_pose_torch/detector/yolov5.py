"""YOLOv5 person detector (NCHW nn.Module).

Port of simple_pose_tpu/detector/yolov5.py (the reference's
detector/nets/yolov5.py): Focus + CSP backbone, PANet neck, and the anchor
head shared with YOLOv4 (:class:`YOLOHead`), whose decode runs in the
forward: sigmoid; xy = (2s - 0.5 + grid) * stride; wh = (2s)^2 * anchor;
levels concatenated anchor-major, then y, then x -> [B, sum(A), 5 + nc].

Module paths are the reference's state_dict keys (``backbones.layer1.0``,
``neck.c4_fuse``, ``head.heads.0``, ...).  ``dtype`` is the compute dtype,
as for the pose models: parameters stay f32 and the forward runs under
autocast to it; the head decodes in f32 all the same (grid offsets up to 80
times the stride would lose bf16 mantissa).

Seeded init (:func:`init_detector`): convs normal with variance 1/fan_in
(the variance of flax's default lecun normal), biases 0, BN at identity,
and the head's prior bias (:func:`head_bias_init`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simple_pose_torch.detector.blocks import (
    CBR,
    SPP,
    BottleNeckCSP,
    Focus,
    depth_grow,
    model_scale,
    width_grow,
)

__all__ = ["YOLOv5", "YOLOHead", "YOLOV5_DEFAULT_ANCHORS", "YOLOV5_DEFAULT_STRIDES",
           "head_bias_init", "init_detector", "upsample2"]

YOLOV5_DEFAULT_ANCHORS = (
    (10, 13, 16, 30, 33, 23),
    (30, 61, 62, 45, 59, 119),
    (116, 90, 156, 198, 373, 326),
)
YOLOV5_DEFAULT_STRIDES = (8.0, 16.0, 32.0)


def head_bias_init(num_cls, anchor_per_grid, stride) -> np.ndarray:
    """Prior bias: ~8 objects per 640px image, 0.6 class prior
    (yolov5.py:129-133).  [anchor_per_grid * (num_cls + 5)] f32."""
    b = np.zeros((anchor_per_grid, num_cls + 5), dtype=np.float32)
    b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
    if num_cls > 1:
        b[:, 5:] += math.log(0.6 / (num_cls - 0.99))
    return b.reshape(-1)


def upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv5Backbone(nn.Module):
    def __init__(self, depth: float = 0.33, width: float = 0.50):
        super().__init__()
        w = lambda c: width_grow(c, width)  # noqa: E731
        d = lambda n: depth_grow(n, depth)  # noqa: E731
        self.stem = Focus(3, w(64), 3)
        self.layer1 = nn.Sequential(CBR(w(64), w(128), 3, 2), BottleNeckCSP(w(128), w(128), d(3)))
        self.layer2 = nn.Sequential(CBR(w(128), w(256), 3, 2),
                                    BottleNeckCSP(w(256), w(256), d(9)))
        self.layer3 = nn.Sequential(CBR(w(256), w(512), 3, 2),
                                    BottleNeckCSP(w(512), w(512), d(9)))
        self.layer4 = nn.Sequential(CBR(w(512), w(1024), 3, 2),
                                    SPP(w(1024), w(1024), (5, 9, 13)),
                                    BottleNeckCSP(w(1024), w(1024), d(3), shortcut=False))

    def forward(self, x):
        c3 = self.layer2(self.layer1(self.stem(x)))
        c4 = self.layer3(c3)
        return [c3, c4, self.layer4(c4)]


class YOLOv5Neck(nn.Module):
    """PANet: top-down nearest-upsample fusion, then bottom-up strided
    re-fusion (yolov5.py:80-104)."""

    def __init__(self, c3: int, c4: int, c5: int, blocks: int = 1):
        super().__init__()
        self.latent_c5 = CBR(c5, c4, 1, 1)
        self.c4_fuse = BottleNeckCSP(2 * c4, c4, blocks, shortcut=False)
        self.latent_c4 = CBR(c4, c3, 1, 1)
        self.c3_out = BottleNeckCSP(2 * c3, c3, blocks, shortcut=False)
        self.c3_c4 = CBR(c3, c3, 3, 2)
        self.c4_out = BottleNeckCSP(2 * c3, c4, blocks, shortcut=False)
        self.c4_c5 = CBR(c4, c4, 3, 2)
        self.c5_out = BottleNeckCSP(2 * c4, c5, blocks, shortcut=False)

    def forward(self, xs):
        c3, c4, c5 = xs
        latent_c5 = self.latent_c5(c5)
        c4_fuse = self.c4_fuse(torch.cat([upsample2(latent_c5), c4], dim=1))
        latent_c4 = self.latent_c4(c4_fuse)
        c3_out = self.c3_out(torch.cat([upsample2(latent_c4), c3], dim=1))
        c4_out = self.c4_out(torch.cat([self.c3_c4(c3_out), latent_c4], dim=1))
        c5_out = self.c5_out(torch.cat([self.c4_c5(c4_out), latent_c5], dim=1))
        return [c3_out, c4_out, c5_out]


class YOLOHead(nn.Module):
    """Shared v4/v5 anchor head with the decode in the forward
    (yolov5.py:107-156).  With ``decode=False``, or in training mode, it
    returns the raw per-level maps [B, apg, ny, nx, 5 + nc] and the anchors
    in stride units."""

    def __init__(self, channels: Sequence[int], num_cls: int = 80,
                 anchors: Sequence[Sequence[float]] = YOLOV5_DEFAULT_ANCHORS,
                 strides: Sequence[float] = YOLOV5_DEFAULT_STRIDES, decode: bool = True):
        super().__init__()
        self.num_out = num_cls + 5
        self.apg = len(anchors[0]) // 2
        self.num_cls = num_cls
        self.strides = tuple(float(s) for s in strides)
        self.decode = decode
        self.register_buffer("anchors", torch.tensor(anchors, dtype=torch.float32)
                             .reshape(len(anchors), self.apg, 2), persistent=False)
        self.heads = nn.ModuleList([nn.Conv2d(c, self.num_out * self.apg, 1, bias=True)
                                    for c in channels])

    def forward(self, xs):
        raw = []
        for head, x in zip(self.heads, xs):
            y = head(x)  # [B, apg*out, ny, nx]; channel = anchor * out + field
            b, _, ny, nx = y.shape
            raw.append(y.view(b, self.apg, self.num_out, ny, nx).permute(0, 1, 3, 4, 2))
        if not self.decode or self.training:
            strides = torch.tensor(self.strides, device=self.anchors.device)
            return raw, self.anchors / strides[:, None, None]
        with torch.autocast(device_type=raw[0].device.type, enabled=False):
            outs = []
            for i, y in enumerate(raw):
                b, _, ny, nx, _ = y.shape
                s = torch.sigmoid(y.float())
                gx = torch.arange(nx, dtype=torch.float32, device=s.device)[None, None, None, :]
                gy = torch.arange(ny, dtype=torch.float32, device=s.device)[None, None, :, None]
                stride = self.strides[i]
                xy = torch.stack([(s[..., 0] * 2.0 - 0.5 + gx) * stride,
                                  (s[..., 1] * 2.0 - 0.5 + gy) * stride], dim=-1)
                wh = (s[..., 2:4] * 2.0) ** 2 * self.anchors[i].view(1, self.apg, 1, 1, 2)
                outs.append(torch.cat([xy, wh, s[..., 4:]], dim=-1).reshape(b, -1, self.num_out))
            return torch.cat(outs, dim=1)


@torch.no_grad()
def init_detector(model: nn.Module):
    """Seeded init in place (see the module docstring); returns ``model``."""
    g = torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    for m in model.modules():
        if isinstance(m, YOLOHead):
            for head, stride in zip(m.heads, m.strides):
                head.bias.copy_(torch.from_numpy(head_bias_init(m.num_cls, m.apg, stride)))
    return model


class _Detector(nn.Module):
    """Backbone -> neck -> head under the compute dtype's autocast."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x):
        amp = (torch.autocast(device_type=x.device.type, dtype=self.dtype)
               if self.dtype is not None else contextlib.nullcontext())
        with amp:
            return self.head(self.neck(self.backbones(x)))


class YOLOv5(_Detector):
    """Input NCHW RGB in [0, 1]; output [B, N, 5 + num_cls] decoded boxes
    (xywh in input pixels, obj, class scores), or the raw maps with
    ``decode=False``."""

    def __init__(self, num_cls: int = 80, scale_name: str = "s",
                 anchors=YOLOV5_DEFAULT_ANCHORS, strides=YOLOV5_DEFAULT_STRIDES,
                 decode: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        depth, width = model_scale(scale_name)
        c3, c4, c5 = (width_grow(c, width) for c in (256, 512, 1024))
        self.dtype = dtype
        self.backbones = YOLOv5Backbone(depth, width)
        self.neck = YOLOv5Neck(c3, c4, c5, depth_grow(3, depth))
        self.head = YOLOHead((c3, c4, c5), num_cls, anchors, strides, decode)
        init_detector(self)
