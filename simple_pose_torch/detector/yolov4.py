"""YOLOv4 detector (NCHW nn.Module).

Port of simple_pose_tpu/detector/yolov4.py (the reference's
detector/nets/yolov4.py): a Mish-activated CSPDarknet backbone, an SPPCSP +
BottleNeckCSP2 PAN neck, and YOLOv5's anchor head and decode
(detector/yolov5.YOLOHead).  Module paths are the reference's state_dict
keys; ``dtype`` and the seeded init as in detector/yolov5.py.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from simple_pose_torch.detector.blocks import (
    CBR,
    SPPCSP,
    BottleNeck,
    BottleNeckCSP,
    BottleNeckCSP2,
    depth_grow,
    mish,
    model_scale,
    width_grow,
)
from simple_pose_torch.detector.yolov5 import YOLOHead, _Detector, init_detector, upsample2

__all__ = ["YOLOv4", "YOLOV4_DEFAULT_ANCHORS", "YOLOV4_DEFAULT_STRIDES"]

YOLOV4_DEFAULT_ANCHORS = (
    (12, 16, 19, 36, 40, 28),
    (36, 75, 76, 55, 72, 146),
    (142, 110, 192, 243, 459, 401),
)
YOLOV4_DEFAULT_STRIDES = (8.0, 16.0, 32.0)


def _cbr(cin, cout, k=1, s=1):
    return CBR(cin, cout, k, s, act=mish)


def _csp2(cin, cout, blocks):
    return BottleNeckCSP2(cin, cout, blocks, act=mish, expansion=1.0)


class YOLOv4Backbone(nn.Module):
    def __init__(self, depth: float = 0.33, width: float = 0.50):
        super().__init__()
        w = lambda c: width_grow(c, width)  # noqa: E731
        d = lambda n: depth_grow(n, depth)  # noqa: E731
        self.layer1 = nn.Sequential(_cbr(3, w(32), 3, 1), _cbr(w(32), w(64), 3, 2),
                                    BottleNeck(w(64), w(64), act=mish))
        self.layer2 = nn.Sequential(_cbr(w(64), w(128), 3, 2),
                                    BottleNeckCSP(w(128), w(128), d(2), act=mish))
        self.layer3 = nn.Sequential(_cbr(w(128), w(256), 3, 2),
                                    BottleNeckCSP(w(256), w(256), d(8), act=mish))
        self.layer4 = nn.Sequential(_cbr(w(256), w(512), 3, 2),
                                    BottleNeckCSP(w(512), w(512), d(8), act=mish))
        self.layer5 = nn.Sequential(_cbr(w(512), w(1024), 3, 2),
                                    BottleNeckCSP(w(1024), w(1024), d(4), act=mish))

    def forward(self, x):
        c3 = self.layer3(self.layer2(self.layer1(x)))
        c4 = self.layer4(c3)
        return [c3, c4, self.layer5(c4)]


class YOLOv4Neck(nn.Module):
    """(detector/nets/yolov4.py:56-93)"""

    def __init__(self, c2: int, c3: int, c4: int, c5: int, blocks: int = 1):
        super().__init__()
        self.sppcsp = SPPCSP(c5, c4, act=mish)
        self.c4_to_f4 = _cbr(c4, c3)
        self.c5_latent = _cbr(c4, c3)
        self.f4 = _csp2(2 * c3, c3, blocks)
        self.c3_to_f3 = _cbr(c3, c2)
        self.f4_latent = _cbr(c3, c2)
        self.f3 = _csp2(2 * c2, c2, blocks)
        self.f3_out = _cbr(c2, c3, 3, 1)
        self.f3_to_f4 = _cbr(c2, c3, 3, 2)
        self.f4_2 = _csp2(2 * c3, c3, blocks)
        self.f4_out = _cbr(c3, c4, 3, 1)
        self.f4_to_f5 = _cbr(c3, c4, 3, 2)
        self.f5 = _csp2(2 * c4, c4, blocks)
        self.f5_out = _cbr(c4, c5, 3, 1)

    def forward(self, xs):
        c3, c4, c5 = xs
        sppcsp = self.sppcsp(c5)
        f4 = self.f4(torch.cat([self.c4_to_f4(c4), upsample2(self.c5_latent(sppcsp))], dim=1))
        f3 = self.f3(torch.cat([self.c3_to_f3(c3), upsample2(self.f4_latent(f4))], dim=1))
        f4_2 = self.f4_2(torch.cat([self.f3_to_f4(f3), f4], dim=1))
        f5 = self.f5(torch.cat([self.f4_to_f5(f4_2), sppcsp], dim=1))
        return [self.f3_out(f3), self.f4_out(f4_2), self.f5_out(f5)]


class YOLOv4(_Detector):
    """Input NCHW RGB in [0, 1]; output as :class:`~.yolov5.YOLOv5`."""

    def __init__(self, num_cls: int = 80, scale_name: str = "s",
                 anchors=YOLOV4_DEFAULT_ANCHORS, strides=YOLOV4_DEFAULT_STRIDES,
                 decode: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        depth, width = model_scale(scale_name)
        c2, c3, c4, c5 = (width_grow(c, width) for c in (128, 256, 512, 1024))
        self.dtype = dtype
        self.backbones = YOLOv4Backbone(depth, width)
        self.neck = YOLOv4Neck(c2, c3, c4, c5, depth_grow(2, depth))
        self.head = YOLOHead((c3, c4, c5), num_cls, anchors, strides, decode)
        init_detector(self)
