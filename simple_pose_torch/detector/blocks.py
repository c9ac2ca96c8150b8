"""Detector building blocks (NCHW nn.Modules).

Port of simple_pose_tpu/detector/blocks.py (the reference's
detector/nets/commons.py and activations.py).  Attribute names are the
reference's torch module paths (``CBR.conv``/``.bn``, ``BottleNeckCSP.
conv1_0``, ``conv1_s`` as a Sequential, ``conv1_n``, ``conv2_0``, ``bn``,
``conv3``, ...), so a reference checkpoint loads with ``load_state_dict``;
the JAX package's flax scopes are the same paths with each Sequential index
folded into its parent's name (``conv1_s.0`` -> ``conv1_s_0``).

Unlike flax, a torch module needs its input width, so every constructor
takes ``(cin, cout, ...)`` where the flax module takes ``features``.

Activations: Hardswish (x * relu6(x + 3) / 6), Mish (x * tanh(softplus(x))),
Swish/SiLU, FReLU.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from simple_pose_torch.models.layers import batch_norm

__all__ = [
    "model_scale", "width_grow", "depth_grow",
    "hardswish", "mish", "swish", "CBR", "Focus", "BottleNeck",
    "BottleNeckCSP", "BottleNeckCSP2", "SPP", "SPPCSP", "FReLU",
]


def model_scale(name: str = "s"):
    """(depth multiple, width multiple) of a scale name."""
    scales = {"s": (0.33, 0.50), "m": (0.67, 0.75), "l": (1.00, 1.00), "x": (1.33, 1.25)}
    if name not in scales:
        raise NotImplementedError("scale_name only support s,m,l,x")
    return scales[name]


def make_divisible(x, divisor):
    return math.ceil(x / divisor) * divisor


def depth_grow(x: int, depth_multiples: float):
    return max(round(x * depth_multiples), 1) if x > 1 else x


def width_grow(x, width_multiples):
    return make_divisible(x * width_multiples, 8)


def hardswish(x):
    return F.hardswish(x)


def mish(x):
    return F.mish(x)


def swish(x):
    return F.silu(x)


def _conv(cin, cout, k, s=1, p=None, groups=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=s, padding=(k - 1) // 2 if p is None else p,
                     groups=groups, bias=bias)


class CBR(nn.Module):
    """Conv-BN-activation (detector/nets/commons.py:32-48); padding -1 is
    'same' for odd kernels."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = -1, groups: int = 1, act: Callable = hardswish):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, None if padding < 0 else padding, groups)
        self.bn = batch_norm(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class Focus(nn.Module):
    """Space-to-depth stem: the four pixel phases along channels, then a CBR
    (detector/nets/commons.py:51-59).  Phase order (row, column):
    (0,0), (1,0), (0,1), (1,1)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, act: Callable = hardswish):
        super().__init__()
        self.conv = CBR(4 * cin, cout, kernel, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1))


class BottleNeck(nn.Module):
    """1x1 CBR then 3x3 CBR.  The residual add needs ``shortcut``, an inner
    width equal to ``cout`` (expansion 1) and ``cin == cout``, as in the JAX
    package (blocks.py:130-132)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True, groups: int = 1,
                 expansion: float = 0.5, act: Callable = hardswish):
        super().__init__()
        inner = int(cout * expansion)
        self.conv1 = CBR(cin, inner, 1, 1, act=act)
        self.conv2 = CBR(inner, cout, 3, 1, groups=groups, act=act)
        self.add = shortcut and inner == cout and cin == cout

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return x + out if self.add else out


class BottleNeckCSP(nn.Module):
    """(detector/nets/commons.py:80-98)"""

    def __init__(self, cin: int, cout: int, blocks: int = 1, shortcut: bool = True,
                 groups: int = 1, expansion: float = 0.5, act: Callable = hardswish):
        super().__init__()
        inner = int(cout * expansion)
        self.act = act
        self.conv1_0 = CBR(cin, inner, 1, 1, act=act)
        self.conv1_s = nn.Sequential(*[BottleNeck(inner, inner, shortcut, groups, 1.0, act)
                                       for _ in range(blocks)])
        self.conv1_n = _conv(inner, inner, 1)
        self.conv2_0 = _conv(cin, inner, 1)
        self.bn = batch_norm(2 * inner)
        self.conv3 = CBR(2 * inner, cout, 1, 1, act=act)

    def forward(self, x):
        y1 = self.conv1_n(self.conv1_s(self.conv1_0(x)))
        y2 = self.conv2_0(x)
        return self.conv3(self.act(self.bn(torch.cat([y1, y2], dim=1))))


class BottleNeckCSP2(nn.Module):
    """(detector/nets/commons.py:102-120)"""

    def __init__(self, cin: int, cout: int, blocks: int = 1, shortcut: bool = False,
                 groups: int = 1, expansion: float = 0.5, act: Callable = hardswish):
        super().__init__()
        inner = int(cout * expansion)
        self.act = act
        self.conv0 = CBR(cin, inner, 1, 1, act=act)
        self.conv1 = nn.Sequential(*[BottleNeck(inner, inner, shortcut, groups, 1.0, act)
                                     for _ in range(blocks)])
        self.conv2 = _conv(inner, inner, 1)
        self.bn = batch_norm(2 * inner)
        self.conv3 = CBR(2 * inner, cout, 1, 1, act=act)

    def forward(self, x):
        x1 = self.conv0(x)
        y = torch.cat([self.conv1(x1), self.conv2(x1)], dim=1)
        return self.conv3(self.act(self.bn(y)))


def _pools(x, kernels):
    """``x`` and its stride-1 'same' max pools (padding reads -inf)."""
    return torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in kernels], dim=1)


class SPP(nn.Module):
    """(detector/nets/commons.py:124-136)"""

    def __init__(self, cin: int, cout: int, kernels: Sequence[int] = (5, 9, 13),
                 act: Callable = hardswish):
        super().__init__()
        inner = cin // 2
        self.kernels = tuple(kernels)
        self.conv1 = CBR(cin, inner, 1, 1, act=act)
        self.conv2 = CBR(inner * (len(self.kernels) + 1), cout, 1, 1, act=act)

    def forward(self, x):
        return self.conv2(_pools(self.conv1(x), self.kernels))


class SPPCSP(nn.Module):
    """(detector/nets/commons.py:140-162)"""

    def __init__(self, cin: int, cout: int, expansion: float = 0.5,
                 kernels: Sequence[int] = (5, 9, 13), act: Callable = hardswish):
        super().__init__()
        inner = int(2 * cout * expansion)
        self.act = act
        self.kernels = tuple(kernels)
        self.conv1_start_0 = CBR(cin, inner, 1, 1, act=act)
        self.conv1_start_1 = CBR(inner, inner, 3, 1, act=act)
        self.conv1_start_2 = CBR(inner, inner, 1, 1, act=act)
        self.conv1_end_0 = CBR(inner * (len(self.kernels) + 1), inner, 1, 1, act=act)
        self.conv1_end_1 = CBR(inner, inner, 3, 1, act=act)
        self.conv2 = _conv(cin, inner, 1)
        self.bn = batch_norm(2 * inner)
        self.conv3 = CBR(2 * inner, cout, 1, 1, act=act)

    def forward(self, x):
        x1 = self.conv1_start_2(self.conv1_start_1(self.conv1_start_0(x)))
        y1 = self.conv1_end_1(self.conv1_end_0(_pools(x1, self.kernels)))
        y = torch.cat([y1, self.conv2(x)], dim=1)
        return self.conv3(self.act(self.bn(y)))


class FReLU(nn.Module):
    """Funnel activation: max(x, BN(depthwise 3x3 conv(x)))
    (detector/nets/activations.py)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels, 3, 1, 1, groups=channels)
        self.bn = batch_norm(channels)

    def forward(self, x):
        return torch.maximum(x, self.bn(self.conv(x)))
