"""The exact int32 product of the W8A8 conv (models/quant.py).

The JAX package computes it in XLA (``lax.conv_general_dilated`` with
``preferred_element_type=int32``, models/quant.py:67-75), not in a Pallas
kernel.  PyTorch has no int8 convolution that accumulates in int32
(``F.conv2d`` on int8 returns int8: the sum wraps), so the port has two
routes, both exact:

  * CPU tensors: :func:`int8_conv_reference`, ``F.conv2d`` in float64 on the
    int8 values (every partial sum is an integer below 2^53), the plain
    version;
  * CUDA tensors: int8 tensor cores through ``torch._int_mm`` over the
    conv's patches (NHWC, columns (dy, dx, c)), k and n zero-padded to
    multiples of 8 and m to more than 16; grouped convs one product per
    group; depthwise convs (one channel per group) an int32 tap sum.
    Nothing falls back to the float conv: a shape the route cannot take
    raises.

:func:`int8_conv` calls the registered op ``simple_pose::int8_conv``, which
picks its route from its inputs' device when it runs, with a fake
implementation for the trace: a ``torch.export`` program made on the CPU and
moved to the card (evalkit/export.load_exported) runs the card's route.
Both routes return the int32 NCHW product in channels-last memory.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from simple_pose_torch.utils.cuda_build import counts_launches

__all__ = ["int8_conv", "int8_conv_reference"]


def int8_conv_reference(x8, w8, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    """The plain version: int32 NCHW conv of int8 NCHW ``x8`` and OIHW
    ``w8``, exact (float64 sums of integers below 2^53; cuDNN off so no
    Winograd or FFT algorithm is picked)."""
    with torch.autocast(device_type=x8.device.type, enabled=False), \
            torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(x8.double(), w8.double(), None, stride, padding, dilation, groups)
    return y.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _out_hw(h, w, kh, kw, stride, padding, dilation):
    return ((h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1,
            (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1)


def _patches(x8, kh, kw, stride, padding, dilation):
    """int8 NCHW -> ([N*Ho*Wo, kh*kw*C] rows (n, oy, ox), columns (dy, dx, c);
    Ho, Wo)."""
    ph, pw = padding
    sy, sx = stride
    dy, dx = dilation
    n, c, h, w = x8.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding, dilation)
    x = F.pad(x8, (pw, pw, ph, ph)).permute(0, 2, 3, 1)  # NHWC view
    taps = [x[:, i * dy:i * dy + (ho - 1) * sy + 1:sy, j * dx:j * dx + (wo - 1) * sx + 1:sx]
            for i in range(kh) for j in range(kw)]
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(n * ho * wo, kh * kw * c), ho, wo


def _int_mm_padded(a, wmat):
    """int32 [m, n] = int8 a [m, k] @ int8 wmat[n, k]^T on tensor cores.
    k and n are padded with zero columns to multiples of 8, m with zero rows
    to more than 16 (torch._int_mm's shape rules); the padding adds 0."""
    m, k = a.shape
    n = wmat.shape[0]
    kp, np_, mp = _round_up(k, 8), _round_up(n, 8), max(m, 32) if m <= 16 else m
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        wmat = F.pad(wmat, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a, wmat.t())
    return y[:m, :n] if (mp != m or np_ != n) else y


def _depthwise_taps(x8, w8, stride, padding, dilation):
    """int32 tap sum of a depthwise conv (one input and one output channel
    per group): exact, on CUDA cores (a product per channel has k = kh*kw
    and n = 1, below the tensor cores' tile)."""
    ph, pw = padding
    sy, sx = stride
    dy, dx = dilation
    kh, kw = w8.shape[2:]
    ho, wo = _out_hw(x8.shape[2], x8.shape[3], kh, kw, stride, padding, dilation)
    x = F.pad(x8, (pw, pw, ph, ph)).to(torch.int32)
    w = w8.to(torch.int32)
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = x[:, :, i * dy:i * dy + (ho - 1) * sy + 1:sy,
                    j * dx:j * dx + (wo - 1) * sx + 1:sx] * w[None, :, 0, i, j, None, None]
            acc = tap if acc is None else acc + tap
    return acc


def _int8_conv_cuda(x8, w8, stride, padding, dilation, groups):
    """int32 NCHW conv on int8 tensor cores (see the module docstring);
    raises on what the route cannot take."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 or x8.dim() != 4 or w8.dim() != 4:
        raise ValueError(f"int8_conv takes int8 NCHW x and OIHW w, got {x8.dtype} "
                         f"{tuple(x8.shape)} / {w8.dtype} {tuple(w8.shape)}")
    cout, cin_g, kh, kw = w8.shape
    if x8.shape[1] != cin_g * groups or cout % groups:
        raise ValueError(f"channels: x {x8.shape[1]}, w {tuple(w8.shape)}, groups {groups}")
    if groups > 1 and cin_g == 1 and cout == groups:
        return _depthwise_taps(x8, w8, stride, padding, dilation)
    n = x8.shape[0]
    og = cout // groups
    ys = []
    for g in range(groups):
        xg = x8 if groups == 1 else x8[:, g * cin_g:(g + 1) * cin_g]
        cols, ho, wo = _patches(xg, kh, kw, stride, padding, dilation)
        wmat = w8[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, kh * kw * cin_g)
        ys.append(_int_mm_padded(cols, wmat))
    y = ys[0] if groups == 1 else torch.cat(ys, dim=1)
    return y.view(n, ho, wo, cout).permute(0, 3, 1, 2)


@torch.library.custom_op("simple_pose::int8_conv", mutates_args=())
def _int8_conv_op(x8: torch.Tensor, w8: torch.Tensor, stride: List[int], padding: List[int],
                  dilation: List[int], groups: int) -> torch.Tensor:
    """The registered op that :func:`int8_conv` calls (importing this module
    registers it): the route is chosen here, when the op runs."""
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    if x8.device.type == "cpu":
        y = int8_conv_reference(x8, w8, stride, padding, dilation, groups)
    elif x8.device.type == "cuda":
        y = _int8_conv_cuda(x8, w8, stride, padding, dilation, groups)
        int8_conv.launches += 1
    else:
        raise ValueError(f"int8_conv runs on cpu or cuda tensors, got {x8.device}")
    return y.contiguous(memory_format=torch.channels_last)


@_int8_conv_op.register_fake
def _int8_conv_fake(x8, w8, stride, padding, dilation, groups):
    ho, wo = _out_hw(x8.shape[2], x8.shape[3], w8.shape[2], w8.shape[3], stride, padding,
                     dilation)
    return x8.new_empty((x8.shape[0], w8.shape[0], ho, wo), dtype=torch.int32).contiguous(
        memory_format=torch.channels_last)


@counts_launches("int8_conv")
def int8_conv(x8, w8, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    """Exact int32 conv of int8 NCHW ``x8`` and OIHW ``w8`` through the
    registered op ``torch.ops.simple_pose.int8_conv``: CPU tensors take
    :func:`int8_conv_reference`; CUDA tensors the int8 tensor-core route
    (``int8_conv.launches`` counts those calls, eager or from a loaded
    ``torch.export`` program), or it raises."""
    return torch.ops.simple_pose.int8_conv(x8, w8, list(stride), list(padding),
                                           list(dilation), int(groups))
