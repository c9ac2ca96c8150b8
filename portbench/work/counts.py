"""Operations and bytes that the measured work needs, from shapes and the
benchmark's own inputs, never from the program's prepared state.

  * ``forward_flops``: the model FLOPs of one crop's forward, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on the plain model of the
    configuration, on the meta device at batch 1 (2 FLOPs a multiply-add of
    every conv and transposed conv; BatchNorm, activations and adds are not
    counted).
  * ``chain_least_s``: the least time of one call of the fused layer1 chain
    (the program's K2) at a batch: the larger of its FLOPs over the bf16
    peak and its bytes over the HBM bandwidth.  Rule (copied from the
    port's ``chip_smoke.chain_work``, counted here from layer1's shapes):
    per output pixel of each Bottleneck, the multiply-adds of conv1 (cin x
    width), the 3x3 conv2 (9 x width^2), conv3 (width x cout) and the
    projection (cin x cout) where the block has one, plus the SE gate's two
    cout x cout products a sample; bytes: each folded weight once (the
    products' matrices in bf16, the biases in float32), layer1's input and
    output once in bf16.
  * ``crop_least_s``: the least time of one call of the training crop
    kernel: the bytes its taps touch over the HBM bandwidth, or its FLOPs
    over the float32 peak, whichever is larger.  Rule (copied from the
    port's ``chip_smoke.crop_work``, with the two-stage decomposition worked
    out again in reference/ops.decompose): the crop runs as an axis-aligned resample into a
    ``inter`` x ``inter`` intermediate (inter = ceil(hypot(out)) + 8), then
    a rotation resample of it; bytes are each canvas pixel that a stage-1
    tap of an intermediate pixel read by stage 2 touches (uint8, read once),
    the output (bf16) written once and 10 float32 scalars a crop; FLOPs are
    10 + 9 c an intermediate pixel read and 18 + 9 c an output pixel.
"""

from __future__ import annotations

import json
import math
import os

import torch

from portbench.reference.models import Bottleneck
from portbench.reference.ops import decompose
from portbench.weights import plain_model

__all__ = ["peaks", "forward_flops", "chain_work", "chain_least_s", "crop_work",
           "crop_least_s"]


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        return json.load(f)


def forward_flops(model_cfg: dict, input_hw) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    model = plain_model(model_cfg).eval()
    x = torch.empty((1, 3, *input_hw), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return int(counter.get_total_flops())


def _layer1(model_cfg, input_hw):
    """(layer1's Bottleneck modules, its input's (h, w))."""
    model = plain_model(model_cfg).eval()
    seen = {}

    def record(_, args):
        seen["hw"] = args[0].shape[2:]

    model.layer1.register_forward_pre_hook(record)
    with torch.no_grad():
        model(torch.empty((1, 3, *input_hw), device="meta"))
    return [b for b in model.layer1 if isinstance(b, Bottleneck)], tuple(seen["hw"])


def chain_work(model_cfg: dict, input_hw, batch: int) -> tuple:
    """(FLOPs, bytes) of one layer1 chain call at ``batch``."""
    blocks, (h, w) = _layer1(model_cfg, input_hw)
    flops, wbytes = 0, 0
    for b in blocks:
        cin, width = b.conv1.weight.shape[1], b.conv1.weight.shape[0]
        cout = b.conv3.weight.shape[0]
        macs = h * w * (cin * width + 9 * width * width + width * cout
                        + (cin * cout if b.downsample is not None else 0))
        mats = cin * width + 9 * width * width + width * cout
        biases = 2 * width + cout
        if b.downsample is not None:
            mats += cin * cout
            biases += cout
        if b.se is not None:
            macs += 2 * cout * cout
            mats += 2 * cout * cout
            biases += 2 * cout
        flops += 2 * batch * macs
        wbytes += 2 * mats + 4 * biases
    cin0, cout = blocks[0].conv1.weight.shape[1], blocks[-1].conv3.weight.shape[0]
    return flops, wbytes + batch * (cin0 + cout) * h * w * 2


def chain_least_s(model_cfg: dict, input_hw, batch: int) -> float:
    flops, nbytes = chain_work(model_cfg, input_hw, batch)
    p = peaks()
    return max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])


def crop_work(canvas_hw, channels: int, trans, out_hw=(256, 192), out_bytes=2) -> tuple:
    """(FLOPs, bytes) of one crop call over ``trans`` [B, 2, 3] on canvases
    of ``canvas_hw``."""
    h, w = canvas_hw
    c = channels
    oh, ow = out_hw
    inter = int(math.ceil(math.hypot(oh, ow))) + 8
    b = trans.shape[0]
    dev = trans.device
    d0, d1, r, u0, t1x, t1y = decompose(trans, out_hw, inter)
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                            torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
    ux = r[:, 0, 0, None, None] * xs + r[:, 0, 1, None, None] * ys + u0[:, 0, None, None]
    uy = r[:, 1, 0, None, None] * xs + r[:, 1, 1, None, None] * ys + u0[:, 1, None, None]
    x0, y0 = torch.floor(ux).long(), torch.floor(uy).long()
    read = torch.zeros((b, inter, inter), dtype=torch.bool, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None].expand(b, oh, ow)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < inter) & (yi >= 0) & (yi < inter)
            read[bi[ok], yi[ok], xi[ok]] = True
    o = torch.arange(inter, dtype=torch.float32, device=dev)[None, :]
    py0 = torch.floor(t1y[:, None] + o * d1[:, None]).long()
    px0 = torch.floor(t1x[:, None] + o * d0[:, None]).long()
    sb, siy, six = read.nonzero(as_tuple=True)
    touched = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = py0[sb, siy] + dy, px0[sb, six] + dx
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            touched[sb[ok], yi[ok], xi[ok]] = True
    flops = sb.numel() * (10 + 9 * c) + b * oh * ow * (18 + 9 * c)
    nbytes = int(touched.sum()) * c + b * oh * ow * c * out_bytes + b * 10 * 4
    return flops, nbytes


def crop_least_s(canvas_hw, channels, trans, out_hw=(256, 192)) -> float:
    flops, nbytes = crop_work(canvas_hw, channels, trans, out_hw)
    p = peaks()
    return max(flops / p["f32_flops_per_s"], nbytes / p["hbm_bytes_per_s"])
