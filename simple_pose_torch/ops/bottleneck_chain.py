"""Fused eval-mode Bottleneck chain (the fused layer1 path).

Port of simple_pose_tpu/ops/pallas_bottleneck.py.  At eval time BatchNorm is
a per-channel affine, so a chain of Bottleneck blocks folds into pure
(matmul, bias, relu) ops.  On a CUDA tensor :func:`bottleneck_chain` runs the
hand-written Hopper kernel ``csrc/bottleneck_chain.cu``: every product on
``wgmma`` with the weights streamed by TMA, 64 channels wide at Bottleneck
widths up to 64 and 128 at widths 65-128; a bf16 ``compute_dtype`` as bf16
products, f32 as three TF32 products each (3xTF32, on the weights that
:func:`prepare_blocks` splits and packs with :func:`pack_tf32`).  A block
without SE is one launch.  An SE block
is three: the block kernel's sums pass (m2's per-tile channel sums), the
gate (their mean through conv3, the fcs and the sigmoid:
:func:`se_gate_from_sums_reference` is its plain twin), then the block
kernel's full pass, which applies the gate in its epilogue.  On a CPU
tensor it runs :func:`bottleneck_chain_reference`, the plain PyTorch
version of the same math.  There is no fallback: a CUDA tensor reaches the
kernel or raises.  The call goes through a registered op
(``simple_pose::bottleneck_chain``) with a fake implementation, so
``torch.export`` traces an evaluator with the fused layer1 and the loaded
program launches the same kernel.

Replaces ``_chain_kernel`` (pallas_bottleneck.py:88, math in ``_block_math``
:48-85).  What bounds it on the card, and what the design does about it, is
in the kernel source's header.

Parity points held by both versions (the reference math):
  * the 3x3's zero pad comes AFTER the ReLU: halo pixels are 0, not relu(b1);
  * the chain carries f32 between blocks; only the chain output is cast to
    the input's dtype;
  * x, m1, m2, the SE mean and the SE hidden layer are rounded to the compute
    dtype as matmul operands, as is every weight with ndim > 1; biases,
    accumulators, the SE mean itself and the sigmoid stay f32;
  * ``compute_dtype`` is explicit (the model's amp setting), never autocast's.

Folded blocks are dicts in the JAX package's layout: w1 [Cin, width], w2
[3, 3, width, width], w3 [width, Cout], optional wd [Cin, Cout], SE fcs sf1
[Cout, hidden], sf2 [hidden, Cout]; biases 1-D; prepared for f32 compute
also the packs w1p, w2p, w3p, wdp (:func:`pack_tf32`).  Activations are
NCHW.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from simple_pose_torch.utils.cuda_build import counts_launches, load_library

__all__ = ["fold_conv_bn", "fold_bottleneck_blocks", "bottleneck_chain_reference",
           "bottleneck_chain", "prepare_blocks", "launch_plan", "LaunchPlan",
           "se_gate_from_sums_reference", "k2_launch_kind", "tf32_round", "tf32_split",
           "pack_tf32", "FOLDED_KEYS"]

_MATRIX_KEYS = ("w1", "w2", "w3", "wd", "sf1", "sf2")
# the weights of the products and the keys of their packs for the f32 instances
_PACKED = {"w1": "w1p", "w2": "w2p", "w3": "w3p", "wd": "wdp"}


def fold_conv_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold an inference BatchNorm into the preceding (bias-free) conv.

    kernel: [..., Cin, Cout] (output channels last); returns (kernel', bias')
    with BN(conv(x, k)) == conv(x, k') + b'."""
    inv = scale / torch.sqrt(var + eps)
    return kernel * inv, bias - mean * inv


def _fold(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    w = conv.weight.detach().float().permute(2, 3, 1, 0)  # OIHW -> HWIO
    return fold_conv_bn(w, bn.weight.detach().float(), bn.bias.detach().float(),
                        bn.running_mean.float(), bn.running_var.float(), bn.eps)


@torch.no_grad()
def fold_bottleneck_blocks(blocks: Sequence[torch.nn.Module]) -> list:
    """Fold eval-mode Bottleneck modules (models/resnet.Bottleneck: conv1/bn1,
    conv2/bn2, conv3/bn3, optional se.fc and downsample) into the dicts
    :func:`bottleneck_chain` consumes, from the modules' BN buffers."""
    out = []
    for blk in blocks:
        d = {}
        for i, (wk, bk) in enumerate((("w1", "b1"), ("w2", "b2"), ("w3", "b3")), 1):
            w, b = _fold(getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}"))
            d[wk] = w[0, 0] if i != 2 else w  # 1x1 convs run as plain matmuls
            d[bk] = b
        if blk.se is not None:
            fc1, fc2 = blk.se.fc[0], blk.se.fc[2]
            d["sf1"] = fc1.weight.detach().float()[:, :, 0, 0].t()
            d["sb1"] = fc1.bias.detach().float()
            d["sf2"] = fc2.weight.detach().float()[:, :, 0, 0].t()
            d["sb2"] = fc2.bias.detach().float()
        if blk.downsample is not None:
            w, b = _fold(blk.downsample[0], blk.downsample[1])
            d["wd"], d["bd"] = w[0, 0], b
        out.append({k: v.contiguous() for k, v in d.items()})
    return out


def prepare_blocks(blocks: Sequence[dict], compute_dtype) -> list:
    """Matrix operands in the compute dtype, biases f32, all contiguous (what
    the kernel reads); in f32 also each product's weight packed for the
    card's 3xTF32 products (:func:`pack_tf32`, under ``w1p``, ``w2p``,
    ``w3p``, ``wdp``).  Idempotent: a pack is kept while it is current
    (:func:`_pack_is_current`), so a caller that prepares once launches
    only the kernel's route, and a weight replaced or changed in place is
    packed anew."""
    out = []
    for blk in blocks:
        d = {k: (v.to(compute_dtype) if k in _MATRIX_KEYS else v.float()).contiguous()
             for k, v in blk.items() if v is not None
             and (compute_dtype == torch.float32 or k not in _PACKED.values())}
        if compute_dtype == torch.float32:
            for k, pk in _PACKED.items():
                if k not in d:
                    d.pop(pk, None)
                elif not _pack_is_current(d.get(pk), d[k]):
                    d[pk] = pack_tf32(d[k])
                    d[pk]._k2_packed_from = (d[k], _version(d[k]))
        out.append(d)
    return out


def _pack_is_current(pack: Optional[torch.Tensor], w: torch.Tensor) -> bool:
    """Whether ``pack`` may stand for ``pack_tf32(w)``: one that
    prepare_blocks made records its weight and that weight's version, and
    is current while the block holds that very tensor, unchanged; one
    without that record (a loaded program's parameter, a copy moved to
    another device) is taken as made from the block's weight."""
    if pack is None:
        return False
    made = getattr(pack, "_k2_packed_from", None)
    return made is None or (made[0] is w and made[1] == _version(w))


def _version(t: torch.Tensor) -> Optional[int]:
    """t's in-place version counter (None for an inference tensor, which
    keeps none)."""
    return None if t.is_inference() else t._version


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero): its low 13 mantissa bits cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """(hi, lo) = (tf32(t), tf32(t - hi)): t = hi + lo to ~2^-22 of |t|, the
    operands of the kernel's 3xTF32 products."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


# a k8 group of the packed weights: hardware k position p holds channel
# _TF32_K_ORDER[p], so that one 8-byte load of channels 2 t and 2 t + 1
# gives a thread its A fragment's columns t and t + 4
_TF32_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def pack_tf32(w: torch.Tensor) -> torch.Tensor:
    """A product's f32 weight [K, N] (w1, w3, wd) or [3, 3, K, N] (w2) as
    the kernel's f32 instances read it: [planes, N, K8], plane 2 t + 0 the tf32
    hi and 2 t + 1 the lo of tap t (t = 3 dy + dx; one tap for a 1x1), K
    zero-padded to K8, a multiple of 8, and contiguous (tf32 wgmma reads B
    K-major), each k8 group in _TF32_K_ORDER."""
    k = w.shape[-2]
    k8 = -(-k // 8) * 8
    t = torch.stack(tf32_split(w), dim=-3)              # [..., 2, K, N]
    t = F.pad(t, (0, 0, 0, k8 - k)).transpose(-1, -2)   # [..., 2, N, K8]
    t = t.reshape(*t.shape[:-1], k8 // 8, 8)[..., list(_TF32_K_ORDER)]
    return t.reshape(-1, t.shape[-3], k8).contiguous()


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _rnd(t, cd):
    """Round to the compute dtype, computed on in f32: bf16 x bf16 products
    are exact in f32, so this is 'bf16 operands, f32 accumulate'."""
    return t.to(cd).float()


def _mm(y, w, cd):
    """1x1 conv on NCHW as a matmul: [B, C, H, W] x [C, N] -> [B, N, H, W] f32."""
    return torch.einsum("bchw,cn->bnhw", _rnd(y, cd), _rnd(w, cd))


def _m2_reference(y, blk, cd):
    """m2 = relu(3x3(relu(y . w1 + b1)) + b2), f32, before conv3 rounds it."""
    h, w = y.shape[-2:]
    m = torch.relu(_mm(y, blk["w1"], cd) + blk["b1"].float()[:, None, None])
    p = F.pad(_rnd(m, cd), (1, 1, 1, 1))  # zero pad after the relu
    acc = torch.zeros_like(m)
    for dy in range(3):
        for dx in range(3):
            acc = acc + _mm(p[:, :, dy:dy + h, dx:dx + w], blk["w2"][dy, dx], cd)
    return torch.relu(acc + blk["b2"].float()[:, None, None])


def _se_logits(v, blk, cd):
    """The SE gate before its sigmoid, from v = mean_hw(o) [B, Cout] f32."""
    g = torch.relu(_rnd(v, cd) @ _rnd(blk["sf1"], cd) + blk["sb1"].float())
    return _rnd(g, cd) @ _rnd(blk["sf2"], cd) + blk["sb2"].float()


def _block_reference(y, blk, cd):
    if blk.get("wd") is not None:
        identity = _mm(y, blk["wd"], cd) + blk["bd"].float()[:, None, None]
    else:
        identity = y.float()
    out = _mm(_m2_reference(y, blk, cd), blk["w3"], cd) + blk["b3"].float()[:, None, None]
    if blk.get("sf1") is not None:
        v = out.mean(dim=(2, 3))  # [B, C] f32
        out = out * torch.sigmoid(_se_logits(v, blk, cd))[:, :, None, None]
    return torch.relu(out + identity)


def se_mean_from_sums_reference(partial, hw: int, blk: dict, compute_dtype):
    """v = mean_hw(o) [B, Cout] f32 from the sums pass's per-tile channel
    sums of m2 (``partial`` [B, tiles, width] f32, m2 rounded to the compute
    dtype as conv3 reads it): conv3 is linear, so mean_hw(o) = (sum of the
    tile sums / hw) . w3 + b3, the mean itself unrounded.  Channels past
    w3's rows (the bf16 kernel's zero padding of the width, whose m2 is 0)
    are dropped."""
    mean = partial.float().sum(dim=1) / hw
    width = blk["w3"].shape[0]
    return mean[:, :width] @ _rnd(blk["w3"], compute_dtype) + blk["b3"].float()


def se_gate_from_sums_reference(partial, hw: int, blk: dict, compute_dtype=torch.float32):
    """The plain twin of the kernel's ``se_gate_kernel``: the SE gate [B,
    Cout] f32 of block ``blk`` from the sums pass's ``partial`` [B, tiles,
    width] over a map of ``hw`` pixels.  Tests hold the kernel's gate and
    the plain chain's against it; no path on the card runs it."""
    with torch.autocast(device_type=partial.device.type, enabled=False):
        v = se_mean_from_sums_reference(partial, hw, blk, compute_dtype)
        return torch.sigmoid(_se_logits(v, blk, compute_dtype))


def bottleneck_chain_reference(x, blocks: Sequence[dict], compute_dtype=torch.float32):
    """Plain PyTorch version of the folded chain on NCHW ``x``: the same math
    and rounding points as the kernel, f32 carried between blocks, output in
    x's dtype.  Autocast is switched off inside: the compute dtype is
    explicit."""
    with torch.autocast(device_type=x.device.type, enabled=False):
        y = x
        for blk in blocks:
            y = _block_reference(y, blk, compute_dtype)
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# the kernel's launch plan and wrapper
# ---------------------------------------------------------------------------

_KERNEL = "bottleneck_chain"
_SUPPORTED = (torch.float32, torch.bfloat16)
# csrc/bottleneck_chain.cu's hopper::Shape: the most pixels a tile holds
# (three 64-row wgmma tiles) and the bound on (TH + 2) * (TW + 2) (m1 on
# the tile and its ring), bf16 at both product widths and f32 at 64
WGMMA_BAND, WGMMA_STORE = 192, 320
# f32 at width 128 (m1 at 544 B a pixel): two 64-row wgmma tiles, m1 in
# 180 pixels
F32_WIDE_BAND, F32_WIDE_STORE = 128, 180
MAX_WIDTH = 128
SMEM_LIMIT = 232448  # one block of threads' shared memory on Hopper (227 KB)


class LaunchPlan(NamedTuple):
    """One block launch: tiles of ``th`` rows by ``tw`` columns, ``tiles_h``
    by ``tiles_w`` of them per sample, the kernel shape for widths up to
    ``wmax``, and the shared memory one block of threads takes."""
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    wmax: int
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return self.tiles_h * self.tiles_w


def _limits(wmax: int, bf16: bool) -> tuple:
    """(band, store) of the kernel's instance: the most pixels a tile holds
    and the bound on (TH + 2) * (TW + 2)."""
    if wmax == 128 and not bf16:
        return F32_WIDE_BAND, F32_WIDE_STORE
    return WGMMA_BAND, WGMMA_STORE


def _smem_bytes(th: int, tw: int, wmax: int, bf16: bool) -> int:
    """Shared memory of one block of threads (bottleneck_smem_bytes): 1 KB
    of alignment, the ring of weight chunks (bf16: 4 stages of [64][64] or
    3 of [128][128]; f32: the hi and lo [wmax][32] f32, 4 or 3 stages), the
    x tile (band pixels of kKX + 8 channels: kKX 64, f32 at width 128 32),
    the SE sums of the consumer warps, 8 slots of biases and SE gates, the
    mbarriers, then m1 at wmax + 8 channels a pixel."""
    es = 2 if bf16 else 4
    band = _limits(wmax, bf16)[0]
    store = (th + 2) * (tw + 2)  # m1 on the tile and its 1-pixel ring
    stages = 4 if wmax == 64 else 3
    ring = stages * (wmax * wmax * 2 if bf16 else 2 * wmax * 32 * 4)
    kx = 32 if wmax == 128 and not bf16 else 64
    warps = band // 16  # 4 per consumer warpgroup of 64 pixels
    return (1024 + ring + band * (kx + 8) * es + warps * wmax * 4 + 8 * wmax * 4 + 64
            + es * (wmax + 8) * store)


@functools.lru_cache(maxsize=None)
def launch_plan(h: int, w: int, width: int, bf16: bool) -> LaunchPlan:
    """The tiles of one block launch on an [h, w] map at Bottleneck width
    ``width`` (``bf16``: bf16 compute, else f32).  A tile spans whole rows
    (TW = w) where a band of them fits, so its loads and stores stay
    contiguous; wider maps take 2-D tiles (:func:`_wgmma_tile`) and as many
    rows as fit.  Needs no library: the wrapper checks the result against
    the kernel's ``bottleneck_smem_bytes``."""
    if not 0 < width <= MAX_WIDTH:
        raise ValueError(f"the kernel takes Bottleneck widths 1..{MAX_WIDTH}, got {width} "
                         "(every trunk layer1_block_names accepts has 64 or 128)")
    if h < 1 or w < 1:
        raise ValueError(f"empty map {h}x{w}")
    wmax = 64 if width <= 64 else 128
    th, tw = _wgmma_tile(h, w, wmax, *_limits(wmax, bf16))
    return LaunchPlan(th, tw, -(-h // th), -(-w // tw), wmax, _smem_bytes(th, tw, wmax, bf16))


def _wgmma_tile(h: int, w: int, wmax: int, band: int, store: int) -> tuple:
    """(th, tw) within ``band`` pixels and (th + 2) * (tw + 2) <= ``store``.
    Products 64 channels wide (Bottleneck widths up to 64): whole rows (tw =
    w) up to 96 columns, as many as the limits take.  Otherwise whole rows
    or 2-D tiles of 32 or 64 columns (f32 at width 128, whose m1 holds 180
    pixels: also 16), as many rows as the limits take; the tile with the
    most pixels among those that hold a multiple of 64 (whole wgmma row
    tiles), else the most pixels; whole rows where two tie."""
    if wmax == 64 and w <= 96:
        return min(h, band // w, store // (w + 2) - 2), w
    best = None
    for tw in (w, 32, 64) if band == WGMMA_BAND else (w, 16, 32, 64):
        if tw > w:
            continue
        th = min(h, band // tw, store // (tw + 2) - 2)
        if th < 1:
            continue
        th = next((t for t in range(th, 0, -1) if t * tw % 64 == 0), th)
        key = (th * tw % 64 == 0, th * tw, tw == w)
        if best is None or key > best[0]:
            best = (key, th, tw)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use), with its C signatures."""
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bottleneck_block_forward.argtypes = [p] * 20 + [i] * 12 + [p]
    lib.bottleneck_block_forward.restype = i
    lib.bottleneck_smem_bytes.argtypes = [i] * 4
    lib.bottleneck_smem_bytes.restype = i
    lib.bottleneck_blocks_per_sm.argtypes = [i] * 5
    lib.bottleneck_blocks_per_sm.restype = i
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_block(blk, cin, cd, dev):
    width, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    shapes = {"w1": (cin, width), "b1": (width,), "w2": (3, 3, width, width),
              "b2": (width,), "w3": (width, cout), "b3": (cout,)}
    if "wd" in blk:
        shapes.update(wd=(cin, cout), bd=(cout,))
    elif cin != cout:
        raise ValueError(f"identity block needs Cin == Cout, got {cin} -> {cout}")
    if "sf1" in blk:
        hidden = blk["sf1"].shape[1]
        shapes.update(sf1=(cout, hidden), sb1=(hidden,), sf2=(hidden, cout), sb2=(cout,))
    if cd == torch.float32:  # pack_tf32's [planes, N, K8]
        cin8, width8 = -(-cin // 8) * 8, -(-width // 8) * 8
        shapes.update(w1p=(2, width, cin8), w2p=(18, width, width8), w3p=(2, cout, width8))
        if "wd" in blk:
            shapes["wdp"] = (2, cout, cin8)
    for k, shape in shapes.items():
        t = blk[k]
        want = cd if k in _MATRIX_KEYS else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"block weight {k}: {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"expected contiguous {shape} {want} on {dev}")
    return width, cout


def _tma_weights(blk: dict) -> dict:
    """What the bf16 instances read: their tensor maps need rows of a
    multiple of 16 bytes and 16-byte aligned bases.  So the width is
    zero-padded to a multiple of 8 (w1's and w2's output channels, w2's and
    w3's input channels, b1, b2: the padded channels of m1 and m2 are
    relu(0) = 0 and meet zero weights, so the block computes the same
    function), a misaligned matrix is copied, and Cout must be a multiple of
    8 already.  (The f32 instances read pack_tf32's packs, whose K is
    padded to 8.)"""
    cout = blk["w3"].shape[1]
    if cout % 8:
        raise ValueError(f"Cout {cout}: the bf16 kernel takes Cout in multiples of 8 (every "
                         "Bottleneck has 4 x width)")
    pad = -blk["w1"].shape[1] % 8
    if pad:
        blk = {**blk, "w1": F.pad(blk["w1"], (0, pad)), "b1": F.pad(blk["b1"], (0, pad)),
               "w2": F.pad(blk["w2"], (0, pad, 0, pad)), "b2": F.pad(blk["b2"], (0, pad)),
               "w3": F.pad(blk["w3"], (0, 0, 0, pad))}
    return {k: v if v.data_ptr() % 16 == 0 else v.clone() for k, v in blk.items()}


def _launch_block(lib, y, blk, compute_dtype, out_dtype, stream, index=0):
    """One folded block on the card: its launches (an SE block's sums pass,
    gate and full pass) on ``stream``.  ``blk`` is prepared and checked.
    Returns (out, partial, gate): the sums pass's per-tile channel sums of
    m2 [B, tiles, width] and the gate [B, Cout] (None without SE)."""
    bsz, cin, h, w = y.shape
    bf16 = compute_dtype == torch.bfloat16
    if bf16:
        blk = _tma_weights(blk)
    else:  # the packs' tensor maps need 16-byte aligned bases
        blk = {k: v if k not in _PACKED.values() or v.data_ptr() % 16 == 0 else v.clone()
               for k, v in blk.items()}
    width, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    plan = launch_plan(h, w, width, bf16)
    smem = lib.bottleneck_smem_bytes(plan.th, plan.tw, width, int(bf16))
    if smem != plan.smem_bytes:
        raise RuntimeError(f"launch plan {plan} disagrees with the kernel's limits "
                           f"(bottleneck_smem_bytes: {smem})")
    out = torch.empty((bsz, cout, h, w), device=y.device, dtype=out_dtype)
    partial = gate = None
    hidden = 0
    if "sf1" in blk:
        hidden = blk["sf1"].shape[1]
        partial = torch.empty((bsz, plan.tiles, width), device=y.device, dtype=torch.float32)
        gate = torch.empty((bsz, cout), device=y.device, dtype=torch.float32)
    rc = lib.bottleneck_block_forward(
        _ptr(y), _ptr(out), _ptr(partial), _ptr(gate),
        _ptr(blk["w1"]), _ptr(blk["b1"]), _ptr(blk["w2"]), _ptr(blk["b2"]),
        _ptr(blk["w3"]), _ptr(blk["b3"]), _ptr(blk.get("wd")), _ptr(blk.get("bd")),
        _ptr(blk.get("sf1")), _ptr(blk.get("sb1")), _ptr(blk.get("sf2")), _ptr(blk.get("sb2")),
        *(_ptr(blk.get(k)) for k in _PACKED.values()),
        bsz, cin, width, cout, hidden, h, w, plan.th, plan.tw,
        int(y.dtype == torch.bfloat16), int(bf16), int(out_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"bottleneck_block_forward (block {index}) failed: cudaError {rc}")
    return out, partial, gate


def _bottleneck_chain_cuda(x, blocks, compute_dtype):
    if x.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise ValueError(f"x {x.dtype} / compute {compute_dtype}: kernel takes f32 or bf16")
    if compute_dtype == torch.float32 and x.dtype != torch.float32:
        raise ValueError(f"x {x.dtype} with f32 compute: the kernel's f32 instances take f32 x "
                         "(an f32 model feeds f32)")
    if x.dim() != 4 or not x.is_contiguous() or not 0 < x.shape[0] <= 65535:
        raise ValueError("x must be a contiguous NCHW tensor with 1..65535 samples")
    lib = _lib()
    cin = x.shape[1]
    blocks = prepare_blocks(blocks, compute_dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = x
    for i, blk in enumerate(blocks):
        _, cout = _check_block(blk, cin, compute_dtype, x.device)
        out_dtype = x.dtype if i == len(blocks) - 1 else torch.float32
        y = _launch_block(lib, y, blk, compute_dtype, out_dtype, stream, i)[0]
        cin = cout
    return y


# a folded block's own tensors, the function's inputs
FOLDED_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wd", "bd", "sf1", "sb1", "sf2", "sb2")
# the op's flat parameters: the folded tensors, then the f32 packs (absent,
# so None, in bf16), so that an exported f32 program carries its packs
_BLOCK_KEYS = (*FOLDED_KEYS, *_PACKED.values())


def _flatten_blocks(blocks) -> list:
    """Block dicts -> one list of optional tensors, _BLOCK_KEYS per block."""
    return [blk.get(k) for blk in blocks for k in _BLOCK_KEYS]


def _unflatten_blocks(params) -> list:
    n = len(_BLOCK_KEYS)
    return [{k: t for k, t in zip(_BLOCK_KEYS, params[i:i + n]) if t is not None}
            for i in range(0, len(params), n)]


@torch.library.custom_op("simple_pose::bottleneck_chain", mutates_args=())
def _chain_op(x: torch.Tensor, params: List[Optional[torch.Tensor]],
              bf16: bool) -> torch.Tensor:
    """The registered op that :func:`bottleneck_chain` calls, so that
    ``torch.export`` keeps K2 as one node and a loaded program launches it
    (importing this module registers it).  ``params``: the blocks flattened
    by _BLOCK_KEYS; ``bf16``: the compute dtype is bf16, else f32."""
    blocks = _unflatten_blocks(params)
    compute_dtype = torch.bfloat16 if bf16 else torch.float32
    if x.device.type == "cpu":
        return bottleneck_chain_reference(x, blocks, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_chain runs on cpu or cuda tensors, got {x.device}")
    y = _bottleneck_chain_cuda(x, blocks, compute_dtype)
    bottleneck_chain.launches += 1
    return y


@_chain_op.register_fake
def _chain_op_fake(x, params, bf16):
    cout = _unflatten_blocks(params)[-1]["w3"].shape[1]
    return x.new_empty((x.shape[0], cout, x.shape[2], x.shape[3]))


def _kernel_flags(name: str) -> list:
    """The bool template arguments of a block kernel's name as a profiler
    trace gives it, demangled (``<64, float, true, __nv_bfloat16, float,
    false>``) or mangled (``...ILi64EfLb1E13__nv_bfloat16fLb0EEEv...``)."""
    m = re.search(r"bottleneck_block\w*<([^<>]*)>", name)
    if m:
        return [a.strip() == "true" for a in m.group(1).split(",")
                if a.strip() in ("true", "false")]
    return [f == "1" for f in re.findall(r"Lb([01])E", name)]


def k2_launch_kind(name: str) -> Optional[str]:
    """Which of K2's launches a kernel name from a profiler trace is:
    "block" (a block kernel's full pass), "sums" (an SE block's sums pass:
    the same kernels with their last template flag, kSums, set), "se_gate",
    or None for another kernel."""
    if "se_gate_kernel" in name:
        return "se_gate"
    if "bottleneck_block" not in name:
        return None
    flags = _kernel_flags(name)
    return "sums" if flags and flags[-1] else "block"


@counts_launches
def bottleneck_chain(x, blocks: Sequence[dict], compute_dtype=torch.float32):
    """Fused folded-Bottleneck chain on NCHW ``x`` -> [B, Cout, H, W] in x's
    dtype, through the registered op ``torch.ops.simple_pose.bottleneck_chain``.
    CPU tensors take :func:`bottleneck_chain_reference`; CUDA tensors launch
    the kernel (``bottleneck_chain.launches`` counts those calls, eager or
    from a loaded ``torch.export`` program) or raise."""
    if compute_dtype not in _SUPPORTED:
        raise ValueError(f"compute dtype {compute_dtype}: the chain takes f32 or bf16")
    return torch.ops.simple_pose.bottleneck_chain(x, _flatten_blocks(blocks),
                                                  compute_dtype == torch.bfloat16)
