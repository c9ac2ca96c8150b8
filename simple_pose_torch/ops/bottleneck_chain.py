"""Fused eval-mode Bottleneck chain (the fused layer1 path).

Port of simple_pose_tpu/ops/pallas_bottleneck.py.  At eval time BatchNorm is
a per-channel affine, so a chain of Bottleneck blocks folds into pure
(matmul, bias, relu) ops.  On a CUDA tensor :func:`bottleneck_chain` runs the
hand-written Hopper kernel ``csrc/bottleneck_chain.cu`` (one launch per
block, two more for an SE gate; a bf16 ``compute_dtype`` runs the products
on tensor cores, f32 on CUDA cores); on a CPU tensor it runs
:func:`bottleneck_chain_reference`, the plain PyTorch version of the same
math.  There is no fallback: a CUDA tensor reaches the kernel or raises.
The call goes through a registered op (``simple_pose::bottleneck_chain``)
with a fake implementation, so ``torch.export`` traces an evaluator with
the fused layer1 and the loaded program launches the same kernel.

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
[Cout, hidden], sf2 [hidden, Cout]; biases 1-D.  Activations are NCHW.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from simple_pose_torch.utils.cuda_build import counts_launches, load_library

__all__ = ["fold_conv_bn", "fold_bottleneck_blocks", "bottleneck_chain_reference",
           "bottleneck_chain", "prepare_blocks"]

_MATRIX_KEYS = ("w1", "w2", "w3", "wd", "sf1", "sf2")


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
    the kernel reads).  Idempotent, so a caller may prepare once."""
    return [{k: (v.to(compute_dtype) if k in _MATRIX_KEYS else v.float()).contiguous()
             for k, v in blk.items() if v is not None} for blk in blocks]


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


def _block_reference(y, blk, cd):
    h, w = y.shape[-2:]
    if blk.get("wd") is not None:
        identity = _mm(y, blk["wd"], cd) + blk["bd"].float()[:, None, None]
    else:
        identity = y.float()
    m = torch.relu(_mm(y, blk["w1"], cd) + blk["b1"].float()[:, None, None])
    p = F.pad(_rnd(m, cd), (1, 1, 1, 1))  # zero pad after the relu
    acc = torch.zeros_like(m)
    for dy in range(3):
        for dx in range(3):
            acc = acc + _mm(p[:, :, dy:dy + h, dx:dx + w], blk["w2"][dy, dx], cd)
    m2 = torch.relu(acc + blk["b2"].float()[:, None, None])
    out = _mm(m2, blk["w3"], cd) + blk["b3"].float()[:, None, None]
    if blk.get("sf1") is not None:
        v = out.mean(dim=(2, 3))  # [B, C] f32
        g = torch.relu(_rnd(v, cd) @ _rnd(blk["sf1"], cd) + blk["sb1"].float())
        g = torch.sigmoid(_rnd(g, cd) @ _rnd(blk["sf2"], cd) + blk["sb2"].float())
        out = out * g[:, :, None, None]
    return torch.relu(out + identity)


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
# the kernel's wrapper
# ---------------------------------------------------------------------------

_KERNEL = "bottleneck_chain"
_SUPPORTED = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use), with its C signatures."""
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bottleneck_block_forward.argtypes = [p] * 18 + [i] * 10 + [p]
    lib.bottleneck_block_forward.restype = i
    lib.bottleneck_band_rows.argtypes = [i, i]
    lib.bottleneck_band_rows.restype = i
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
    for k, shape in shapes.items():
        t = blk[k]
        want = cd if k in _MATRIX_KEYS else torch.float32
        if tuple(t.shape) != shape or t.dtype != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"block weight {k}: {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"expected contiguous {shape} {want} on {dev}")
    if width > 64:
        raise ValueError(f"the kernel supports Bottleneck width <= 64, got {width}")
    return width, cout


def _bottleneck_chain_cuda(x, blocks, compute_dtype):
    if x.dtype not in _SUPPORTED or compute_dtype not in _SUPPORTED:
        raise ValueError(f"x {x.dtype} / compute {compute_dtype}: kernel takes f32 or bf16")
    if x.dim() != 4 or not x.is_contiguous() or not 0 < x.shape[0] <= 65535:
        raise ValueError("x must be a contiguous NCHW tensor with 1..65535 samples")
    lib = _lib()
    bsz, cin, h, w = x.shape
    th = lib.bottleneck_band_rows(h, w)
    if th == 0:
        raise ValueError(f"the kernel supports layer widths W <= 96, got {w}")
    bands = -(-h // th)
    blocks = prepare_blocks(blocks, compute_dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = x
    for i, blk in enumerate(blocks):
        width, cout = _check_block(blk, cin, compute_dtype, x.device)
        last = i == len(blocks) - 1
        out = torch.empty((bsz, cout, h, w), device=x.device,
                          dtype=x.dtype if last else torch.float32)
        pre = idn = partial = gate = None
        hidden = 0
        if "sf1" in blk:
            hidden = blk["sf1"].shape[1]
            pre = torch.empty((bsz, cout, h, w), device=x.device, dtype=torch.float32)
            idn = torch.empty_like(pre)
            partial = torch.empty((bsz, bands, cout), device=x.device, dtype=torch.float32)
            gate = torch.empty((bsz, cout), device=x.device, dtype=torch.float32)
        rc = lib.bottleneck_block_forward(
            _ptr(y), _ptr(out), _ptr(pre), _ptr(idn), _ptr(partial), _ptr(gate),
            _ptr(blk["w1"]), _ptr(blk["b1"]), _ptr(blk["w2"]), _ptr(blk["b2"]),
            _ptr(blk["w3"]), _ptr(blk["b3"]), _ptr(blk.get("wd")), _ptr(blk.get("bd")),
            _ptr(blk.get("sf1")), _ptr(blk.get("sb1")), _ptr(blk.get("sf2")),
            _ptr(blk.get("sb2")),
            bsz, cin, width, cout, hidden, h, w,
            int(y.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16),
            int(out.dtype == torch.bfloat16), stream)
        if rc != 0:
            raise RuntimeError(f"bottleneck_block_forward (block {i}) failed: "
                               f"cudaError {rc}")
        y, cin = out, cout
    return y


_BLOCK_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3", "wd", "bd", "sf1", "sb1", "sf2", "sb2")


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
