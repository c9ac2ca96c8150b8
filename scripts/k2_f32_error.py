"""The fused layer1 kernel K2 in f32 (3xTF32 on wgmma) against its plain
version over seeds, and against two replays of its arithmetic that differ
only in how the tensor cores' f32 sums round.

    python scripts/k2_f32_error.py [--seeds 5] [--batch 128] [--emulate-batch 32]

For the flagship's layer1 (resnet50+SE, width 64) and wide_resnet50_2+SE's
(width 128), seed s: weights from ``build_resnet(seed=s)``, BN statistics
from chip_smoke's ``seeded_layer1(seed=s)``, x [batch, 64, 64, 48] = |N(0,
1)| from numpy seed s.  The chain on the card in f32 against
``bottleneck_chain_reference`` (TF32 off): max and mean |error| over
max|plain|, and the mean signed error along the plain value's sign, over
max|plain| ("bias": below 0, the kernel's outputs are smaller in
magnitude).

Then at seed 0 and ``--emulate-batch``, the kernel's products replayed in
float64 (:func:`emulate_chain`): operands split into TF32 hi and lo as the
kernel splits them, three products per k8 step in its order (a_lo.b_hi,
a_hi.b_lo, a_hi.b_hi; conv1; the 3x3 tap after tap into one sum; conv3,
then the projection into the same sum), each product's k8 sum added to the
f32 accumulator and rounded to f32, either to nearest ("rn") or toward
zero ("rz"); biases, relus, the SE gate and the identity in f32 as the
kernel adds them.  Prints each replay's error against the plain version,
and the kernel's against each replay: the kernel sits near the replay
whose rounding its accumulator does.

Prints the card's name and power limit, then one JSON line per reading.
Needs a card; imports torch, numpy and simple_pose_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line, seeded_layer1  # noqa: E402
from simple_pose_torch.models.resnet import build_resnet  # noqa: E402
from simple_pose_torch.ops.bottleneck_chain import (  # noqa: E402
    _se_logits,
    bottleneck_chain,
    bottleneck_chain_reference,
    fold_bottleneck_blocks,
    prepare_blocks,
    tf32_split,
)

MODELS = {"resnet50": dict(name="resnet50", se=True),
          "wide_resnet50_2": dict(name="wide_resnet50_2", se=True)}


def _round_f32(acc64: torch.Tensor, mode: str) -> torch.Tensor:
    """float64 ``acc64`` rounded to f32: to nearest ("rn") or toward zero
    ("rz")."""
    r = acc64.float()
    if mode == "rz":
        away = r.double().abs() > acc64.abs()
        r = torch.where(away, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _accumulate(acc, a, w, mode):
    """acc [P, N] f32 plus a [P, K] . w [K, N] (f32) as the kernel's f32
    instances add them: per k8 step three products of TF32 halves, each
    one's sum added to acc and rounded (``mode``)."""
    (ah, al), (bh, bl) = (tuple(t.double() for t in tf32_split(v)) for v in (a, w))
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _round_f32(acc.double() + x[:, k] @ y[k], mode)
    return acc


def _emulate_block(y, blk, mode):
    """One folded block on y [B, H, W, Cin] f32 (pixel-major)."""
    b, h, w, cin = y.shape
    x = y.reshape(-1, cin)
    width, cout = blk["w1"].shape[1], blk["w3"].shape[1]
    zeros = lambda n: torch.zeros(x.shape[0], n, dtype=torch.float32, device=y.device)  # noqa: E731
    m1 = torch.relu(_accumulate(zeros(width), x, blk["w1"], mode) + blk["b1"])
    m1 = F.pad(m1.reshape(b, h, w, width), (0, 0, 1, 1, 1, 1))  # zero pad after the relu
    acc = zeros(width)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc = _accumulate(acc, m1[:, dy:dy + h, dx:dx + w].reshape(-1, width),
                          blk["w2"][dy, dx], mode)
    m2 = torch.relu(acc + blk["b2"])
    acc = _accumulate(zeros(cout), m2, blk["w3"], mode) + blk["b3"]
    if "sf1" in blk:  # the gate as se_gate_kernel makes it: from m2's mean through w3
        v = m2.reshape(b, h * w, width).mean(dim=1) @ blk["w3"] + blk["b3"]
        gate = torch.sigmoid(_se_logits(v, blk, torch.float32))
        acc = (acc.reshape(b, h * w, cout) * gate[:, None]).reshape(-1, cout)
    if "wd" in blk:
        acc = _accumulate(acc, x, blk["wd"], mode) + blk["bd"]
    else:
        acc = acc + x
    return torch.relu(acc).reshape(b, h, w, cout)


def emulate_chain(x, blocks, mode):
    """The kernel's f32 chain on NCHW ``x`` replayed in float64 with its
    accumulator rounded per ``mode`` ("rn" or "rz"); NCHW f32 out."""
    y = x.permute(0, 2, 3, 1).float()
    for blk in blocks:
        y = _emulate_block(y, blk, mode)
    return y.permute(0, 3, 1, 2).contiguous()


def errors(got, want):
    """max and mean |got - want| and the mean signed error along want's
    sign, each over max|want|."""
    d = got.double() - want.double()
    scale = want.abs().max().item()
    return {"max_rel": d.abs().max().item() / scale, "mean_rel": d.abs().mean().item() / scale,
            "bias_rel": (d * want.sign()).mean().item() / scale}


def layer1(model, seed, device):
    torch_model = build_resnet(**MODELS[model], seed=seed)
    blocks = fold_bottleneck_blocks(list(seeded_layer1(torch_model, seed=seed)))
    return prepare_blocks([{k: v.to(device) for k, v in b.items()} for b in blocks],
                          torch.float32)


def seeded_x(seed, batch, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.abs(rng.normal(0, 1, (batch, 64, 64, 48))).astype(
        np.float32)).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--emulate-batch", type=int, default=32)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    for model in MODELS:
        for seed in range(args.seeds):
            blocks, x = layer1(model, seed, dev), seeded_x(seed, args.batch, dev)
            got = bottleneck_chain(x, blocks, torch.float32)
            want = bottleneck_chain_reference(x, blocks, torch.float32)
            print(json.dumps({"model": model, "seed": seed, "batch": args.batch,
                              "kernel": errors(got, want)}), flush=True)
            del got, want, x
            torch.cuda.empty_cache()
        blocks, x = layer1(model, 0, dev), seeded_x(0, args.emulate_batch, dev)
        got = bottleneck_chain(x, blocks, torch.float32)
        want = bottleneck_chain_reference(x, blocks, torch.float32)
        row = {"model": model, "seed": 0, "batch": args.emulate_batch,
               "kernel": errors(got, want)}
        for mode in ("rn", "rz"):
            emu = emulate_chain(x, blocks, mode)
            row[f"replay_{mode}"] = errors(emu, want)
            row[f"kernel_vs_replay_{mode}"] = errors(got, emu)
            del emu
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
