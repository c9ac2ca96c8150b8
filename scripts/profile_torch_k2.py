"""Where the fused layer1 kernel K2's time goes, on one CUDA card.

    python scripts/profile_torch_k2.py [--batch 128] [--calls 3]

Builds csrc/bottleneck_chain.cu, counts the tensor-core instructions
(``HMMA``) of each kernel in its SASS (``cuobjdump -sass``), then traces
``--calls`` bf16 calls of the chain at chip_smoke.py's layer1 shapes (the
flagship ResNet-50+SE layer1, x [batch, 64, 64, 48], BN folded from seeded
statistics) with torch.profiler.  Prints, as JSON lines: the card (nvidia-smi
name and power limit), the HMMA counts, and per kernel (the block kernel,
``se_gate_kernel``, ``se_apply_kernel``) the device ms per call, its share,
and the bytes that the code moves counted from its loads and stores (no
cache reuse assumed) over 3.35 TB/s, beside the chain's operations bound;
and the block kernel's device ms for each Bottleneck block.
Needs a card; imports torch, numpy and simple_pose_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    card_line,
    chain_work,
    seeded_layer1,
)
from simple_pose_torch.models.resnet import build_resnet  # noqa: E402
from simple_pose_torch.ops.bottleneck_chain import (  # noqa: E402
    bottleneck_chain,
    fold_bottleneck_blocks,
    launch_plan,
    prepare_blocks,
)
from simple_pose_torch.utils.cuda_build import build_library  # noqa: E402

KERNEL_GROUPS = {"block": "bottleneck_block_tc_kernel", "se_gate": "se_gate_kernel",
                 "se_apply": "se_apply_kernel"}


def group_of(name: str) -> str:
    return next((g for g, kernel in KERNEL_GROUPS.items() if kernel in name), "other")


def hmma_counts(lib_path: str) -> dict:
    """HMMA instructions per kernel instantiation in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(r"\bHMMA\b", line):
            counts[current] += 1
    return counts


def design_bytes(blocks, batch, h, w, th) -> tuple:
    """Bytes each kernel's loads and stores of activations move per call,
    counted from the code with no cache reuse: the block kernel reads its
    input once per band over th + 2 halo rows (phase A) and once more for
    the identity or the projection, and writes f32 pre and idn for an SE
    block (else the output); se_gate reads the band sums; se_apply reads pre
    and idn and writes the output.  Returned beside it: the weight bytes
    that every block of threads reads again (served by L2)."""
    hw, bands = h * w, -(-h // th)
    out = {"block": 0, "se_gate": 0, "se_apply": 0}
    weight_rereads = 0
    act = 2  # the chain's input is bf16; later blocks read the f32 carry
    for i, blk in enumerate(blocks):
        cin, cout = blk["w1"].shape[0], blk["w3"].shape[1]
        last = i == len(blocks) - 1
        x_bytes = batch * cin * hw * act
        out["block"] += x_bytes * (th + 2) / th + x_bytes
        weight_rereads += sum(t.numel() * t.element_size() for t in blk.values()) * bands * batch
        if "sf1" in blk:
            out["block"] += 2 * batch * cout * hw * 4 + batch * bands * cout * 4
            out["se_gate"] += batch * bands * cout * 4 + batch * cout * 4
            out["se_apply"] += 2 * batch * cout * hw * 4 + batch * cout * hw * (2 if last else 4)
        else:
            out["block"] += batch * cout * hw * (2 if last else 4)
        act = 4
    return out, weight_rereads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k2: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    lib_path, _ = build_library("bottleneck_chain")
    print(json.dumps({"card": card, "hmma_per_kernel": hmma_counts(lib_path)}))

    layer1 = seeded_layer1(build_resnet("resnet50", se=True))
    blocks = prepare_blocks(fold_bottleneck_blocks(list(layer1)), torch.bfloat16)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (args.batch, 64, 64, 48)))
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    for _ in range(3):
        bottleneck_chain(x, blocks, torch.bfloat16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            bottleneck_chain(x, blocks, torch.bfloat16)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    by_group, blocks_us = {}, []
    for e in kernels:
        if KERNEL_GROUPS["block"] in e.name:
            blocks_us.append(e.time_range.end - e.time_range.start)
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + (e.time_range.end - e.time_range.start) / args.calls
    total_us = sum(by_group.values())

    th = launch_plan(64, 48, 64, True).th  # bands of whole rows at 64x48
    nbytes, weight_rereads = design_bytes(blocks, args.batch, 64, 48, th)
    flops, io_bytes = chain_work(blocks, args.batch, 64, 48, 2)
    split = {}
    for key in KERNEL_GROUPS:
        us = by_group.get(key, 0.0)
        split[key] = {"device_ms_per_call": us / 1e3, "share": us / total_us if total_us else 0.0,
                      "design_mbytes": nbytes[key] / 1e6,
                      "design_bytes_ms_at_peak": nbytes[key] / PEAK_BYTES * 1e3}
    print(json.dumps({"card": card, "batch": args.batch, "calls": args.calls,
                      "device_ms_per_call": total_us / 1e3,
                      "kernel_launches_per_call": len(kernels) / args.calls, "split": split,
                      "block_kernel_ms_by_block": [
                          float(np.mean(blocks_us[i::len(blocks)])) / 1e3
                          for i in range(len(blocks))],
                      "other_ms_per_call": by_group.get("other", 0.0) / 1e3}))
    print(json.dumps({"chain_gflop": flops / 1e9,
                      "operations_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
                      "io_bytes_bound_ms": io_bytes / PEAK_BYTES * 1e3,
                      "design_mbytes_total": sum(nbytes.values()) / 1e6,
                      "design_bytes_ms_at_peak": sum(nbytes.values()) / PEAK_BYTES * 1e3,
                      "weight_l2_mbytes": weight_rereads / 1e6}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
