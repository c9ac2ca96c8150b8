"""Where the fused layer1 kernel K2's time goes, on one CUDA card.

    python scripts/profile_torch_k2.py [--batch 128] [--calls 3] [--model wide_resnet50_2]
                                       [--dtype f32]
    python scripts/profile_torch_k2.py --timers [--batch 128] [--model wide_resnet50_2]

Builds csrc/bottleneck_chain.cu, counts the tensor-core instructions
(``HMMA``: mma.sync, ``HGMMA``: wgmma, ``HGMMA_TF32``: those on TF32
operands, the f32 instances' 3xTF32 products) of each kernel in its SASS
(``cuobjdump -sass``), then traces
``--calls`` calls of the chain in ``--dtype`` (bf16 or f32) at
chip_smoke.py's layer1 shapes
(``--model``'s layer1 with SE: the flagship resnet50, width 64, or
wide_resnet50_2, width 128; x [batch, 64, 64, 48], BN folded from seeded
statistics) with chip_smoke.py's ``k2_split`` (a torch.profiler trace
that holds exactly the route's launches).  Prints, as JSON lines: the
card (nvidia-smi name and power limit), the HMMA counts, and per kind of
launch (``k2_launch_kind``: the block kernels' full passes, the SE block's
sums pass, ``se_gate_kernel``) the launches and device ms per call, its
share, and the bytes that the code moves counted from its loads and
stores (no cache reuse assumed) over 3.35 TB/s, beside the chain's
operations bound; and the block kernel's device ms for each Bottleneck
block (the SE block's sums pass apart).

``--timers`` instead copies the package to build/k2_timers/ with the kernel
source built under ``K2_PHASE_TIMERS`` (cycle counters in the wgmma kernel,
see ``hopper::kTimers``) and runs ``--model``'s layer1 with SE one
Bottleneck block at a time (x bf16 into block 0, f32 into blocks 1-2;
resnet50: the instance whose products are 64 channels wide,
wide_resnet50_2: 128; block 0's counters add its sums pass and its full
pass): per block the
cycles per block of threads that a consumer warp spends in each region the
kernel's ``kTimers`` names (waiting for a weight chunk, its products,
staging x, the epilogues, the barriers, all), and that the producer spends
waiting for a free stage, with their shares.  The counters cost
time, so the shares are what the copy is for, beside the ms of the same
launch without them.
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    PEAK_TF32_FLOPS,
    card_line,
    chain_work,
    k2_split,
    seeded_layer1,
)
from simple_pose_torch.models.resnet import build_resnet  # noqa: E402
from simple_pose_torch.ops.bottleneck_chain import (  # noqa: E402
    FOLDED_KEYS,
    fold_bottleneck_blocks,
    launch_plan,
    prepare_blocks,
)
from simple_pose_torch.utils.cuda_build import build_library  # noqa: E402

KERNEL_GROUPS = ("block", "sums", "se_gate")


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
            counts[current] = {"HMMA": 0, "HGMMA": 0, "HGMMA_TF32": 0}
        elif current is not None:
            for op, kind in re.findall(r"\b(HG?MMA)(\.\S*)?", line):
                counts[current][op] += 1
                counts[current]["HGMMA_TF32"] += op == "HGMMA" and "TF32" in kind
    return counts


def design_bytes(blocks, batch, h, w, plan, act) -> tuple:
    """Bytes each kind of launch moves in activations per call, counted from
    the code with no cache reuse: a block kernel's full pass reads its
    input once per tile over its halo (th + 2 rows; on 2-D tiles also tw +
    2 columns) in phase A and once more for the identity or the
    projection, and writes the output; an SE block's sums pass reads its
    input over the halo once more and writes the tile sums; se_gate reads
    the tile sums and writes the gate.  ``plan``: the launch's tiles;
    ``act``: the bytes of an element of the chain's input and output (later
    blocks read and write the f32 carry).  Returned beside it: the weight
    bytes that every block of threads reads again (served by L2)."""
    hw, tiles = h * w, plan.tiles
    halo = (plan.th + 2) * (plan.tw + (2 if plan.tw < w else 0)) / (plan.th * plan.tw)
    out = dict.fromkeys(KERNEL_GROUPS, 0)
    weight_rereads = 0
    x_act = act
    for i, blk in enumerate(blocks):
        cin, width, cout = blk["w1"].shape[0], blk["w1"].shape[1], blk["w3"].shape[1]
        last = i == len(blocks) - 1
        x_bytes = batch * cin * hw * x_act
        halo_bytes = x_bytes * halo
        out["block"] += halo_bytes + x_bytes + batch * cout * hw * (act if last else 4)
        weight_rereads += sum(t.numel() * t.element_size() for t in blk.values()) * tiles * batch
        if "sf1" in blk:
            out["sums"] += halo_bytes + batch * tiles * width * 4
            out["se_gate"] += batch * tiles * width * 4 + batch * cout * 4
        x_act = 4
    return out, weight_rereads


TIMERS_CHILD = r"""
import ctypes, json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from chip_smoke import cuda_ms, seeded_layer1
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.ops.bottleneck_chain import (
    _lib, bottleneck_chain, fold_bottleneck_blocks, launch_plan, prepare_blocks)
batch, model = int(sys.argv[1]), sys.argv[2]
blocks = prepare_blocks(fold_bottleneck_blocks(list(seeded_layer1(
    build_resnet(model, se=True)))), torch.bfloat16)
lib = _lib()
lib.k2_phase_cycles.argtypes = [ctypes.c_void_p]
names = ("wait_chunk", "products", "stage_x", "store_m1", "barriers_after_a_b", "store_m2",
         "bias3_se_gate_or_sums", "identity", "store_out", "all")
buf = (ctypes.c_ulonglong * (len(names) + 2))()
rng = np.random.default_rng(1)
tiles = launch_plan(64, 48, blocks[0]["w1"].shape[1], True).tiles
for i, blk in enumerate(blocks):
    cin = blk["w1"].shape[0]
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (batch, cin, 64, 48))).astype(np.float32)).cuda()
    x = x.to(torch.bfloat16) if i == 0 else x
    ms = cuda_ms(lambda: bottleneck_chain(x, [blk], torch.bfloat16), iters=5)
    assert lib.k2_phase_cycles(ctypes.addressof(buf)) == 0
    bottleneck_chain(x, [blk], torch.bfloat16)
    torch.cuda.synchronize()
    assert lib.k2_phase_cycles(ctypes.addressof(buf)) == 0
    ctas = batch * tiles
    warp = {n: buf[k] / (12 * ctas) for k, n in enumerate(names)}
    prod = {"wait_stage": buf[len(names)] / ctas, "all": buf[len(names) + 1] / ctas}
    shares = {n: warp[n] / warp["all"] for n in names[:-1]}
    shares["rest"] = 1 - sum(shares.values())
    print(json.dumps({"block": i, "ms_with_timers": ms, "ctas": ctas,
                      "consumer_warp_cycles_per_cta": warp, "consumer_shares": shares,
                      "producer_cycles_per_cta": prod,
                      "producer_wait_share": prod["wait_stage"] / prod["all"]}), flush=True)
"""


def run_timers(batch: int, model: str) -> None:
    """--timers: the cycle counters of the wgmma kernel, in a copy of the
    package whose kernel source defines K2_PHASE_TIMERS."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(root, "build", "k2_timers")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "simple_pose_torch"), os.path.join(dst, "simple_pose_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    src = os.path.join(dst, "simple_pose_torch", "csrc", "bottleneck_chain.cu")
    with open(src) as f:
        text = f.read()
    with open(src, "w") as f:
        f.write("#define K2_PHASE_TIMERS\n" + text)
    proc = subprocess.run([sys.executable, "-c", TIMERS_CHILD, str(batch), model], cwd=dst,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"timers run failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    print(proc.stdout, end="")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--model", default="resnet50", choices=("resnet50", "wide_resnet50_2"))
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--timers", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_k2: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    if args.timers:
        print(json.dumps({"card": card, "timers": f"{args.model} layer1", "batch": args.batch}))
        run_timers(args.batch, args.model)
        return 0
    lib_path, _ = build_library("bottleneck_chain")
    print(json.dumps({"card": card, "hmma_per_kernel": hmma_counts(lib_path)}))

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    layer1 = seeded_layer1(build_resnet(args.model, se=True))
    blocks = prepare_blocks(fold_bottleneck_blocks(list(layer1)), dt)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (args.batch, 64, 64, 48)))
                         .astype(np.float32)).cuda().to(dt)
    split = k2_split(x, blocks, dt, args.calls)

    plan = launch_plan(64, 48, blocks[0]["w1"].shape[1], dt == torch.bfloat16)
    folded = [{k: v for k, v in blk.items() if k in FOLDED_KEYS} for blk in blocks]
    nbytes, weight_rereads = design_bytes(folded, args.batch, 64, 48, plan, x.element_size())
    flops, io_bytes = chain_work(blocks, args.batch, 64, 48, x.element_size())
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    kinds = {key: {"launches_per_call": split[key]["launches"],
                   "device_ms_per_call": split[key]["ms"],
                   "share": split[key]["ms"] / split["all_ms"],
                   "design_mbytes": nbytes[key] / 1e6,
                   "design_bytes_ms_at_peak": nbytes[key] / PEAK_BYTES * 1e3}
             for key in KERNEL_GROUPS}
    print(json.dumps({"card": card, "model": args.model, "batch": args.batch, "dtype": args.dtype,
                      "calls": args.calls, "device_ms_per_call": split["all_ms"],
                      "split": kinds, "block_kernel_ms_by_block": split["block_ms_by_block"]}))
    print(json.dumps({"chain_gflop": flops / 1e9,
                      "operations_bound_ms": flops / peak * 1e3,
                      "io_bytes_bound_ms": io_bytes / PEAK_BYTES * 1e3,
                      "design_mbytes_total": sum(nbytes.values()) / 1e6,
                      "design_bytes_ms_at_peak": sum(nbytes.values()) / PEAK_BYTES * 1e3,
                      "weight_l2_mbytes": weight_rereads / 1e6}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
