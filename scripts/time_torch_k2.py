"""Time the fused layer1 kernel K2 in one or more checkouts, at the four
layer1s it serves: the flagship ResNet-50+SE (`chip_smoke.py`'s phase 3,
width 64), HRNet-W32 (4 blocks, no SE) and ResNet-50-DUC (3 blocks, no SE)
(phase 9a, width 64), and wide_resnet50_2+SE (phase 14a, width 128); each on
x [32, 64, 64, 48] against its plain version in bf16 and f32, then timed at
batch 32 and 128 beside the plain version and cuDNN's layer1 of the same
model, in the same process; one process per checkout, in the order given,
after each checkout's registers, stack, static shared memory and spills per
kernel.

    python scripts/time_torch_k2.py [TREE ...]        (default: .)

To compare two commits on one card, unpack the older one into a directory
that .gitignore lists and run both in the order old, new, new, old:

    mkdir -p archive_check/parent
    git archive HEAD~1 | tar -x -C archive_check/parent
    python scripts/time_torch_k2.py archive_check/parent . . archive_check/parent

Each checkout builds its own library into its own build/.  Prints the
card's name and power limit, then per run one JSON line of the kernels'
resources (``cuobjdump -res-usage``: every instance of the block kernel,
bf16 and f32; with the tiles, dynamic shared memory and blocks per SM of
the width-64 and width-128 launches at 64x48, bf16 and f32, where the
library reports them) and one of errors and times per layer1.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

CHILD = r"""
import json
import torch
import chip_smoke as C
from simple_pose_torch.models.hrnet import build_hrnet
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.utils.cuda_build import build_library
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from simple_pose_torch.ops.bottleneck_chain import _lib, launch_plan
path, seconds = build_library("bottleneck_chain")
lib = _lib() if hasattr(_lib(), "bottleneck_blocks_per_sm") else None
plans = {}
for name, bf16 in (("bf16", True), ("f32", False)):
    for width in (64, 128):
        plan = launch_plan(64, 48, width, bf16)
        plans[f"{name}_width{width}"] = {**plan._asdict(), "blocks_per_sm": lib and
                                         lib.bottleneck_blocks_per_sm(plan.th, plan.tw, width,
                                                                      int(bf16), int(plan.tw == 48))}
print(json.dumps({"library": path, "nvcc_s": seconds, "plans_64x48": plans}), flush=True)
layer1s = {"resnet50": lambda: build_resnet("resnet50", se=True),
           "hrnet_w32": lambda: build_hrnet("w32"),
           "resnet50_duc": lambda: build_resnet("resnet50", head="duc"),
           "wide_resnet50_2": lambda: build_resnet("wide_resnet50_2", se=True)}
for model, build in layer1s.items():
    report, timing = C.check_chain_kernel(C.seeded_layer1(build()), f"{model} layer1 chain")
    print(json.dumps({"layer1": model, "errors": report, "timing": timing}), flush=True)
    torch.cuda.empty_cache()
"""


def resources(lib_path: str) -> dict:
    """Registers, stack and local (spill) bytes of each block kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "bottleneck_block" in name and "REG:" in line:
            out[name] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line)}
    return out


def main(argv=None):
    trees = (argv if argv is not None else sys.argv[1:]) or ["."]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for spec in trees:
        tree = os.path.abspath(spec)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{spec}: rc {proc.returncode}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        head = lines[0]
        print(json.dumps({"tree": spec, "nvcc_s": head["nvcc_s"],
                          "plans_64x48": head["plans_64x48"],
                          "resources": resources(head["library"])}), flush=True)
        for res in lines[1:]:
            print(json.dumps({"tree": spec,
                              "kernel_ms": {k: v["kernel_ms"] for k, v in res["timing"].items()},
                              "library_ms": {k: v["library_ms"] for k, v in res["timing"].items()},
                              **res}), flush=True)


if __name__ == "__main__":
    main()
