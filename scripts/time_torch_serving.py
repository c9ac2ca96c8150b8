"""Serving crops/s of the pose families that run the fused layer1 kernel K2,
in one or more checkouts on one CUDA card.

    python scripts/time_torch_serving.py [--reps 5] [--rounds 4] [--no-amp] [TREE ...]
                                                                   (default: .)

For each checkout, in the order given and one process each: build its
kernels, then for the flagship ResNet-50-DConv+SE, HRNet-W32, HRNet-W48,
ResNet-50-DUC and wide_resnet50_2 (chip_smoke.py's phase 4, 9b and 14c
configurations: 256x192, bf16 -- f32 with ``--no-amp`` --, fused_layer1,
flip-test) serve one
device-staged batch of 128 seeded crops (chip_smoke.staged_serving_batch)
``--rounds`` times ``--reps`` times and print one JSON line per checkout:
the crops/s of each round, their median, and K2's launches per batch.
Serving rates move between calls by more than K2's share of a batch, so
compare two commits only within one call, in turns:

    mkdir -p archive_check/parent && git archive HEAD~1 | tar -x -C archive_check/parent
    python scripts/time_torch_serving.py archive_check/parent . . archive_check/parent

Prints the card's name and power limit first.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys
import torch
import chip_smoke as C
from simple_pose_torch.utils.cuda_build import build_library
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
for name in C.KERNELS:
    build_library(name)
reps, rounds, amp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3] == "auto"
models = {"resnet50_se": C.CFG, **C.FAMILY_CFGS, "wide_resnet50_2": C.WIDE_CFG}
batch = C.staged_serving_batch(C.THROUGHPUT_BATCH, 2)
out = {}
for name, cfg in models.items():
    ev = C.PoseEvaluator(cfg, None, C.INPUT_SHAPE, amp="auto" if amp else False,
                         fused_layer1=True, flip_test=True)
    C.zero_launch_counts()
    ev(batch)
    torch.cuda.synchronize()
    launches = C.launch_counts()["bottleneck_chain"]
    rates = [C.serve_rates({name: ev}, batch, reps=reps, rounds=1)[name] for _ in range(rounds)]
    out[name] = {"crops_per_s": rates, "k2_launches_per_batch": launches}
    del ev
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--no-amp", action="store_true", help="serve in f32 (PoseEvaluator amp=False)")
    ap.add_argument("trees", nargs="*", default=["."])
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for tree in args.trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.reps), str(args.rounds),
                               "off" if args.no_amp else "auto"],
                              cwd=tree, capture_output=True, text=True,
                              env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{tree}: rc {proc.returncode}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for row in res.values():
            row["median"] = statistics.median(row["crops_per_s"])
        print(json.dumps({"tree": os.path.relpath(tree), "amp": not args.no_amp, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
