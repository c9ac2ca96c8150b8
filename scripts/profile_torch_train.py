"""Where the time of the port's training step goes, on one CUDA card.

    python scripts/profile_torch_train.py [--batch 128] [--steps 3] \
        [--config fast_pose|hrnet_w32]

Builds a training step of chip_smoke.py (``fast_pose``, the default:
configs/fast_pose.yaml's ResNet-50-DConv+SE; ``hrnet_w32``:
configs/hrnet_w32.yaml's HRNet-W32; both 256x192, Adam, EMA, bf16 autocast,
the whole-crop kernel) on seeded data, warms it up, then traces ``--steps`` steps with
torch.profiler.  Prints, as JSON lines: the card (nvidia-smi name and power
limit), the step time on the host clock, the device busy time per step
(the union of kernel intervals) and its share of the step, and the kernels
with the most device time, grouped into the crop kernels (``crop_k1``: every
kernel named rotate_resample*), f32 GEMMs (``crop_stage1_gemm``: the crop's
stage 1 before it ran inside the crop kernel), the convolutions, BatchNorm,
the optimizer and EMA, and the rest.  Needs a card; imports torch, numpy and
simple_pose_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    CROP_HW, HEAT_HW, HRNET_TRAIN_CFG, TRAIN_CFG, busy_us, train_inputs)
from simple_pose_torch.train.solver import init_train_state, make_train_step  # noqa: E402

CONFIGS = {"fast_pose": TRAIN_CFG, "hrnet_w32": HRNET_TRAIN_CFG}
GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("crop_k1", ("rotate_resample",)),
    ("crop_stage1_gemm", ("sgemm", "gemm_f32", "simt")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("optimizer_and_ema", ("foreach", "multi_tensor", "adam")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop", "sm90_",
                     "cutlass", "gemm", "nhwc", "nchw")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="fast_pose")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    data = train_inputs(np.random.default_rng(5), args.batch)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    state = init_train_state(CONFIGS[args.config])
    step = make_train_step(HEAT_HW, CROP_HW, amp=True, crop_impl="kernel")
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    step_us = host_s / args.steps * 1e6
    busy = busy_us(kernels) / args.steps
    by_name, by_group = {}, {}
    for e in kernels:
        us = (e.time_range.end - e.time_range.start) / args.steps
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({"card": card, "config": args.config, "batch": args.batch,
                      "steps": args.steps,
                      "step_ms_host": step_us / 1e3, "device_busy_ms_per_step": busy / 1e3,
                      "device_busy_share": busy / step_us,
                      "kernel_launches_per_step": len(kernels) / args.steps}))
    print(json.dumps({"device_ms_per_step_by_group": {k: v / 1e3 for k, v in
                                                      sorted(by_group.items(),
                                                             key=lambda kv: -kv[1])}}))
    print(json.dumps({"top_kernels_ms_per_step": [[n[:120], v / 1e3] for n, v in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
