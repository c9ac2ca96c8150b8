"""What holds the whole-crop kernel (rotate_resample_crop_kernel) back, on one
CUDA card: ablations and per-phase timers.

    python scripts/ablate_crop.py [--batch 128]

Makes edited copies of the package under build/crop_variants/ (the repo's own
sources are not touched), builds them side by side, and times the kernel's
launch alone (bf16 out, on precomputed scalars, chip_smoke.py's phase-5
inputs) with CUDA events in each, in the order base, variants, base:

  nogather    the canvas loads of stage 1 switched off (the taps read 0)
  nostore     the tile's stores to device memory switched off
  occupancy6  __launch_bounds__(256, 6): at most 42 registers, 6 blocks of
              threads per SM
  tile16x32   16 x 32 output tiles (40 x 40 box) in place of 32 x 32: more
              stage-1 values computed twice by neighbouring tiles
  u8float     the canvas bytes turned into f32 by an exponent trick (integer
              or, float subtract) in place of the I2F conversion

The switches of nogather and nostore are runtime conditions that never hold,
so the compiler keeps the rest of the kernel; their outputs are wrong and
only their time means something.  The other three compute the same crop
(``equals_plain``).  Then ``timers``: a copy whose kernel takes %globaltimer
at each phase boundary (after a __syncthreads, on thread 0), summed over all
blocks of threads, and prints the mean microseconds per block of threads of
each phase.  Needs a card; imports torch, numpy and simple_pose_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "simple_pose_torch/csrc/rotate_resample.cu"
NEVER = "c > 0x40000000"

VARIANTS = {
    "nogather": [
        ("const float g0 = (float)__ldg(col + ty.off0), g1 = (float)__ldg(col + ty.off1);",
         f"const float g0 = {NEVER} ? (float)__ldg(col + ty.off0) : 0.0f,\n"
         f"                g1 = {NEVER} ? (float)__ldg(col + ty.off1) : 0.0f;"),
    ],
    "nostore": [
        ("i < nty * nv; i += kCropThreads", "i < nty * nv && oh > 0x40000000; i += kCropThreads"),
        ("i < nty * len; i += kCropThreads", "i < nty * len && oh > 0x40000000; i += kCropThreads"),
    ],
    "occupancy6": [
        ("__launch_bounds__(kCropThreads)\n", "__launch_bounds__(kCropThreads, 6)\n"),
    ],
    "tile16x32": [
        ("constexpr int kTileH = 32;", "constexpr int kTileH = 16;"),
    ],
    "u8float": [
        ("(float)__ldg(col + ty.off0)",
         "__fsub_rn(__uint_as_float(0x4B000000u | __ldg(col + ty.off0)), 8388608.0f)"),
        ("(float)__ldg(col + ty.off1)",
         "__fsub_rn(__uint_as_float(0x4B000000u | __ldg(col + ty.off1)), 8388608.0f)"),
    ],
}

PHASES = ("box", "0 stage-1 taps", "1 stage-1 values", "2 stage 2", "3 stores")
TIMER_DEFS = r'''
__device__ unsigned long long g_crop_ns[8];
__device__ __forceinline__ unsigned long long crop_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define CROP_TICK(k) do { __syncthreads(); if (threadIdx.x == 0) { \
  const unsigned long long n_ = crop_now(); \
  atomicAdd(&g_crop_ns[k], n_ - t_); t_ = n_; } } while (0)

'''
TIMER_EXPORT = r'''
extern "C" int crop_phase_ns(unsigned long long* out) {
  static const unsigned long long zeros[8] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_crop_ns, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_crop_ns, zeros, sizeof(zeros));
  return (int)e;
}
'''
KERNEL_HEAD = "// scalars per sample: d0 d1 t1x t1y r00 r01 r10 r11 u0x u0y\n"
TIMER_AFTER = [("  OutT* stage = reinterpret_cast<OutT*>(stage_bytes);\n",
                "  unsigned long long t_ = crop_now();\n"),
               ("      o[r * out_row + e] = stage[r * stage_row + e];\n    }\n  }\n",
                "  CROP_TICK(4);\n")]
TIMER_BEFORE = [("  // phase 0: ", "  CROP_TICK(0);\n"), ("  // phase 1: ", "  CROP_TICK(1);\n"),
                ("  // phase 2: ", "  CROP_TICK(2);\n"), ("  // phase 3: ", "  CROP_TICK(3);\n")]

TIME_RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from chip_smoke import CROP_HW, INTER, cuda_ms, train_inputs
from simple_pose_torch.ops.rotate_resample import (
    CROP_TILE, _rotate_resample_crop_cuda, affine_crop_two_stage_reference, crop_scalars)
data = train_inputs(np.random.default_rng(5), int(sys.argv[1]))
canvas, trans = torch.from_numpy(data["canvas"]).cuda(), torch.from_numpy(data["trans"]).cuda()
scalars = crop_scalars(trans, CROP_HW, INTER)
crop = lambda: _rotate_resample_crop_cuda(canvas, scalars, CROP_HW, INTER, torch.bfloat16)
want = affine_crop_two_stage_reference(canvas, trans, CROP_HW, INTER, torch.bfloat16)
same = bool(torch.equal(crop(), want))
print(json.dumps({"ms": cuda_ms(crop, iters=100), "equals_plain": same}))
if len(sys.argv) > 2:
    import ctypes
    from simple_pose_torch.ops.rotate_resample import _lib
    lib = _lib()
    lib.crop_phase_ns.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()
    assert lib.crop_phase_ns(ctypes.addressof(buf)) == 0
    crop(); torch.cuda.synchronize()
    assert lib.crop_phase_ns(ctypes.addressof(buf)) == 0
    oh, ow = CROP_HW
    th, tw = CROP_TILE
    ctas = canvas.shape[0] * ((oh + th - 1) // th) * ((ow + tw - 1) // tw)
    print(json.dumps({"us_per_cta": [buf[k] / ctas / 1e3 for k in range(5)]}))
'''


def make_copy(name: str, edit) -> str:
    dst = os.path.join(ROOT, "build", "crop_variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "simple_pose_torch"), os.path.join(dst, "simple_pose_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    path = os.path.join(dst, SRC)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(edit(src))
    return dst


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once in {SRC}: {old[:60]!r}")
    return src.replace(old, new)


def ablate(edits):
    def edit(src):
        for old, new in edits:
            src = replace_once(src, old, new)
        return src
    return edit


def add_timers(src: str) -> str:
    src = replace_once(src, KERNEL_HEAD, TIMER_DEFS + KERNEL_HEAD)
    for anchor, text in TIMER_AFTER:
        src = replace_once(src, anchor, anchor + text)
    for anchor, text in TIMER_BEFORE:
        src = replace_once(src, anchor, text + anchor)
    return src + TIMER_EXPORT


def run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    card = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               ROOT).strip().splitlines()[0]
    dirs = {"base": make_copy("base", lambda s: s)}
    dirs.update({k: make_copy(k, ablate(v)) for k, v in VARIANTS.items()})
    dirs["timers"] = make_copy("timers", add_timers)
    build = [sys.executable, "-c", "from simple_pose_torch.utils.cuda_build import build_library; "
             "build_library('rotate_resample')"]
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc per copy, together
        list(pool.map(lambda d: run(build, d), dirs.values()))
    time_run = [sys.executable, "-c", TIME_RUN, str(args.batch)]
    for name in ("base", *VARIANTS, "base"):
        row = json.loads(run(time_run, dirs[name]).splitlines()[0])
        print(json.dumps({"variant": name, "card": card, "batch": args.batch,
                          "bf16_ms": row["ms"], "equals_plain": row["equals_plain"]}))
    lines = run(time_run + ["timers"], dirs["timers"]).splitlines()
    us = json.loads(lines[1])["us_per_cta"]
    print(json.dumps({"timers_copy_ms": json.loads(lines[0])["ms"],
                      "us_per_cta": {p: round(v, 3) for p, v in zip(PHASES, us)},
                      "total_us": sum(us)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
