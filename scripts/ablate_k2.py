"""What holds the fused layer1 kernel K2 (bf16, tensor cores) back, on one
CUDA card: ablations and per-phase timers of its block kernel.

    python scripts/ablate_k2.py [--batch 128] [--calls 10]

Makes edited copies of the package under build/k2_variants/ (the repo's
own sources are not touched), builds them side by side, and runs
scripts/profile_torch_k2.py in each, in the order base, variants, base:

  nostore  the block kernel's global stores (pre, idn, out) switched off
  no3x3    the 3x3's tensor-core products switched off
  noxload  the global loads of x in the staging of phases A and C off

Each switch is a runtime condition that never holds, so the compiler keeps
the rest of the kernel.  The outputs of a variant are wrong; only its time
means something.  Then ``timers``: a copy whose block kernel takes
%globaltimer at each phase boundary (after a __syncthreads, on thread 0),
summed over all blocks of threads, and prints the mean microseconds per
block of threads of each phase, for block 0 (SE, projection) and blocks 1-2.
The extra barriers make this copy slower; its shares are what it is for.
Needs a card; imports torch, numpy and simple_pose_torch only.
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
SRC = "simple_pose_torch/csrc/bottleneck_chain.cu"
NEVER = "a.h > 0x40000000"

VARIANTS = {
    "nostore": [
        ("if (a.se) idn[o] = acc[i][j][2 * h + e];\n            else out[",
         f"if ({NEVER}) {{ if (a.se) idn[o] = acc[i][j][2 * h + e];\n            else out["),
        ("from_f<TO>(fmaxf(acc[i][j][2 * h + e], 0.f));\n          }\n  }\n}",
         "from_f<TO>(fmaxf(acc[i][j][2 * h + e], 0.f)); }\n          }\n  }\n}"),
        ("if (n < cout) pre[(size_t)n * HW + g.band.lin<kRows>(p)] = acc[i][j][2 * h + e];",
         f"if (n < cout && {NEVER}) pre[(size_t)n * HW + g.band.lin<kRows>(p)] = "
         "acc[i][j][2 * h + e];"),
    ],
    "no3x3": [
        ("warp_mma<kP>(acc, a_addr, mt, smem_u32(w2s) + b_off, kw / 16);",
         f"if ({NEVER}) warp_mma<kP>(acc, a_addr, mt, smem_u32(w2s) + b_off, kw / 16);"),
    ],
    "noxload": [
        ("const bool ok = i < total && r < rows;",
         "const bool ok = i < total && r < rows && HW < 0;"),
    ],
}

PHASES = ("init", "A stage x+w1", "A mma", "A m1 store", "B stage w2", "B mma", "B m2 store",
          "C stage w3", "C mma", "C SE pre+sums", "C stage x+wd", "C proj mma",
          "C identity+stores")
TIMER_DEFS = r'''
__device__ unsigned long long g_k2_ns[2][16];
__device__ __forceinline__ unsigned long long k2_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_TICK(k) do { __syncthreads(); if (threadIdx.x == 0) { \
  const unsigned long long n_ = k2_now(); \
  atomicAdd(&g_k2_ns[a.se][k], n_ - t_); t_ = n_; } } while (0)

'''
TIMER_EXPORT = r'''
extern "C" int k2_phase_ns(unsigned long long* out) {
  static const unsigned long long zeros[32] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_k2_ns, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_k2_ns, zeros, sizeof(zeros));
  return (int)e;
}
'''
KERNEL_HEAD = ("template <int kWMax, bool kRows, typename TI, typename TO>\n"
               "__global__ void __launch_bounds__(kThreads, Cfg<kWMax>::kMinBlocks)\n"
               "    bottleneck_block_tc_kernel")
TIMER_EDITS = [  # (anchor, text put after it)
    ("  bf16* m1s = reinterpret_cast<bf16*>(tc_smem);  // [m1_stride pixels][kP]\n",
     "  unsigned long long t_ = k2_now();\n"),
    ("  for (int i = tid; i < m1_stride * kP / 8; i += kThreads)\n"
     "    reinterpret_cast<uint4*>(m1s)[i] = make_uint4(0, 0, 0, 0);\n", "  K2_TICK(0);\n"),
    ("        stage_w<kWMax, kP>(ws, w1, width, k0, kpad, cin, 0, width);\n"
     "        __syncthreads();\n", "        K2_TICK(1);\n"),
    ("        warp_mma<kP>(acc, a_addr, rmt, smem_u32(ws) + b_off, kpad / 16);\n",
     "        K2_TICK(2);\n"),
    ("      stage_w<kWMax, kP>(w2s, w2 + (size_t)tap * width * width, width, 0, kw, width, 0, "
     "width);\n      __syncthreads();\n", "      K2_TICK(4);\n"),
    ("      warp_mma<kP>(acc, a_addr, mt, smem_u32(w2s) + b_off, kw / 16);\n",
     "      K2_TICK(5);\n"),
    ("    stage_w<kWMax, kP>(w3s, w3, cout, 0, kw, width, n0, cout);\n    __syncthreads();\n",
     "    K2_TICK(7);\n"),
    ("    warp_mma<kP>(acc, a_addr, mt, smem_u32(w3s) + b_off, kw / 16);\n",
     "    K2_TICK(8);\n"),
    ("        for (int m = 1; m < kMG; ++m) s += red[m * kNTile + tid];\n"
     "        a.partial[((size_t)b * a.tiles + blockIdx.x) * cout + n0 + tid] = s;\n      }\n",
     "      K2_TICK(9);\n"),
    ("        stage_w<kWMax, kP>(wds, wd, cout, k0, kpad, cin, n0, cout);\n"
     "        __syncthreads();\n", "        K2_TICK(10);\n"),
    ("        warp_mma<kP>(acc, a_addr, mt, smem_u32(wds) + b_off, kpad / 16);\n",
     "        K2_TICK(11);\n"),
    ("            else out[o] = from_f<TO>(fmaxf(acc[i][j][2 * h + e], 0.f));\n"
     "          }\n", "    K2_TICK(12);\n"),
]
TIMER_BEFORE = [("  // ---- B: m2 = relu(3x3(m1) + b2): 9", "  K2_TICK(3);\n"),
                ("  bf16* w3s = work;", "  K2_TICK(6);\n")]

TIMER_RUN = r'''
import ctypes, json, sys
import numpy as np, torch
sys.path.insert(0, ".")
from chip_smoke import seeded_layer1
from simple_pose_torch.models.resnet import build_resnet
from simple_pose_torch.ops.bottleneck_chain import (
    _lib, bottleneck_chain, fold_bottleneck_blocks, prepare_blocks)
batch = int(sys.argv[1])
blocks = prepare_blocks(fold_bottleneck_blocks(list(seeded_layer1(build_resnet("resnet50", se=True)))),
                        torch.bfloat16)
x = torch.from_numpy(np.abs(np.random.default_rng(1).normal(0, 1, (batch, 64, 64, 48)))
                     .astype(np.float32)).cuda().to(torch.bfloat16)
lib = _lib()
lib.k2_phase_ns.argtypes = [ctypes.c_void_p]
buf = (ctypes.c_ulonglong * 32)()
bottleneck_chain(x, blocks, torch.bfloat16); torch.cuda.synchronize()
assert lib.k2_phase_ns(ctypes.addressof(buf)) == 0
bottleneck_chain(x, blocks, torch.bfloat16); torch.cuda.synchronize()
assert lib.k2_phase_ns(ctypes.addressof(buf)) == 0
ctas = batch * 16  # bands of 4 rows at 64x48
print(json.dumps({"us_per_cta_block0": [buf[16 + k] / ctas / 1e3 for k in range(13)],
                  "us_per_cta_blocks12": [buf[k] / (2 * ctas) / 1e3 for k in range(13)]}))
'''


def make_copy(name: str, edit) -> str:
    dst = os.path.join(ROOT, "build", "k2_variants", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "simple_pose_torch"), os.path.join(dst, "simple_pose_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(dst, "scripts"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    shutil.copy(os.path.join(ROOT, "scripts", "profile_torch_k2.py"), os.path.join(dst, "scripts"))
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
    for anchor, text in TIMER_EDITS:
        src = replace_once(src, anchor, anchor + text)
    for anchor, text in TIMER_BEFORE:
        src = replace_once(src, anchor, text + anchor)
    return src + TIMER_EXPORT


def run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    dirs = {"base": make_copy("base", lambda s: s)}
    dirs.update({k: make_copy(k, ablate(v)) for k, v in VARIANTS.items()})
    dirs["timers"] = make_copy("timers", add_timers)
    build = [sys.executable, "-c", "from simple_pose_torch.utils.cuda_build import build_library; "
             "build_library('bottleneck_chain')"]
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc per copy, together
        list(pool.map(lambda d: run(build, d), dirs.values()))
    prof = [sys.executable, "scripts/profile_torch_k2.py", "--batch", str(args.batch),
            "--calls", str(args.calls)]
    for name in ("base", *VARIANTS, "base"):
        row = json.loads(run(prof, dirs[name]).splitlines()[1])
        print(json.dumps({"variant": name, "card": row["card"],
                          "device_ms_per_call": row["device_ms_per_call"],
                          "block_kernel_ms_by_block": row["block_kernel_ms_by_block"],
                          "se_apply_ms": row["split"]["se_apply"]["device_ms_per_call"]}))
    timers = json.loads(run([sys.executable, "-c", TIMER_RUN, str(args.batch)], dirs["timers"]))
    for key, us in timers.items():
        print(json.dumps({key: {p: round(v, 3) for p, v in zip(PHASES, us)},
                          "total_us": sum(us)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
