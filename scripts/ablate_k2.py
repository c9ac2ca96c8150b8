"""What holds the fused layer1 kernel K2 (bf16, wgmma) back, on one CUDA
card: ablations and per-phase timers of its block kernel at the flagship's
layer1 (width 64).

    python scripts/ablate_k2.py [--batch 128] [--calls 10]

Makes edited copies of the package under build/k2_variants/ (the repo's
own sources are not touched), builds them side by side, and runs
scripts/profile_torch_k2.py in each, in the order base, variants, base:

  nostore  the block kernel's output stores switched off
  no3x3    the 3x3's wgmma products switched off (its weight chunks still
           arrive and are released)
  noxload  the global loads of x in the staging of phases A and C off

Each switch is a runtime condition that never holds, so the compiler keeps
the rest of the kernel.  The outputs of a variant are wrong; only its time
means something.  Then ``timers``: a copy whose block kernel takes
%globaltimer at each phase boundary of its consumers (after a barrier of
the three consumer warpgroups, on thread 0), summed over all blocks of
threads, and prints the mean microseconds per block of threads of each
phase, for block 0's sums pass and full pass (SE, projection) and blocks
1-2.
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
        ("          if (p >= npix || n >= cout) continue;\n"
         "          const size_t o = (size_t)n * HW + g.band.lin<kRows>(p);",
         f"          if (p >= npix || n >= cout || !({NEVER})) continue;\n"
         "          const size_t o = (size_t)n * HW + g.band.lin<kRows>(p);"),
    ],
    "no3x3": [
        ("consume(ring, acc, 64 * wg < npix, m1_row + 2 * kP * shift, kN / 16, 64 * kN * 2, k2c);",
         f"consume(ring, acc, 64 * wg < npix && {NEVER}, m1_row + 2 * kP * shift, kN / 16, "
         "64 * kN * 2, k2c);"),
    ],
    "noxload": [
        ("        const bool cok = c + e < cin;",
         "        const bool cok = c + e < cin && HW < 0;"),
    ],
}

PHASES = ("init", "A stage x, conv1, m1", "B 3x3", "B m2 store", "C x for the projection",
          "C conv3", "C bias, SE gate", "C identity or projection", "C stores", "sums pass sums")
TIMER_DEFS = r"""
__device__ unsigned long long g_k2_ns[3][16];
__device__ __forceinline__ unsigned long long k2_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_TICK(k) do { consumers_sync<S>(); if (threadIdx.x == 0) { \
  const unsigned long long n_ = k2_now(); \
  atomicAdd(&g_k2_ns[kSums ? 2 : se][k], n_ - t_); t_ = n_; } } while (0)

"""
TIMER_EXPORT = r"""
extern "C" int k2_phase_ns(unsigned long long* out) {
  static const unsigned long long zeros[48] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, hopper::g_k2_ns, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hopper::g_k2_ns, zeros, sizeof(zeros));
  return (int)e;
}
"""
KERNEL_HEAD = ("template <int kN, typename TC, bool kRows, typename TI, typename TO, bool kSums>\n"
               "__global__ void __launch_bounds__(Shape<kN, TC>::kThreads, 1)\n"
               "    bottleneck_block_wgmma_kernel")
TIMER_EDITS = [  # (anchor, text put after it), on the consumers' side
    ("  float acc[4 * kJ];\n", "  unsigned long long t_ = k2_now();\n"),
    ("      bias_s[i] = i % kN < width ? (i < kN ? a.b1 : a.b2)[i % kN] : 0.f;\n"
     "    K2_ADD(kTEpiA, t0);\n  }\n", "  K2_TICK(0);\n"),
    ("    consumers_sync<S>();  // m1 is complete\n    K2_ADD(kTSync, t0);\n  }\n",
     "  K2_TICK(1);\n"),
    ("  __syncwarp();  // conv3 reads only this warp's own rows of m2\n"
     "  K2_ADD(kTEpiB, t_m2);\n", "  K2_TICK(3);\n"),
    ("    K2_ADD(kTSe, t_se);\n", "    K2_TICK(6);\n"),
    ("    K2_ADD(kTOut, t_out);\n", "    K2_TICK(8);\n"),
    ("    K2_ADD(kTSe, t_sums);\n", "    K2_TICK(9);\n"),
]
TIMER_BEFORE = [("  K2_MARK(t_sync);\n  consumers_sync<S>();  // every read of m1 is done",
                 "  K2_TICK(2);\n"),
                ("    consumers_sync<S>();  // the pass's biases are in place", "    K2_TICK(5);\n"),
                ("  for (int np = 0; np < passes; ++np) {\n    const int n0 = kN * np;",
                 "  K2_TICK(4);\n"),
                ("    K2_MARK(t_out);\n", "    K2_TICK(7);\n")]

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
buf = (ctypes.c_ulonglong * 48)()
bottleneck_chain(x, blocks, torch.bfloat16); torch.cuda.synchronize()
assert lib.k2_phase_ns(ctypes.addressof(buf)) == 0
bottleneck_chain(x, blocks, torch.bfloat16); torch.cuda.synchronize()
assert lib.k2_phase_ns(ctypes.addressof(buf)) == 0
ctas = batch * 16  # bands of 4 rows at 64x48
print(json.dumps({"us_per_cta_block0_sums": [buf[32 + k] / ctas / 1e3 for k in range(10)],
                  "us_per_cta_block0": [buf[16 + k] / ctas / 1e3 for k in range(10)],
                  "us_per_cta_blocks12": [buf[k] / (2 * ctas) / 1e3 for k in range(10)]}))
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
                          "sums_ms": row["split"]["sums"]["device_ms_per_call"],
                          "se_gate_ms": row["split"]["se_gate"]["device_ms_per_call"]}))
    timers = json.loads(run([sys.executable, "-c", TIMER_RUN, str(args.batch)], dirs["timers"]))
    for key, us in timers.items():
        print(json.dumps({key: {p: round(v, 3) for p, v in zip(PHASES, us)},
                          "total_us": sum(us)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
