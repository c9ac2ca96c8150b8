"""Build a kernel source under ``csrc/`` with nvcc and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled for Hopper into ``build/`` at the root of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC --split-compile=0 -o build/lib<name>-<hash>.so \
         csrc/<name>.cu

``--split-compile=0`` runs the optimizer over a source's kernels on all
cores (bottleneck_chain.cu holds 50 kernel instantiations); the registers
per kernel stay the same (scripts/time_torch_k2.py prints them).

The file name carries a hash of the source, so an edited source is rebuilt
and concurrent processes never load a half-written library (each writes a
temporary file and renames it into place).

Every kernel's Python wrapper carries a launch counter, set up by
:func:`counts_launches`: ``<wrapper>.launches`` grows by one where the
wrapper launches its kernel, and nowhere else, so a run can show that its
path went through the kernel (``chip_smoke.py`` zeroes the counters before
the main path and reads them after).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "build_library", "load_library", "counts_launches"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")


def build_library(name: str) -> tuple:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    :returns: (path of the shared library, seconds spent compiling)"""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` library, loaded once per process."""
    path, _ = build_library(name)
    return ctypes.CDLL(path)


def counts_launches(wrapper):
    """Give a kernel wrapper its launch counter, ``wrapper.launches = 0``.
    The wrapper adds one to it where it launches its kernel."""
    wrapper.launches = 0
    return wrapper
