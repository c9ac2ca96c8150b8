"""ctypes binding of the native JPEG canvas loader.

Counterpart of simple_pose_tpu/data/native.py: one native call decodes a
batch of JPEG files in a persistent C++ thread pool and pastes each image
(RGB) at the origin of a zeroed uint8 canvas slot, cropped to the canvas;
the ctypes call releases the interpreter lock for the whole batch.  Two
sources have that C API, and the machine decides which one a loader uses
(:func:`decoder_name`):

* ``libjpeg`` where the compiler finds ``jpeglib.h``: the shared
  native/canvas_loader.cc, linked with -ljpeg;
* ``baseline`` where it does not (the H100 machine has no libjpeg):
  csrc/jpeg_canvas.cc, a sequential and progressive JPEG decoder that
  repeats libjpeg's default integer arithmetic (islow IDCT, fancy
  upsampling, fixed-point YCbCr), so its pixels equal libjpeg's bit for
  bit.  Arithmetic-coded, lossless, 12-bit and CMYK files, and progressive
  files that libjpeg would block-smooth, fail to decode.

Each is built with g++ at first use into ``build/``::

    g++ -O2 -fPIC -std=c++17 -shared native/canvas_loader.cc \
        -o build/libcanvas_loader-<hash>.so -ljpeg -lpthread
    g++ -O2 -fPIC -std=c++17 -shared simple_pose_torch/csrc/jpeg_canvas.cc \
        -o build/libjpeg_canvas-<hash>.so -lpthread

The file name carries a hash of the source and the command, so an edited
source is rebuilt; a file lock lets one process build while the others
wait, and the library is written under a temporary name and renamed into
place.  Nothing falls back: when the library cannot be built or loaded,
:class:`NativeCanvasLoader` raises with the compiler's output.
``NativeCanvasLoader.load_batch.calls`` counts the batches decoded.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from simple_pose_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

__all__ = ["NativeCanvasLoader", "native_available", "build_loader", "decoder_name",
           "SOURCES"]

# decoder -> (source, libraries it links)
SOURCES = {
    "libjpeg": (os.path.join(os.path.dirname(BUILD_DIR), "native", "canvas_loader.cc"),
                ["-ljpeg", "-lpthread"]),
    "baseline": (os.path.join(CSRC_DIR, "jpeg_canvas.cc"), ["-lpthread"]),
}
CXX = "g++"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

_libs: dict = {}
_libs_lock = threading.Lock()
_calls_lock = threading.Lock()


def decoder_name() -> str:
    """'libjpeg' where the compiler finds jpeglib.h, else 'baseline'."""
    return _decoder_for(CXX)


@functools.lru_cache(maxsize=None)
def _decoder_for(cxx: str) -> str:
    try:
        proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True)
    except OSError:
        return "baseline"
    return "libjpeg" if proc.returncode == 0 else "baseline"


def build_loader(decoder: str = "libjpeg") -> tuple:
    """Compile ``decoder``'s source unless this source and command are built.

    :returns: (path of the shared library, seconds spent compiling)
    :raises RuntimeError: with the compiler's output when the build fails"""
    source, libs = SOURCES[decoder]
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha1(src + " ".join([CXX, *CXX_FLAGS, *libs]).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes or the process dies
        if os.path.exists(out):  # another process built it while this one waited
            return out, 0.0
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [CXX, *CXX_FLAGS, source, "-o", tmp, *libs]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"building the native JPEG loader failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building the native JPEG loader failed (rc {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out, time.perf_counter() - t0


def _load_lib(decoder: str) -> ctypes.CDLL:
    path, _ = build_loader(decoder)
    with _libs_lock:
        if path not in _libs:
            lib = ctypes.CDLL(path)
            lib.cl_create.restype = ctypes.c_void_p
            lib.cl_create.argtypes = [ctypes.c_int]
            lib.cl_destroy.restype = None
            lib.cl_destroy.argtypes = [ctypes.c_void_p]
            lib.cl_load_batch.restype = ctypes.c_int
            lib.cl_load_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _libs[path] = lib
        return _libs[path]


def native_available() -> bool:
    """Whether this machine's loader builds and loads."""
    try:
        _load_lib(decoder_name())
    except (RuntimeError, OSError):
        return False
    return True


class NativeCanvasLoader:
    """A persistent decoder; loads a batch of JPEGs into a zeroed
    [n, canvas, canvas, 3] uint8 RGB array, each image at the origin.
    ``decoder`` says which source decodes (:func:`decoder_name`).

    :raises RuntimeError: when the library cannot be built"""

    def __init__(self, num_threads: int = 8):
        self.decoder = decoder_name()
        self._lib = _load_lib(self.decoder)
        self._pool = self._lib.cl_create(max(1, int(num_threads)))

    def load_batch(self, paths, canvas: int):
        """:returns: (canvases u8 [n, canvas, canvas, 3], heights i32 [n],
            widths i32 [n]); heights and widths are the decoded sizes
        :raises FileNotFoundError: when a file cannot be opened or decoded"""
        if canvas <= 0:
            raise ValueError(f"canvas {canvas}")
        n = len(paths)
        out = np.zeros((n, canvas, canvas, 3), dtype=np.uint8)
        heights = np.zeros(n, dtype=np.int32)
        widths = np.zeros(n, dtype=np.int32)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        ok = self._lib.cl_load_batch(
            self._pool, c_paths, n, canvas,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        with _calls_lock:
            NativeCanvasLoader.load_batch.calls += 1
        if ok != n:
            bad = [paths[i] for i in range(n) if heights[i] == 0]
            raise FileNotFoundError(f"failed to decode {n - ok} images, e.g. {bad[:3]}")
        return out, heights, widths

    load_batch.calls = 0

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.cl_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
