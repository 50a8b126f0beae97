"""Build the port's CUDA sources into one shared library, loaded with ctypes.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into a library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
``ssds_tpu_torch/_build/``. The file name carries a hash of the sources and
the flags, so an edit rebuilds it. Nothing is taken from outside the
checkout: no prebuilt library, no download. A failed build raises with
nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# -fmad=false: no multiply-add contraction, so float results are bit-equal to
# the plain PyTorch versions (see csrc/nms.cu). Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # filled by load(): path, seconds, ptxas report


class StencilArgs(ctypes.Structure):
    """``struct StencilArgs`` of csrc/stencil.cu, passed by value."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("b", "h", "w", "c", "out_rows", "out_cols", "wmode", "n")] + [
                    ("dr", ctypes.c_int * 8), ("dw", ctypes.c_int * 8)]


class ConvArgs(ctypes.Structure):
    """``struct ConvArgs`` of csrc/int8_conv.cu, passed by value."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "b", "h", "w", "cp", "cout", "kh", "kw", "ho", "wo", "sh", "sw", "ph", "pw", "dh", "dw",
        "relu", "out_kind", "bn", "vec")]


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build "
                       "the port's CUDA kernels")


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libssds_kernels_{digest.hexdigest()[:16]}.so")


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return proc.stderr.strip()


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc, sources = _nvcc(), _sources()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        reports = list(pool.map(_run, [[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                                       for src, obj in zip(sources, objs)]))
    _run([nvcc, "-shared", "-o", tmp, *objs])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_info.update(seconds=time.perf_counter() - t0, ptxas="\n".join(reports))


def load() -> ctypes.CDLL:
    """The kernels' library, compiled on first use; declares every C entry point."""
    global _lib
    if _lib is not None:  # the launch path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            lib.ssds_nms_mask.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p]
            lib.ssds_nms_mask.restype = ctypes.c_int
            lib.ssds_nms_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            lib.ssds_nms_plan.restype = None
            lib.ssds_conv_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [
                ctypes.c_void_p]
            lib.ssds_conv_rows.restype = ctypes.c_int
            lib.ssds_row_stencil.argtypes = [ctypes.c_void_p, ctypes.c_void_p, StencilArgs,
                                             ctypes.c_void_p]
            lib.ssds_row_stencil.restype = ctypes.c_int
            lib.ssds_quantize_act.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p] + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            lib.ssds_quantize_act.restype = ctypes.c_int
            lib.ssds_int8_conv.argtypes = [ctypes.c_void_p] * 6 + [ConvArgs, ctypes.c_void_p]
            lib.ssds_int8_conv.restype = ctypes.c_int
            build_info["path"] = path
            _lib = lib
        return _lib
