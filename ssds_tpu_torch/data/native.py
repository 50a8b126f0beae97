"""ctypes bindings for the native crop sampler (``csrc/ssd_augment.cpp``).

Counterpart of :mod:`ssds_tpu.data.native`. ``csrc/ssd_augment.cpp`` is a
byte-identical copy of the JAX package's ``native/ssd_augment.cpp``: host C++
behind a C ABI (``ssd_sample_crop``, ``ssd_crop_boxes``) that runs the
augmentation's IoU-constrained crop retry loop with a xorshift64* RNG seeded
per call. Given the same seed, it samples the same crop as the JAX package's
library.

The library is compiled on first use with the JAX package's ``native/Makefile``
flags (so both compile the same arithmetic, fused multiply-adds included) into
``ssds_tpu_torch/_build/``, under a name keyed by the digest of the source,
the flags and the CPU's feature flags (``-march=native`` compiles for this
CPU); nothing outside the checkout is loaded. A failed build raises with
g++'s stderr: there is no silent fallback. The Python retry loop in
:func:`ssds_tpu_torch.data.augment._crop` is the plain version; it runs only
where :func:`available` is made to return False (the tests patch it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ssd_augment.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None
launches = 0  # ssd_sample_crop calls in this process


def _cpu_flags() -> bytes:
    """This CPU's feature flags (``-march=native`` compiles for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _cpu_flags())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libssd_augment_{digest.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The sampler's library, compiled on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            lib.ssd_sample_crop.restype = ctypes.c_int
            lib.ssd_sample_crop.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
            lib.ssd_crop_boxes.restype = None
            lib.ssd_crop_boxes.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


def available() -> bool:
    """True: the sampler is always built (a failed build raises)."""
    load()
    return True


def _boxes(boxes) -> np.ndarray:
    """``[n, 4]`` contiguous float32, checked before its pointer is passed."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be [n, 4], got {boxes.shape}")
    return boxes


def sample_crop(boxes: np.ndarray, width: int, height: int,
                seed: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Sample an IoU-constrained crop of a ``width x height`` image holding
    ``boxes`` ([n, 4] pixel corners): ``(roi [4] float32, centre mask [n]
    bool)``, or None for the reference's "no crop" mode."""
    global launches
    lib = load()
    boxes = _boxes(boxes)
    n = boxes.shape[0]
    roi = np.zeros(4, np.float32)
    mask = np.zeros(n, np.uint8)
    launches += 1
    hit = lib.ssd_sample_crop(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, int(width), int(height),
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF),
        roi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if not hit:
        return None
    return roi, mask.astype(bool)


def crop_boxes(boxes: np.ndarray, roi: np.ndarray) -> np.ndarray:
    """Boxes translated into ``roi`` and clipped to it (a new array)."""
    lib = load()
    out = _boxes(boxes).copy()
    roi = np.ascontiguousarray(roi, np.float32)
    if roi.shape != (4,):
        raise ValueError(f"roi must be [4], got {roi.shape}")
    lib.ssd_crop_boxes(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.shape[0],
                       roi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
