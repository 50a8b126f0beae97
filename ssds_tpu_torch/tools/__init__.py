"""The port's counterparts of the JAX package's ``tools/`` conv prototype.

- :mod:`~ssds_tpu_torch.tools.conv_bench` — the 3x3 stem conv kernel against
  cuDNN and its plain version (``tools/pallas_conv_bench.py``);
- :mod:`~ssds_tpu_torch.tools.conv_probes` — the 19 probes of the conv's
  pieces (``tools/pallas_conv_bisect*.py``, ``tools/pallas_elem_halo_probe.py``);
- :mod:`~ssds_tpu_torch.tools.nms_bench` — the serving path's NMS kernel
  against its bound and its plain version.

All need a CUDA device. The helpers below time and name it.
"""

from __future__ import annotations

import subprocess
import time

import torch


BF16_OPS_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_OPS_S = 67e12    # H100 SXM float32 peak outside the tensor cores
HBM_B_S = 3.35e12    # H100 SXM HBM3


def roofline_ms(ops: float, nbytes: float, ops_s: float = BF16_OPS_S):
    """(ms, "operations" or "bytes"): the least time the card could take, the
    larger of ``ops`` at ``ops_s`` and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / ops_s, nbytes / HBM_B_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cuda_queued(fn, iters: int, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches queued
    behind a sleep kernel (CUDA events). The host enqueues every launch while
    the card sleeps, so the events see the kernels back to back and not the
    host's launch rate, which :func:`time_cuda` sees for a kernel shorter than
    its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (3 * enqueue_s + 1e-3)))  # cycles: >= 3x the enqueue at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 1000, warmup: int = 20) -> float:
    """Host microseconds per call of ``fn()``: ``calls`` calls back to back on
    the host clock, one synchronise at the end (launch cost, where a call's
    device work is shorter than its host work)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def need_cuda(tool: str) -> torch.device:
    """The first CUDA device; exits when there is none (these tools time the card)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: torch.cuda.is_available() is False: this tool needs a GPU")
    return torch.device("cuda:0")
