"""The yardstick's constants and timing: the H100's bf16 peak, CUDA-event and queued timing.

The peak is NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
(no sparsity). A share of a peak is stated with the card's power limit
beside it (the run's ``device`` names it).
"""

from __future__ import annotations

import time

import torch

BF16_OPS_S = 989e12  # bf16 tensor-core peak


def events_ms(fn, iters: int) -> float:
    """Mean milliseconds between CUDA events around ``iters`` calls of ``fn``
    (host work between the events counts where the card waits for it)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches queued
    behind a sleep kernel, so the events see the kernels back to back and
    not the host's launch rate."""
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
