"""The port's counterparts of the JAX package's ``tools/`` conv prototype.

- :mod:`~ssds_tpu_torch.tools.conv_bench` — the 3x3 stem conv kernel against
  cuDNN and its plain version (``tools/pallas_conv_bench.py``);
- :mod:`~ssds_tpu_torch.tools.conv_probes` — the 19 probes of the conv's
  pieces (``tools/pallas_conv_bisect*.py``, ``tools/pallas_elem_halo_probe.py``).

Both need a CUDA device. The helpers below time and name it.
"""

from __future__ import annotations

import subprocess

import torch


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


def need_cuda(tool: str) -> torch.device:
    """The first CUDA device; exits when there is none (these tools time the card)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: torch.cuda.is_available() is False: this tool needs a GPU")
    return torch.device("cuda:0")
