"""Shared helpers of the benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

The cells run here at a tiny size (64 px, a batch of 4, a VGG head cut to
three maps); the card's tests carry the ``cuda`` marker and skip without a
card (``python -m pytest benchmark/tests -m cuda`` on the card's machine).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SEED = 3_000_000_019  # over 32 signed bits, as seeds of real runs may be


def tiny_cell(name: str, half_precision: bool = True) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` at a size the CPU runs in seconds."""
    cell = harness.load_cell(name)
    m = cell["config_file"]["cfg"]["MODEL"]
    m["IMAGE_SIZE"] = [64, 64]
    m["HALF_PRECISION"] = half_precision
    if m["SSDS"] == "ssd":
        m.update(FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                 ASPECT_RATIOS=[[2], [2, 3], [2]], SIZES=[0.2, 0.95])
    t = cell["traffic_file"]
    t.update(batch=4, pool=4)
    for k in ("warmup_calls", "trace_calls", "warmup_steps", "trace_steps"):
        if k in t:
            t[k] = 1
    if "check_calls" in t:
        t["check_calls"] = 2
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card's machine with -m cuda)")
    return "cuda"
