"""The device trace of a short window: busy time, the top device operations, idle gaps.

A window of whole calls (or steps) runs under ``torch.profiler`` (CPU and
CUDA activities) inside one named span; its Chrome trace is written to the
run's output folder, read back and deleted. From it:

- ``busy_s``: the union of the intervals in which a device operation
  (kernel, memcpy, memset) ran, inside the span: overlapping kernels count
  once, so this is the busy time and not the summed kernel time;
- ``window_s``: the span's length;
- ``device_ops``: device time summed by operation name, most first;
- ``idle_gaps``: the gaps between device operations inside the span, summed
  by what the host was doing at each gap's middle (the innermost CPU
  operation there; else the innermost named span, marked as host code);
- ``kinds``: device time by kind of kernel (:data:`KINDS`, by the first
  pattern found in the lower-cased name; the rest is ``other``).
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN = "portbench.window"
KINDS = (("conv_gemm", ("conv", "gemm", "xmma", "wgrad", "dgrad", "cutlass", "sm90_", "sm80_")),
         ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
         ("layout", ("transpose", "nchwtonhwc", "nhwctonchw", "permute", "copy")))


def profile(fn: Callable[[], None], path: str) -> dict:
    """Run ``fn`` under the profiler inside :data:`SPAN`, write the Chrome
    trace to ``path``, read it and delete it; returns :func:`summarise`'s dict."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fn()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarise(events)


def merged(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``(start_us, end_us)`` intervals clipped to ``[lo, hi]``,
    as disjoint intervals in order."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, pats in KINDS if any(p in low for p in pats)), "other")


class _Host:
    """What the host was doing at a time: the innermost CPU operation that
    spans it (the latest-starting one, operations being nested), else the
    innermost named span."""

    SCAN = 4000  # operations looked back at, at most, from a time

    def __init__(self, host: List[dict]):
        self.ops = sorted((e for e in host if e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.ops]
        self.spans = [e for e in host if e.get("cat") == "user_annotation" and e["name"] != SPAN]

    def name(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for e in reversed(self.ops[max(0, i - self.SCAN):i]):
            if e["ts"] + e["dur"] >= t:
                return e["name"]
        spans = [e for e in self.spans if e["ts"] <= t <= e["ts"] + e["dur"]]
        if spans:
            return "host code in " + min(spans, key=lambda e: e["dur"])["name"]
        return "host code"


def summarise(events: List[dict]) -> dict:
    spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"the profiler's trace has no {SPAN!r} span")
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e and lo <= e["ts"] <= hi]
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy = merged(intervals, lo, hi)
    by_name: Dict[str, List[float]] = {}
    kinds: Dict[str, float] = {k: 0.0 for k, _ in KINDS}
    kinds["other"] = 0.0
    for e in dev:
        if e["ts"] < lo or e["ts"] > hi:
            continue
        row = by_name.setdefault(e["name"], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"] / 1e6
        if e["cat"] == "kernel":
            kinds[kind_of(e["name"])] += e["dur"] / 1e6
    gaps: Dict[str, float] = {}
    at = _Host(host)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = at.name((a + b) / 2)
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    table = sorted(((n, c, s) for n, (c, s) in by_name.items()), key=lambda r: -r[2])
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": [[n, s] for n, _, s in table[:10]],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda r: -r[1])[:10],
        "kernels": [{"name": n, "calls": c, "seconds": s} for n, c, s in table],
        "kinds_s": kinds,
    }
