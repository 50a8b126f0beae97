"""The program's own spans in a traced window: device time, idle and launches by stage of the step.

``ssds_tpu_torch`` opens ``record_function`` spans while a profiler runs
(``solver.epoch``, ``solver.step``, ``solver.upload``, ``solver.host_read``
in ``Solver.train_epoch``; ``step.forward``, ``step.loss``,
``step.backward``, ``step.optimizer`` in its train step), all on the loop's
thread; the trace counts the steps and the blocking loss reads by their spans.
:func:`table` runs the traffic's ``trace_steps`` steps through
``train_epoch`` under ``torch.profiler`` inside the span :data:`WINDOW`,
writes the Chrome trace to the run's output folder, reads it, deletes it,
and hands the events to :func:`attribute`:

- only ``user_annotation`` events named ``solver.*`` / ``step.*`` on the
  window's thread are program spans (``Optimizer.step#SGD.step`` and the
  like are not);
- each device operation (kernel, memcpy, memset) starting in the window is
  tied to its launch by the ``correlation`` id of its ``cuda_runtime`` /
  ``cuda_driver`` call and charged to the innermost program span whose host
  interval holds the launch's start, also where another thread (the
  autograd engine's) launched it;
- each gap between device operations in the window is charged to the
  innermost program span at the gap's middle;
- what no program span holds goes to :data:`UNATTRIBUTED`.

The table, written to ``benchmark/out/<cell>.<seed>.spans.json`` and cached
on ``run.extra``, gives per step, for each span name: ``host_ms`` (its
spans' lengths) and ``self_ms`` (less the program spans inside them),
``busy_ms`` (the union of its operations' intervals), ``idle_ms`` and
``launches``; and the window's own ``window_ms``, ``busy_ms``, ``idle_ms``,
``launches``, and ``host_reads`` (``solver.host_read`` spans) a step. A
program without the spans (an older one) gives ``None``.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Callable, Dict, List, Optional

from benchmark.devtrace import DEVICE_CATS, merged

WINDOW = "portbench.spans"
PREFIXES = ("solver.", "step.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
FIELDS = ("host_ms", "self_ms", "busy_ms", "idle_ms", "launches")


class Innermost:
    """The innermost of nested spans (one thread's) at a time: a
    piecewise-constant owner over the boundaries of the spans."""

    def __init__(self, spans: List[dict]):
        self.times: List[float] = []
        self.owners: List[Optional[str]] = []
        stack: List[tuple] = []  # (name, end), ends clipped to the enclosing span's

        def mark(t):
            self.times.append(t)
            self.owners.append(stack[-1][0] if stack else None)

        for s in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1][1] <= s["ts"]:
                mark(stack.pop()[1])
            end = s["ts"] + s["dur"]
            stack.append((s["name"], min(end, stack[-1][1]) if stack else end))
            mark(s["ts"])
        while stack:
            mark(stack.pop()[1])

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.owners[i] if i >= 0 else None

    def self_us(self) -> Dict[str, float]:
        """Each name's time as the innermost span, in µs."""
        out: Dict[str, float] = {}
        for (a, name), b in zip(zip(self.times, self.owners), self.times[1:]):
            if name is not None:
                out[name] = out.get(name, 0.0) + b - a
        return out


def attribute(events: List[dict]) -> Optional[dict]:
    """The table of the :data:`WINDOW` span's events, per ``solver.step``
    span in it; ``None`` where it holds no step."""
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        raise RuntimeError(f"the profiler's trace has no {WINDOW!r} span")
    win = wins[0]
    lo, hi = win["ts"], win["ts"] + win["dur"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e
             and e["name"].startswith(PREFIXES) and (e["pid"], e["tid"]) == (win["pid"], win["tid"])
             and lo <= e["ts"] <= hi]
    steps = sum(e["name"] == "solver.step" for e in spans)
    if steps == 0:
        return None
    owner = Innermost(spans)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e and lo <= e["ts"] <= hi]

    rows = {n: dict.fromkeys(FIELDS, 0.0) for n in sorted({e["name"] for e in spans})}
    rows[UNATTRIBUTED] = dict.fromkeys(FIELDS, 0.0)
    intervals: Dict[str, list] = {n: [] for n in rows}
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        name = (owner.at(t) if t is not None else None) or UNATTRIBUTED
        intervals[name].append((e["ts"], e["ts"] + e["dur"]))
        rows[name]["launches"] += 1
    for name, iv in intervals.items():
        rows[name]["busy_ms"] = sum(b - a for a, b in merged(iv, lo, hi)) / 1e3
    busy = merged([iv for ivs in intervals.values() for iv in ivs], lo, hi)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            rows[owner.at((a + b) / 2) or UNATTRIBUTED]["idle_ms"] += (b - a) / 1e3
    for e in spans:
        rows[e["name"]]["host_ms"] += e["dur"] / 1e3
    for name, us in owner.self_us().items():
        rows[name]["self_ms"] = us / 1e3
    busy_ms = sum(b - a for a, b in busy) / 1e3
    return {
        "steps": steps,
        "window_ms": (hi - lo) / 1e3 / steps,
        "busy_ms": busy_ms / steps,
        "idle_ms": ((hi - lo) / 1e3 - busy_ms) / steps,
        "launches": len(dev) / steps,
        "host_reads": sum(e["name"] == "solver.host_read" for e in spans) / steps,
        "spans": {n: {k: v / steps for k, v in r.items()} for n, r in rows.items()},
    }


def profile(fn: Callable[[], None], path: str, cuda: bool) -> List[dict]:
    """Run ``fn`` under the profiler inside :data:`WINDOW`, write the Chrome
    trace to ``path``, read it and delete it; returns its events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def table(run) -> Optional[dict]:
    """The spans table of the run's program, traced once and cached on
    ``run.extra``; ``None`` for a program without its spans."""
    if "spans" in run.extra:
        return run.extra["spans"]
    run.extra["spans"] = None
    solver = run.program
    if run.traffic.get("kind") != "train" or solver is None:
        return None
    batches = run.kept["batches"]
    n = int(run.traffic["trace_steps"])
    run.synchronize()
    before = solver.step
    events = profile(lambda: solver.train_epoch([batches[k % len(batches)] for k in range(n)]),
                     run.out_path("spans_trace.json"), run.device.type == "cuda")
    tab = attribute(events)
    del events
    if tab is None:
        return None
    steps = solver.step - before
    if steps != tab["steps"]:
        raise RuntimeError(f"{steps} steps taken, {tab['steps']} solver.step spans traced")
    with open(run.out_path("spans.json"), "w") as f:
        json.dump(tab, f, indent=1)
    run.extra["spans"] = tab
    return tab


def stage_busy_ms(run, span: str) -> Optional[float]:
    """Device busy ms a step of the operations launched in ``span``."""
    tab = table(run)
    if tab is None or span not in tab["spans"]:
        return None
    return tab["spans"][span]["busy_ms"]
