"""The harness: one run of one cell of ``BENCHMARK.json``, as one process.

It finds everything by name, with no list of its own:

- the cell in ``BENCHMARK.json``'s ``workloads``;
- its configuration in ``benchmark/configs/<config>.json`` (the program's
  configuration tree, the source, the reference module's name);
- its traffic mix in ``benchmark/traffic/<traffic>.json`` (``kind`` names the
  runner, the module ``benchmark/<kind>.py``, :mod:`benchmark.train` so far;
  the rest are the runner's parameters);
- the limits of its correctness numbers in ``benchmark/limits/<cell>.json``;
- each per-layer metric that ``BENCHMARK.json`` gives the cell in
  ``benchmark/metrics/<metric>.py``, a module with ``read(run) -> float | None``.

A run sets up, measures for ``--seconds``, traces a short window of its own
when ``--trace 1`` (and then reads the per-layer metrics instead of the
end-to-end ones), frees the program, checks its outputs against the plain
reference, and prints one JSON line last on standard output.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
OUT_DIR = os.path.join(BENCH_DIR, "out")
FORBIDDEN = ("jax", "jaxlib", "flax", "ssds_tpu")  # whole top-level module names


class BenchError(RuntimeError):
    """A run that cannot give a result (a missing file, no card)."""


def read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic, limits and per-layer metrics."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise BenchError(f"BENCHMARK.json has no workload {name!r}")
    cell = dict(cells[0])
    cell["config_file"] = read_json(os.path.join(BENCH_DIR, "configs", f"{cell['config']}.json"))
    cell["traffic_file"] = read_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))
    cell["limits"] = read_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if "workloads" not in m or name in m["workloads"]]
    cell["per_layer"] = [m for m in bench["per_layer"] if name in m.get("workloads", ())
                         or ("workloads" not in m and
                             any(e["name"] == m["moves"] for e in cell["end_to_end"]))]
    return cell


def load_metric(name: str):
    """The reader module ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_config(tree: dict):
    """The program's configuration: its defaults with ``tree`` over them."""
    from ssds_tpu_torch.config import default_config

    def merge(a, b):
        for k, v in a.items():
            if isinstance(v, dict):
                merge(v, b[k])
            else:
                b[k] = v

    cfg = default_config()
    merge(tree, cfg)
    return cfg


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    """The first card's name, count and power limit."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=60, check=True)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


class Run:
    """What one run knows: the cell, the seed, the device, the timings, the
    program under test once set up, and what the trace found. The runners
    fill it; the metric readers read it."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str,
                 t_process: float):
        self.cell = cell
        self.name = cell["name"]
        self.config = cell["config_file"]
        self.traffic = cell["traffic_file"]
        self.tree = self.config["cfg"]  # the configuration as plain dicts (the reference's view)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_process = t_process
        from benchmark import reference

        self.ref = reference.load(self.config["reference"])
        self.metrics: Dict[str, dict] = {}
        self.program = None  # the program under test: the Solver
        self.window: dict = {}  # the measured window's numbers
        self.traced: Optional[dict] = None  # devtrace.summarise of the traced window
        self.extra: dict = {}  # what a runner hands its metric readers (freed with the program)
        self.kept: dict = {}  # what the check needs after the program is freed
        self.memory_peak = 0

    def out_path(self, suffix: str) -> str:
        return os.path.join(OUT_DIR, f"{self.name}.{self.seed}.{suffix}")

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free_program(self) -> None:
        self.program = None
        self.extra.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: Optional[float] = None) -> dict:
    """One run; returns the result's dict (the last line's keys, then
    ``check``: the numbers the cell's limits name, each with its limit).
    :func:`run_cell_numbers` also gives every number worked out."""
    return run_cell_numbers(cell, seed, seconds, trace, device, t_process)[0]


def run_cell_numbers(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
                     t_process: Optional[float] = None):
    """:func:`run_cell`'s result and every correctness number of the run."""
    from benchmark import judge

    run = Run(cell, seed, seconds, trace, device, t_process or time.perf_counter())
    kind = str(run.traffic["kind"])
    if not kind.isidentifier() or not os.path.isfile(os.path.join(BENCH_DIR, f"{kind}.py")):
        raise BenchError(f"traffic kind {kind!r} has no runner benchmark/{kind}.py")
    runner = importlib.import_module(f"benchmark.{kind}")
    runner.measure(run)
    if trace:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(run.out_path("kernels.json"), "w") as f:  # the tables, not metrics
            json.dump({"kinds_s": run.traced["kinds_s"], "kernels": run.traced["kernels"]}, f)
        for m in cell["per_layer"]:
            value = load_metric(m["name"]).read(run)
            if value is not None:
                run.metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    run.free_program()
    numbers, attempted = runner.check(run)
    correct, shown = judge.verdict(numbers, cell["limits"])
    device_info = card() if run.device.type == "cuda" else {
        "platform": run.device.type, "kind": run.device.type, "count": 1}
    device_info["memory_peak_bytes"] = run.memory_peak
    result = {"correct": bool(correct), "attempted": attempted, "failed": 0,
              "metrics": {}, "device": device_info}
    if trace:
        result["metrics"] = run.metrics
        t = run.traced
        device_info["busy_s"], device_info["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    else:
        wanted = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        result["metrics"] = {k: {"value": float(v), "unit": wanted[k]}
                             for k, v in run.window.items() if k in wanted}
        missing = set(wanted) - set(result["metrics"])
        if missing:
            raise BenchError(f"the run measured no {sorted(missing)}")
    result["check"] = shown
    return result, numbers


def main(argv: Optional[List[str]] = None, t_process: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False: this benchmark needs a GPU")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise BenchError(f"{args.workload} needs {cell['chips']} GPUs, "
                             f"{torch.cuda.device_count()} found")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    if result["correct"] is not True:
        print(f"benchmark: outputs are not correct", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

