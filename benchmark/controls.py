"""Readings that set and test the limits of ``correct``: ``python3 benchmark/controls.py``.

For one cell, in one process, on the card (or, for the tests, on the CPU):

- ``program``: the sound program's numbers over many seeds, each a short run
  of the cell itself (the lower readings);
- ``control``: the same numbers of the control, which computes one step
  below the configuration's precision: the reference's step computed in
  float8 (convolutions on e4m3 operands, their gradients from an e5m2
  output gradient, per-tensor scales) put in the program's place (the upper
  readings);
- ``faults``: the numbers of the faults this cell can have, planted in the
  reference put in its place: each step's loss over half of the batch, the
  mean taken over the rest (a step that leaves the state unchanged reads 1
  by its definition and needs no run).

Writes every reading as JSON to ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import torch

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, inputs, judge, train  # noqa: E402
from benchmark.reference.layers import float32_exact  # noqa: E402
from benchmark.reference.optim import train_steps  # noqa: E402


def _numbers(cell: dict, seed: int, seconds: float, device: str) -> Dict[str, float]:
    return harness.run_cell_numbers(cell, seed, seconds, False, device)[1]


def program(cell: dict, seeds: List[int], seconds: float, device: str) -> list:
    return [dict(seed=s, **_numbers(cell, s, seconds, device)) for s in seeds]


def train_reference(cell: dict, seed: int, device: str, **variant) -> Dict[str, float]:
    """The reference in the program's place (``variant``: ``precision``,
    ``half_batch``) against the float32 reference, on the run's weights and
    first batches."""
    run = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
    t = run.traffic
    spec = run.ref.param_spec(run.tree)
    start = inputs.weights(run.ref, run.tree, seed, run.device)
    imgs = inputs.images(int(t["check_steps"]) * int(t["batch"]),
                         run.tree["MODEL"]["IMAGE_SIZE"], seed, run.device)
    batches = inputs.train_batches(imgs, int(t["batch"]), t["objects"], t["box_sides"],
                                   int(run.tree["MODEL"]["NUM_CLASSES"]) - 1,
                                   int(run.tree["DATASET"]["MAX_GT"]), seed)
    dev = [{k: torch.from_numpy(b[k]).to(run.device) for k in ("images", "boxes", "labels",
                                                                  "valid")} for b in batches]

    def steps(**kw):
        buffers = {k: v.clone() for k, v in start.items() if spec[k][1] in train.BUFFER_ROLES}
        params = {k: v.clone() for k, v in start.items() if k not in buffers}
        with float32_exact():
            return train_steps(run.ref, run.tree, params, buffers, dev, int(t["first_step"]),
                               int(t["steps_per_epoch"]), **kw)

    return judge.train_numbers(steps(**variant), steps())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--modes", default="program,control,faults")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: needs a GPU", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell["traffic_file"]["kind"] != "train":
        print(f"controls: {args.workload} is no training cell", file=sys.stderr)
        return 2
    out: Dict[str, object] = {"workload": args.workload, "device": harness.card()}
    for mode in args.modes.split(","):
        t0 = time.perf_counter()
        if mode == "program":
            out[mode] = program(cell, seeds, args.seconds, "cuda")
        elif mode == "control":
            out[mode] = [dict(seed=s, **train_reference(cell, s, "cuda", precision="fp8"))
                         for s in seeds]
        elif mode == "faults":
            out[mode] = {"half_batch": [dict(seed=s, **train_reference(cell, s, "cuda",
                                                                       half_batch=True))
                                        for s in seeds]}
        else:
            raise SystemExit(f"unknown mode {mode!r}")
        print(f"{mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    summary = {}
    for mode in ("program", "control"):
        if mode in out:
            summary[mode] = {k: [min(r[k] for r in out[mode]), max(r[k] for r in out[mode])]
                             for k in out[mode][0] if k != "seed"}
    if "faults" in out:
        summary["faults"] = {f: {k: [min(r[k] for r in rs), max(r[k] for r in rs)]
                                 for k in rs[0] if k != "seed"} for f, rs in out["faults"].items()}
    out["summary"] = summary
    print(json.dumps(summary, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
