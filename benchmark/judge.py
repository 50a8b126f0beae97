"""The numbers that decide ``correct``, worked out from the program's outputs and the reference's.

Training (the first steps that the window's call made, from the same
weights and batches):

- ``loss_gap``: the widest relative gap of a step's loss term (loc or conf);
- ``grad_gap``: for each leaf, the gap between the norms of the first
  step's momentum buffer (the gradient as SGD takes it, decay included),
  over the larger of the reference's norm of that leaf and of the median
  leaf; the widest;
- ``change_gap``: the same for the change of each leaf over the steps, the
  running statistics included, leaving out a parameter whose first
  gradient in the reference is under a thousandth of the median leaf's;
- ``grad_mean_gap`` and ``change_mean_gap``: the mean over the leaves of
  the gaps whose widest ``grad_gap`` and ``change_gap`` are;
- ``loss1_gap`` and ``change_median_gap``: the first step's loss gap and the
  relative gap of the median leaf's change.

Where one leaf's gap swings from seed to seed, or the later steps amplify
small gaps, the means and the first step stay steady; the limits file of a
cell says which numbers it compares.

The reference follows only those first steps. The window's own steps are
judged by their end state, exactly (limit 0):

- ``window_nonfinite``: the window's mean losses and leaves that are not
  finite (a NaN or an infinity at any step of the window reaches the
  epoch's mean);
- ``window_unmoved``: leaves left bit for bit as they were when the window
  began, among those that the program's first steps moved (the running
  statistics included; the window's learning rate is the larger, so each of
  them moves again unless the window's steps leave the state alone).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

EXCLUDE_BELOW = 1e-3  # of the median leaf's first gradient


def relative_gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> List[float]:
    """Each leaf's gap, over the larger of its reference norm and the median leaf's."""
    keys = list(keys)
    if not keys:
        return [0.0]
    median = float(np.median([ref[k] for k in keys]))
    return [relative_gap(prog[k], ref[k], max(median, 1e-30)) for k in keys]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: ``losses`` ``[(l, c)]``, ``buf1`` and ``change`` a leaf;
    ``ref``: the same and ``grad1``."""
    loss_gap = max(relative_gap(p, r, 1e-12) for pl, rl in zip(prog["losses"], ref["losses"])
                   for p, r in zip(pl, rl))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    grad_median = float(np.median(list(ref["grad1"].values())))
    moved = [k for k in ref["change"]
             if k not in ref["grad1"] or ref["grad1"][k] >= EXCLUDE_BELOW * grad_median]
    median = float(np.median([ref["change"][k] for k in moved]))
    grad = leaf_gaps(prog["buf1"], ref["buf1"], ref["buf1"])
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap,
            "loss1_gap": max(relative_gap(p, r, 1e-12)
                             for p, r in zip(prog["losses"][0], ref["losses"][0])),
            "grad_gap": max(grad), "grad_mean_gap": float(np.mean(grad)),
            "change_gap": max(change), "change_mean_gap": float(np.mean(change)),
            "change_median_gap": relative_gap(
                float(np.median([prog["change"][k] for k in moved])), median, 1e-30)}


def window_numbers(window: dict) -> Dict[str, float]:
    """``window``: the window's mean ``losses``, the names of the leaves
    found ``nonfinite`` after it, and of those the first steps moved that
    it left ``unmoved``."""
    bad_losses = sum(not math.isfinite(v) for v in window["losses"].values())
    return {"window_nonfinite": float(bad_losses + len(window["nonfinite"])),
            "window_unmoved": float(len(window["unmoved"]))}


def excluded_leaves(ref: dict) -> List[str]:
    grad_median = float(np.median(list(ref["grad1"].values())))
    return [k for k, g in ref["grad1"].items() if g < EXCLUDE_BELOW * grad_median]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit (a NaN fails)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    shown = {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in shown.values())  # NaN compares False
    return ok, shown
