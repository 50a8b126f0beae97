"""Some of ``chip_smoke.py``'s phases alone: in one checkout, or in two
checkouts in alternating processes on one card.

    python tests/torch_port_phases.py --phases 12 [--out DIR]
    python tests/torch_port_phases.py --phases 8,11 --trees PARENT_DIR,CHANGE_DIR \\
        --pairs 5 --out DIR

Phases: 8 (``check_training``, SSD300-VGG16), 11 (``check_heads``, FSSD and
RFB), 12 (``check_yolo``, YOLOv3 and YOLOv2), 13 (``check_zoo``,
SSD300-ResNet50, SSD512-VGG16 and the serving export), 16 (``check_ddp``,
data-parallel SSDLite-MobileNetV2-300), 17 (``check_observability``), 18
(``check_spatial``, SSD300-VGG16 on the spatial axis) and 19
(``check_spatial_heads``, FSSD and YOLO on it) and 20 (``check_parity``, the
mAP-parity harness on phase 8's checkpoint, which it runs first when 8 is
not asked for). Each process runs from a
checkout's root with that checkout's ``chip_smoke.py`` and port, builds the
kernels and turns TF32 off as ``chip_smoke.main`` does, runs the phases in
the order given and writes their numbers to ``DIR/{pair}-{tree}.json``
(``DIR/phases.json`` with one checkout). With two checkouts the one that
runs first alternates (A B, B A, ...), and the medians and quartiles over
the pairs of every phase's step and serving times are printed per
checkout. Needs a CUDA device; imports no JAX; not a test.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

PHASES = {"8": ("training", "check_training"), "11": ("heads", "check_heads"),
          "12": ("yolo", "check_yolo"), "13": ("zoo", "check_zoo"), "16": ("ddp", "check_ddp"),
          "17": ("observability", "check_observability"), "18": ("spatial", "check_spatial"),
          "19": ("spatial_heads", "check_spatial_heads"), "20": ("parity", "check_parity")}
TIMES = ("train_step_ms", "eval_img_s", "predict_b1_p50_ms", "predict_b1_p90_ms",
         "predict_batch32_img_s")


def one(phases, out):
    """Run ``phases`` of the ``chip_smoke.py`` in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from ssds_tpu_torch.ops.cuda import _build
    from ssds_tpu_torch.tools import card_line

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _build.load()
    report = {"card": card}
    keep = tempfile.mkdtemp(prefix="phases_")  # phase 8's checkpoint, for phase 20
    try:
        for p in phases:
            key, fn = PHASES[p]
            if p == "20" and "training" not in report:  # it works on phase 8's checkpoint
                report["training"] = chip_smoke.check_training(0, dev, card, chip_smoke.log,
                                                               keep_dir=keep)
            if p == "8":
                report[key] = chip_smoke.check_training(0, dev, card, chip_smoke.log,
                                                        keep_dir=keep)
            elif p == "20":
                report[key] = chip_smoke.check_parity(0, dev, card, chip_smoke.log,
                                                      report["training"]["checkpoint"],
                                                      report["training"]["test_map"])
            else:
                report[key] = getattr(chip_smoke, fn)(0, dev, card, chip_smoke.log)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1, default=str)


def times(report):
    """``{"phase/model/metric": value}`` of a report's step and serving times."""
    out = {}
    for key, r in report.items():
        if key == "card":
            continue
        models = {key: r} if "train_step_ms" in r else r
        for name, m in models.items():
            if isinstance(m, dict):
                out.update({f"{key}/{name}/{t}": m[t] for t in TIMES if t in m})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="12", help="comma-separated: 8, 11, 12, 13")
    parser.add_argument("--trees", default="", help="one or two checkouts, comma-separated "
                        "(default: this one)")
    parser.add_argument("--pairs", type=int, default=1)
    parser.add_argument("--out", default="chiprun_out/phases")
    parser.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if args.one:
        return one(phases, args.one)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    trees = [os.path.abspath(t) for t in args.trees.split(",")] if args.trees else [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    rows = {t: [] for t in trees}
    for pair in range(1, args.pairs + 1):
        for tree in (trees if pair % 2 else trees[::-1]):
            name = os.path.basename(tree) if len(trees) > 1 else "phases"
            path = os.path.join(out, f"{pair}-{name}.json" if len(trees) > 1 else f"{name}.json")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--phases",
                                   args.phases, "--one", path], cwd=tree)
            print(f"pair {pair} {name}: rc {proc.returncode}", flush=True)
            if proc.returncode:
                raise SystemExit(proc.returncode)
            with open(path) as f:
                rows[tree].append(times(json.load(f)))
    for tree, reports in rows.items():
        print(os.path.basename(tree))
        for k in reports[0]:
            v = [r[k] for r in reports]
            print(f"  {k}: median {np.median(v):.3f}, quartiles {np.percentile(v, 25):.3f} / "
                  f"{np.percentile(v, 75):.3f}, min {min(v):.3f}, max {max(v):.3f}")


if __name__ == "__main__":
    main()
