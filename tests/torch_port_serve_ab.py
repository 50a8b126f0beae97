"""SSD300-VGG16 serving times of two checkouts of the port, in alternating
processes on one card: ``chip_smoke.py`` phase 5's timing, repeated.

    python tests/torch_port_serve_ab.py --trees PARENT_DIR,CHANGE_DIR [--pairs 10]
        [--seed 0] [--out PATH]

Each round starts one process per checkout, the order turning every round
(A B, B A, A B, ...). A process imports ``ssds_tpu_torch`` from its
checkout, builds that checkout's ``ObjectDetector`` on the default config
(SSD300-VGG16, VOC, bf16, seeded random weights), serves the images of
``chip_smoke.py`` phase 4 once, then times as phase 5 does: batch-1
``predict`` latencies (50 after 10 warm-up) and batch-32 ``predict_batch``
img/s (10 batches after 2). Printed per checkout: the median, quartiles,
minimum and maximum over the rounds of the p50, the p90 and the img/s, with the card's
``nvidia-smi`` name and power limit. Needs a CUDA device; imports no JAX;
not a test.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def one(tree, seed):
    """Phase 5's times in this process, with ``tree``'s port."""
    sys.path.insert(0, tree)
    import torch

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector

    assert os.path.dirname(os.path.dirname(os.path.abspath(
        sys.modules["ssds_tpu_torch.config"].__file__))) == tree
    det = ObjectDetector(default_config(), device="cuda", seed=seed)
    hw = det.img_hw
    rng = np.random.default_rng(seed)
    singles = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(3)]
    batch4 = list(rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8))
    batch32 = list(rng.integers(0, 256, (32, *hw, 3), dtype=np.uint8))
    for img in singles:
        det.predict(img, threshold=0.01)
    det.predict_batch(batch4, threshold=0.01)
    det.predict_batch(batch32, threshold=0.01)
    for _ in range(10):
        det.predict(singles[0], threshold=0.01)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        det.predict(singles[0], threshold=0.01)  # synchronises before its device-to-host copy
        lat.append(time.perf_counter() - t0)
    for _ in range(2):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    ips = 10 * 32 / (time.perf_counter() - t0)
    return {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p90_ms": float(np.percentile(lat, 90)) * 1e3, "img_s": ips}


def summary(rows):
    out = {}
    for k in ("p50_ms", "p90_ms", "img_s"):
        v = [r[k] for r in rows]
        out[k] = {"median": float(np.median(v)), "q1": float(np.percentile(v, 25)),
                  "q3": float(np.percentile(v, 75)), "min": min(v), "max": max(v)}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", default="", help="two checkouts, comma-separated")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    parser.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.seed)), flush=True)
        return
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    assert len(trees) == 2, "--trees takes two checkouts"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    runs = {t: [] for t in trees}
    for i in range(args.pairs):
        for t in (trees if i % 2 == 0 else trees[::-1]):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", t,
                                "--seed", str(args.seed)],
                               capture_output=True, text=True, timeout=300, cwd=t)
            if p.returncode != 0:
                raise SystemExit(f"{t}: exit {p.returncode}\n{p.stderr[-4000:]}")
            r = json.loads(p.stdout.strip().splitlines()[-1])
            runs[t].append(r)
            print(f"round {i} {t}: p50 {r['p50_ms']:.3f} ms, p90 {r['p90_ms']:.3f} ms, "
                  f"{r['img_s']:.1f} img/s", flush=True)
    result = {"card": card, "pairs": args.pairs, "runs": runs,
              "summary": {t: summary(runs[t]) for t in trees}}
    for t in trees:
        s = result["summary"][t]
        print(f"{t} ({card}): " + "; ".join(
            f"{k} median {v['median']:.3f}, quartiles [{v['q1']:.3f}, {v['q3']:.3f}], range "
            f"[{v['min']:.3f}, {v['max']:.3f}]" for k, v in s.items()),
            flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
