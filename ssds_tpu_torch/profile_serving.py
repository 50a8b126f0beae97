"""Where the serving time goes on the card: ``python -m ssds_tpu_torch.profile_serving``.

For each batch size (default 1 and 32) it serves seeded random uint8 images
through :class:`~ssds_tpu_torch.detector.ObjectDetector` on the default
SSD300-VGG16 config (``--model lite``: SSDLite-MobileNetV2-300; ``fssd``:
FSSD-VGG16-300; ``rfb``: RFBNet-VGG16-300; ``yolo_v3``: YOLOv3-DarkNet53-416;
``yolo_v2``: YOLOv2-DarkNet19-416; ``resnet50``: SSD300-ResNet50; ``ssd512``:
SSD512-VGG16, ``config.MODELS``) and reports:

- stage times (CUDA events, mean of ``--iters`` after warm-up): host-to-device
  upload, the conv forward (mean subtraction to softmax, or to a YOLO head's
  decoded boxes and scores), ``detect`` (``detect_decoded`` for YOLO), the
  device-to-host copy, and the whole ``predict_batch`` on the host clock;
- the device's busy share over a ``torch.profiler`` window of whole
  ``predict_batch`` calls (summed kernel time over wall time; kernels may
  overlap, so it is an upper bound), the top kernels by device time, and
  the port's own kernels (:data:`OWN_KERNELS`) wherever they rank. Only the
  profiler's device rows are summed: an operator's row repeats the time of
  the kernels it launched.

Needs a GPU; ``--out`` also writes the full tables as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

OWN_KERNELS = ("nms_mask_kernel",)  # the serving path's hand-written kernels


def _events_ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_batch(det, batch, iters, seed):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    imgs = np.random.default_rng(seed).integers(0, 256, (batch, *det.img_hw, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(det.device)
    with torch.no_grad():
        for _ in range(3):
            det.predict_batch(list(imgs), threshold=0.01)
        out = det.forward(x)
        rows = det.postprocess(out)
        torch.cuda.synchronize()
        stages = {
            "upload_ms": _events_ms(lambda: torch.from_numpy(imgs).to(det.device), iters),
            "forward_ms": _events_ms(lambda: det.forward(x), iters),
            "detect_ms": _events_ms(lambda: det.postprocess(out), iters),
            "download_ms": _events_ms(lambda: rows.cpu(), iters),
        }
    t0 = time.perf_counter()
    for _ in range(iters):
        det.predict_batch(list(imgs), threshold=0.01)
    torch.cuda.synchronize()
    stages["predict_batch_ms"] = (time.perf_counter() - t0) / iters * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            det.predict_batch(list(imgs), threshold=0.01)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_us = sum(e.device_time_total for e in kernels)
    def row(e):
        return {"name": e.key[:100], "calls": e.count,
                "device_ms": e.device_time_total / 1e3 / iters}

    own = [row(e) for e in kernels if any(k in e.key for k in OWN_KERNELS)]
    return {"batch": batch, "stages": stages, "profiled_iters": iters,
            "device_busy_share_upper_bound": busy_us / wall_us,
            "device_ms_per_call": busy_us / 1e3 / iters,
            "top_kernels": [row(e) for e in kernels[:20]], "own_kernels": own}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="vgg",
                        choices=("vgg", "lite", "fssd", "rfb", "yolo_v3", "yolo_v2", "resnet50",
                                 "ssd512"))
    parser.add_argument("--batches", default="1,32")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="", help="also write the full tables to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: needs a GPU (torch.cuda.is_available() is False)")

    from ssds_tpu_torch.config import MODELS, default_config
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.update(MODELS[args.model][1]().MODEL)
    det = ObjectDetector(cfg, device="cuda", seed=args.seed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    results = []
    for b in (int(v) for v in args.batches.split(",")):
        r = profile_batch(det, b, args.iters, args.seed)
        results.append(r)
        s = r["stages"]
        print(f"{args.model} batch {b} ({card}): " + ", ".join(f"{k} {v:.3f}" for k, v in s.items())
              + f"; device busy <= {r['device_busy_share_upper_bound']:.3f}, "
              f"{r['device_ms_per_call']:.3f} device-ms per predict_batch", flush=True)
        for k in r["top_kernels"][:10]:
            print(f"  {k['device_ms']:8.3f} ms  x{k['calls'] // args.iters:<4} {k['name']}")
        for k in r["own_kernels"]:
            print(f"  {k['device_ms']:8.4f} ms  x{k['calls'] // args.iters:<4} {k['name']} "
                  "(the port's)")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
