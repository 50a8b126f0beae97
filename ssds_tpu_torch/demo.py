"""Latency demo: ``python -m ssds_tpu_torch.demo [--cfg <yml>] -t time``.

Counterpart of the ``-t time`` mode of the repository's ``demo.py``: serve
one image 110 times through :meth:`ObjectDetector.predict` with
``check_time``, skip 10 warm-up requests, and print the per-stage times
every 20 requests and the p50 / p90 latency and frames per second at the
end. Without ``--demo`` the image is random uint8 at the model's input size
(so no resize runs); with ``--demo`` it is read by the COCO dataset's image
hook (OpenCV) and resized on the host with numpy. Without ``--cfg``
the model is the default SSD300-VGG16 (VOC, 21 classes) with seeded random
weights. The ``image``, ``video`` and ``camera`` modes are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ssds_tpu_torch demo (time mode)")
    parser.add_argument("--cfg", dest="config_file", default="", type=str,
                        help="YAML config (default: SSD300-VGG16 defaults)")
    parser.add_argument("--demo", dest="demo_file", default="", type=str, help="image path")
    parser.add_argument("-t", dest="type", default="time", choices=["time"])
    parser.add_argument("--threshold", default=0.45, type=float)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--seed", default=0, type=int, help="random-weight and image seed")
    return parser.parse_args(argv)


def demo(argv=None):
    args = parse_args(argv)
    from ssds_tpu_torch.config import cfg_from_file, default_config
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = cfg_from_file(args.config_file) if args.config_file else default_config()
    detector = ObjectDetector(cfg, device=args.device, seed=args.seed)
    if args.demo_file:
        from ssds_tpu_torch.data.coco import COCODetection

        img = COCODetection._read_image((args.demo_file, None))
    else:
        h, w = detector.img_hw
        img = np.random.default_rng(args.seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    lat = []
    for i in range(110):
        t0 = time.perf_counter()
        _, times = detector.predict(img, args.threshold, check_time=True)
        dt = time.perf_counter() - t0
        if i >= 10:  # skip warm-up
            lat.append(dt)
        if i % 20 == 0:
            print({k: f"{v * 1000:.2f}ms" for k, v in times.items()})
    lat = np.asarray(lat)
    print(f"p50={np.percentile(lat, 50) * 1000:.2f}ms "
          f"p90={np.percentile(lat, 90) * 1000:.2f}ms "
          f"fps={1.0 / lat.mean():.1f} ({len(lat)} requests, device {args.device})")


if __name__ == "__main__":
    demo()
