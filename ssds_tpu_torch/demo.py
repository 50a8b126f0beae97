"""Demo CLI: ``python -m ssds_tpu_torch.demo [--cfg <yml>] [--demo <path>] -t image|video|camera|time``.

Counterpart of the repository's ``demo.py`` (reference ``demo.py``):

``image``
    detect on the image ``--demo``, draw the boxes and class scores, write
    ``<name>_out.jpg`` beside it;
``video`` / ``camera``
    detect on every frame of the video ``--demo`` (or of camera 0), draw,
    write ``<name>_out.avi`` (video mode), and show the frames with
    ``--display`` (``q`` stops);
``time``
    serve one image 110 times through :meth:`ObjectDetector.predict` with
    ``check_time``, skip 10 warm-up requests, print the per-stage times
    every 20 requests and the p50 / p90 latency and frames per second.
    Without ``--demo`` the image is random uint8 at the model's input size
    (so no resize runs).

The image, video and camera modes read, draw and write with OpenCV, which
they import when they run: a machine without it (the card's) raises a clear
error there and runs the ``time`` mode, which needs none. Boxes are labelled
with the VOC class names when the dataset is VOC. Without ``--cfg`` the
model is the default SSD300-VGG16 (VOC, 21 classes) with seeded random
weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0), (255, 0, 255),
    (0, 255, 255), (128, 0, 0), (0, 128, 0), (0, 0, 128), (128, 128, 0),
    (128, 0, 128), (0, 128, 128), (64, 0, 0), (0, 64, 0), (0, 0, 64),
    (64, 64, 0), (64, 0, 64), (0, 64, 64), (192, 0, 0), (0, 192, 0),
]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="ssds_tpu_torch demo")
    parser.add_argument("--cfg", dest="config_file", default="", type=str,
                        help="YAML config (default: SSD300-VGG16 defaults)")
    parser.add_argument("--demo", dest="demo_file", default="", type=str,
                        help="image or video path")
    parser.add_argument("-t", dest="type", default="image",
                        choices=["image", "video", "camera", "time"])
    parser.add_argument("--display", action="store_true", help="show the video frames")
    parser.add_argument("--threshold", default=0.45, type=float)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--seed", default=0, type=int, help="random-weight and image seed")
    return parser.parse_args(argv)


def _cv2(mode: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"demo mode {mode!r} reads, draws and writes with OpenCV (cv2), "
                           "which is not installed; the 'time' mode needs none") from e
    return cv2


def draw(img, boxes, labels, scores, class_names=None):
    """Draw each box (thickness 2) and ``name:score`` above it on ``img`` in
    place, in the class's colour; returns ``img`` (the repository's
    ``demo.py::draw``)."""
    cv2 = _cv2("draw")
    for box, label, score in zip(boxes, labels, scores):
        color = COLORS[int(label) % len(COLORS)]
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        cv2.rectangle(img, p1, p2, color, 2)
        name = class_names[int(label)] if class_names else str(int(label))
        cv2.putText(img, f"{name}:{score:.2f}", (p1[0], max(0, p1[1] - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def run_image(detector, args, names):
    cv2 = _cv2("image")
    img = cv2.imread(args.demo_file, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read an image from {args.demo_file!r}")
    boxes, labels, scores = detector.predict(img, args.threshold)
    img = draw(img, boxes, labels, scores, names)
    out = os.path.splitext(args.demo_file)[0] + "_out.jpg"
    cv2.imwrite(out, img)
    print(f"wrote {out} ({len(boxes)} detections)")
    return out


def run_video(detector, args, names):
    """Every frame of the video (or camera 0) detected and drawn; returns
    the frame count."""
    cv2 = _cv2(args.type)
    cap = cv2.VideoCapture(0 if args.type == "camera" else args.demo_file)
    writer, frames = None, 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            boxes, labels, scores = detector.predict(frame, args.threshold)
            frame = draw(frame, boxes, labels, scores, names)
            frames += 1
            if writer is None and args.type == "video":
                out = os.path.splitext(args.demo_file)[0] + "_out.avi"
                writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"XVID"),
                                         cap.get(cv2.CAP_PROP_FPS) or 25,
                                         (frame.shape[1], frame.shape[0]))
            if writer is not None:
                writer.write(frame)
            if args.display:
                cv2.imshow("ssds_tpu_torch", frame)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
    finally:
        cap.release()
        if writer is not None:
            writer.release()
        if args.display:
            cv2.destroyAllWindows()
    print(f"{frames} frames")
    return frames


def run_time(detector, args):
    from ssds_tpu_torch.utils.timer import Timer

    if args.demo_file:
        from ssds_tpu_torch.data.coco import COCODetection

        img = COCODetection._read_image((args.demo_file, None))
    else:
        h, w = detector.img_hw
        img = np.random.default_rng(args.seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    timer = Timer()
    lat = []
    for i in range(110):
        timer.tic()
        _, times = detector.predict(img, args.threshold, check_time=True)
        dt = timer.toc(average=False)
        if i >= 10:  # skip warm-up
            lat.append(dt)
        if i % 20 == 0:
            print({k: f"{v * 1000:.2f}ms" for k, v in times.items()})
    lat = np.asarray(lat)
    print(f"p50={np.percentile(lat, 50) * 1000:.2f}ms "
          f"p90={np.percentile(lat, 90) * 1000:.2f}ms "
          f"fps={1.0 / lat.mean():.1f} ({len(lat)} requests, device {args.device})")


def demo(argv=None):
    args = parse_args(argv)
    from ssds_tpu_torch.config import cfg_from_file, default_config
    from ssds_tpu_torch.detector import ObjectDetector

    if args.type in ("image", "video") and not args.demo_file:
        raise SystemExit(f"demo: -t {args.type} needs --demo <path>")
    if args.type != "time":
        _cv2(args.type)  # before the model is built
    cfg = cfg_from_file(args.config_file) if args.config_file else default_config()
    detector = ObjectDetector(cfg, device=args.device, seed=args.seed)
    names = None
    if cfg.DATASET.DATASET == "voc":
        from ssds_tpu_torch.data.voc import VOC_CLASSES

        names = VOC_CLASSES
    if args.type == "image":
        return run_image(detector, args, names)
    if args.type in ("video", "camera"):
        return run_video(detector, args, names)
    return run_time(detector, args)


if __name__ == "__main__":
    demo()
