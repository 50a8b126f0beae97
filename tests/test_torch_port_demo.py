"""The port's demo CLI (``python -m ssds_tpu_torch.demo``): its image, video and
camera modes on ``tests/test_demo_cli.py``'s pattern, on the CPU with the
tiny SSDLite there, and its ``draw`` against the repository's ``demo.py``.

Held: the image mode writes ``<name>_out.jpg``; the video mode writes one
annotated frame per frame read; the camera mode reads camera 0 (here
``cv2.VideoCapture(0)`` replayed from a file) frame by frame; ``draw`` gives
the repository's ``demo.draw`` image bit for bit on the same detections and
class names; without OpenCV the drawing modes raise a clear error (the
``time`` mode, which needs none: ``tests/test_torch_port_detector.py``).
"""

import importlib.util
import os
import sys
from unittest import mock

import cv2
import numpy as np
import pytest

from ssds_tpu_torch import demo
from ssds_tpu_torch.data.voc import VOC_CLASSES
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = """MODEL:
  SSDS: ssd_lite
  NETS: mobilenet_v1_025
  IMAGE_SIZE: [96, 96]
  NUM_CLASSES: 4
  FEATURE_LAYER: [[11, 13], [128, 256]]
  ASPECT_RATIOS: [[2], [2]]
  SIZES: [0.3, 0.6, 0.9]
  HALF_PRECISION: False
POST_PROCESS: {NUM_CLASSES: 4, MAX_DETECTIONS: 10}
PHASE: ['test']
"""


def _repo_demo():
    spec = importlib.util.spec_from_file_location("repo_demo", os.path.join(REPO, "demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(TINY)
    return str(path), tmp_path


def _video(path, frames=3, seed=1):
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"XVID"), 5, (160, 120))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8))
    w.release()


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_image_mode_writes_the_annotated_image(tiny, capsys):
    cfg, d = tiny
    img_path = str(d / "scene.jpg")
    cv2.imwrite(img_path, np.random.default_rng(0).integers(0, 255, (120, 160, 3), np.uint8))
    out = demo.demo(["--cfg", cfg, "--demo", img_path, "-t", "image", "--threshold", "0.0",
                     "--device", "cpu"])
    assert out == str(d / "scene_out.jpg") and os.path.exists(out)
    assert cv2.imread(out).shape == (120, 160, 3)
    assert "detections)" in capsys.readouterr().out


def test_video_mode_writes_one_frame_per_frame(tiny):
    cfg, d = tiny
    vid = str(d / "clip.avi")
    _video(vid)
    assert demo.demo(["--cfg", cfg, "--demo", vid, "-t", "video", "--device", "cpu"]) == 3
    out = str(d / "clip_out.avi")
    assert os.path.getsize(out) > 0 and _frames(out) == 3


def test_camera_mode_reads_camera_zero(tiny):
    cfg, d = tiny
    vid = str(d / "camera.avi")
    _video(vid, frames=2, seed=2)
    capture = cv2.VideoCapture
    opened = []

    def camera(src):
        opened.append(src)
        return capture(vid)
    with mock.patch.object(cv2, "VideoCapture", camera):
        assert demo.demo(["--cfg", cfg, "-t", "camera", "--device", "cpu"]) == 2
    assert opened == [0]


def test_draw_equals_the_repository_demo_draw():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (90, 130, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(-10, 80, (7, 2)), rng.uniform(40, 150, (7, 2))], 1)
    labels = rng.integers(0, 25, 7)
    scores = rng.uniform(0, 1, 7).astype(np.float32)
    ref = _repo_demo()
    for names in (None, VOC_CLASSES + tuple("xyzab")):
        want = ref.draw(img.copy(), boxes, labels, scores, names)
        assert np.array_equal(demo.draw(img.copy(), boxes, labels, scores, names), want)
    assert demo.COLORS == ref.COLORS


def test_drawing_modes_need_opencv(tiny):
    cfg, d = tiny
    with mock.patch.dict(sys.modules, {"cv2": None}):
        for mode in ("image", "video", "camera"):
            with pytest.raises(RuntimeError, match="OpenCV"):
                demo.demo(["--cfg", cfg, "--demo", str(d / "x.jpg"), "-t", mode,
                           "--device", "cpu"])
