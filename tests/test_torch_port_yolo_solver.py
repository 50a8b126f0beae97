"""The port's Solver on the YOLO heads (CPU): its YOLO branch end to end, the
CLIs, and (``slow``) the planted-box oracle of ``tests/test_yolo_overfit.py``
run through the port's Solver.

The models are ``tests/test_torch_port_yolo_train.py``'s small YOLOv3 and
YOLOv2 over MobileNetV1-0.25 at 64 px. No tolerances: the detector's rows
are compared exactly with the solver's (the same weights, the same float32
forward), the rest are structural checks and the oracle's bars (its loss
falls by half, a detection above 0.2 on the planted box with IoU above 0.5,
as in the JAX test).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssds_tpu_torch import solver as tsolver
from ssds_tpu_torch.config import cfg_from_file, default_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.solver import Solver
from test_solver_e2e import make_voc
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_yolo_train import SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


CFG = """
MODEL:
  SSDS: {ssds}
  NETS: mobilenet_v1_025
  IMAGE_SIZE: [64, 64]
  NUM_CLASSES: 21
  FEATURE_LAYER: {feature_layer}
  ASPECT_RATIOS: {aspect_ratios}
  ANCHORS: {anchors}
  HALF_PRECISION: False
TRAIN:
  MAX_EPOCHS: {epochs}
  CHECKPOINTS_EPOCHS: 1
  BATCH_SIZE: 4
  TRAINABLE_SCOPE: 'base,norm,extras,loc,conf'
  OPTIMIZER: {{OPTIMIZER: sgd, LEARNING_RATE: 0.001, MOMENTUM: 0.9, WEIGHT_DECAY: 0.0005}}
  LR_SCHEDULER: {{SCHEDULER: sgdr, WARM_UP_EPOCHS: 1}}
TEST: {{BATCH_SIZE: 4, TEST_SCOPE: [1, 2]}}
POST_PROCESS: {{NUM_CLASSES: 21, IOU_THRESHOLD: 0.45, MAX_DETECTIONS: 20}}
DATASET:
  DATASET: voc
  DATASET_DIR: {root}
  TRAIN_SETS: [['2007', 'trainval']]
  TEST_SETS: [['2007', 'test']]
  PROB: -1
  NUM_WORKERS: 0
  MAX_GT: 8
EXP_DIR: {exp}
LOG_DIR: {exp}/logs
CHECKPOINTS_PREFIX: yolo
PHASE: ['train', 'eval']
"""


def _write_cfg(tmp_path, ssds, epochs):
    net, image, feature_layer, aspect_ratios, anchors = SMALL[ssds]
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    if not os.path.exists(root):
        make_voc(root, n_images=8)
    path = str(tmp_path / f"{ssds}.yml")
    with open(path, "w") as f:
        f.write(CFG.format(ssds=ssds, feature_layer=feature_layer, aspect_ratios=aspect_ratios,
                           anchors=anchors, epochs=epochs, root=root, exp=exp))
    return path, exp


@pytest.mark.parametrize("ssds", ["yolo_v3", "yolo_v2"])
def test_yolo_solver_trains_evaluates_resumes_and_deploys(ssds, tmp_path, monkeypatch):
    """The Solver's YOLO branch on the CPU: no priors; two epochs of two
    steps with the eval of each (loss and mAP from one forward, rows through
    ``detect_decoded``); YOLOv2's warm-up counts ``step * batch`` seen
    images, and after a resume from epoch 2 the step (and that count) starts
    at 2 epochs' steps, as the JAX solver's ``state.step``; ``test_model``
    on the checkpoint; ``ObjectDetector`` rows equal to the solver's."""
    seen = []
    real_v2 = tsolver.yolo_v2_loss

    def v2_loss(*args, seen_images=float("inf"), **kw):
        seen.append(seen_images)
        return real_v2(*args, seen_images=seen_images, **kw)

    monkeypatch.setattr(tsolver, "yolo_v2_loss", v2_loss)
    path, exp = _write_cfg(tmp_path, ssds, epochs=2)
    cfg = cfg_from_file(path)
    s = Solver(cfg, device="cpu", writer=_Writer())
    try:
        assert s.is_yolo and s.priors is None
        s.train_model()
        evals = s.writer.scalars["Eval/mAP"]
        assert [e for e, _ in evals] == [1, 2] and all(0.0 <= m <= 1.0 for _, m in evals)
        assert all(np.isfinite(v) for vals in s.writer.scalars.values() for _, v in vals)
        assert s.step == 4
    finally:
        s.close()
    if ssds == "yolo_v2":  # 4 train steps at batch 4, then the evals' inf (warm-up off)
        assert [x for x in seen if x != float("inf")] == [0, 4, 8, 12]
    seen.clear()
    cfg.TRAIN.MAX_EPOCHS = 3
    resumed = Solver(cfg, device="cpu", writer=_Writer())
    try:
        resumed.train_model()
        assert resumed.start_epoch == 2 and resumed.step == 6
        if ssds == "yolo_v2":
            assert [x for x in seen if x != float("inf")] == [16, 20]
        assert 0.0 <= resumed.test_model() <= 1.0
        imgs = np.stack([resumed.get_loader("test").dataset.pull_image(i) for i in range(2)])
        want = resumed.make_eval_forward()(torch.from_numpy(imgs))
    finally:
        resumed.close()
    cfg.RESUME_CHECKPOINT = os.path.join(exp, "yolo_epoch_3.pth")
    det = ObjectDetector(cfg, device="cpu")
    rows = det.detect_rows(imgs)
    assert det.priors is None and rows.shape == (2, 21, 20, 5)
    assert torch.equal(rows, want)


class _Writer:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append((step, float(value)))


def test_yolo_train_then_test_cli(tmp_path):
    """YOLOv3 through ``python -m ssds_tpu_torch.train`` / ``.test``: 47 BNs'
    buffers (27 in MobileNetV1-0.25, 20 in the head) in the checkpoint and
    restored by the test CLI, which evaluates."""
    path, exp = _write_cfg(tmp_path, "yolo_v3", epochs=1)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")

    def cli(module):
        proc = subprocess.run([sys.executable, "-m", module, "--cfg", path, "--device", "cpu"],
                              env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc.stdout

    out = cli("ssds_tpu_torch.train")
    assert "epoch 1/1" in out and "eval epoch 1:" in out
    sd = torch.load(os.path.join(exp, "yolo_epoch_1.pth"), weights_only=True)["state_dict"]
    assert sum(k.endswith("running_var") for k in sd) == 47
    out = cli("ssds_tpu_torch.test")
    assert f"resume: loaded {len(sd)}/{len(sd)} variables" in out
    assert 0.0 <= float(out.split("test: mAP=")[1].split()[0]) <= 1.0


# --------------------------------------------------------------------------
# the planted-box oracle (tests/test_yolo_overfit.py through the Solver)
# --------------------------------------------------------------------------


def _oracle_batch(b=2):
    """``tests/test_yolo_overfit.py::synth_batch`` as uint8 images: its -60 /
    90 pixels are 0 / 150 less the means (60, 60, 60)."""
    rng = np.random.default_rng(3)
    images = np.zeros((b, 64, 64, 3), np.uint8)
    boxes = np.zeros((b, 2, 4), np.float32)
    valid = np.zeros((b, 2), bool)
    for i in range(b):
        x1, y1 = rng.uniform(0.15, 0.35, 2)
        w, h = rng.uniform(0.3, 0.4, 2)
        x2, y2 = min(x1 + w, 0.9), min(y1 + h, 0.9)
        px = (np.array([x1, y1, x2, y2]) * 64).astype(int)
        images[i, px[1]:px[3], px[0]:px[2], :] = 150
        boxes[i, 0] = [x1, y1, x2, y2]
        valid[i, 0] = True
    return {"images": torch.from_numpy(images), "boxes": torch.from_numpy(boxes),
            "labels": torch.zeros((b, 2), dtype=torch.int32), "valid": torch.from_numpy(valid)}


def _iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


@pytest.mark.slow
@pytest.mark.parametrize("ssds", ["yolo_v3", "yolo_v2"])
def test_yolo_oracle_recovers_planted_box(ssds, tmp_path):
    """``tests/test_yolo_overfit.py`` through the port's Solver: one class,
    Adam 3e-3 with the gradient clipped to norm 5, 150 float32 steps on one
    batch of two images, then the eval forward through ``detect_decoded``
    (score threshold 0.2, IoU 0.45, 10 detections): the loss falls by half
    and image 0's best detection of the class covers its box."""
    net, image, feature_layer, _, anchors = SMALL[ssds]
    cfg = default_config()
    cfg.MODEL.update(SSDS=ssds, NETS=net, IMAGE_SIZE=[image, image], NUM_CLASSES=2,
                     FEATURE_LAYER=feature_layer, ANCHORS=anchors, HALF_PRECISION=False)
    cfg.TRAIN.update(TRAINABLE_SCOPE="")
    cfg.TRAIN.OPTIMIZER.update(OPTIMIZER="adam", LEARNING_RATE=3e-3, WEIGHT_DECAY=0.0,
                               CLIP_GRADIENT=5.0)
    cfg.TRAIN.LR_SCHEDULER.update(SCHEDULER="step", GAMMA=1.0, WARM_UP_EPOCHS=0)
    cfg.POST_PROCESS.update(NUM_CLASSES=3, SCORE_THRESHOLD=0.2, IOU_THRESHOLD=0.45,
                            MAX_DETECTIONS=10)
    cfg.DATASET.PIXEL_MEANS = (60, 60, 60)
    cfg.EXP_DIR = str(tmp_path)
    s = Solver(cfg, device="cpu", writer=_Writer())
    s.build_state(steps_per_epoch=1)
    step = s.make_train_step()
    batch = _oracle_batch()
    losses = []
    for i in range(150):
        m = step(batch, i)
        if i % 25 == 0:
            losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] / 2, losses
    dets = s.make_eval_forward()(batch["images"]).numpy()
    best = dets[0, 1, 0]  # image 0, class 1 (label 0 after the background)
    iou = _iou(best[1:], batch["boxes"][0, 0].numpy())
    print(f"{ssds}: losses {losses}; best detection {best}, IoU with the planted box {iou:.4f}")
    assert best[0] > 0.2 and iou > 0.5, (best, iou)
