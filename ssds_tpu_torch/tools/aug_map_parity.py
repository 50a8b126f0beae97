"""Host against device augmentation at the mAP level, through the port's CLIs.

The port's counterpart of the repository's ``tools/aug_map_parity.py``.
``DATASET.DEVICE_AUG`` moves the augmentation from the host loader (which
then only resizes) into the train step on the device
(:mod:`ssds_tpu_torch.ops.augment_device`). Its draws are not the host's,
so equal statistics do not prove equal training; this check trains the
same 5-class generated VOC (``tests/test_multiclass_map_cli.py::make_multiclass_voc``,
100 images, train and test on the same set) twice with the same config and
steps but for ``DEVICE_AUG``, each through ``python -m ssds_tpu_torch.train``
and ``python -m ssds_tpu_torch.test``, and compares the two mAPs the test
CLI prints:

    python -m ssds_tpu_torch.tools.aug_map_parity [--epochs 120] [--lr-step 90] \\
        [--device cpu] [--workdir DIR] [--out result.json]

prints one JSON line ``{"map_host", "map_device", "delta", "epochs"}``. The
bars (``tests/test_torch_port_aug_map_parity.py``) are the JAX package's:
at 120 epochs with the LR step at 90, both mAPs at least 0.95 and
``|delta|`` at most 0.05.

The generator writes JPEGs with OpenCV and the datasets decode them with it,
so the check runs where OpenCV is installed (the CPU); the card's machine
has none, and ``chip_smoke.py`` does not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX package's tools/aug_map_parity.py CFG
CFG = """
MODEL:
  SSDS: ssd_lite
  NETS: mobilenet_v1_025
  IMAGE_SIZE: [96, 96]
  NUM_CLASSES: 21
  FEATURE_LAYER: [[11, 13], [128, 256]]
  ASPECT_RATIOS: [[2, 3], [2, 3]]
  SIZES: [0.2, 0.55, 0.9]
  HALF_PRECISION: False
TRAIN:
  MAX_EPOCHS: {epochs}
  CHECKPOINTS_EPOCHS: {epochs}
  BATCH_SIZE: 16
  TRAINABLE_SCOPE: ''
  OPTIMIZER: {{OPTIMIZER: sgd, LEARNING_RATE: 0.03, MOMENTUM: 0.9, WEIGHT_DECAY: 0.0}}
  LR_SCHEDULER: {{SCHEDULER: multi_step, STEPS: [{lr_step}], GAMMA: 0.2, WARM_UP_EPOCHS: 2}}
TEST: {{BATCH_SIZE: 16, TEST_SCOPE: [1000, 1001]}}
POST_PROCESS: {{NUM_CLASSES: 21, SCORE_THRESHOLD: 0.01, IOU_THRESHOLD: 0.5,
  MAX_DETECTIONS: 20, PRE_NMS_TOP_N: 1024}}
DATASET:
  DATASET: voc
  DATASET_DIR: {root}
  TRAIN_SETS: [['2007', 'trainval']]
  TEST_SETS: [['2007', 'test']]
  PROB: 0.6
  DEVICE_AUG: {device_aug}
  NUM_WORKERS: 2
  MAX_GT: 8
EXP_DIR: {exp}
LOG_DIR: {exp}/logs
RESUME_CHECKPOINT: ''
CHECKPOINTS_PREFIX: augpar
PHASE: ['train']
"""


def _cli(module: str, cfg_path: str, device: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", module, "--cfg", cfg_path, "--device", device],
                          capture_output=True, text=True, timeout=3600, cwd=REPO, env=env)


def run_one(device_aug: bool, workdir: str, epochs: int, lr_step: int,
            device: str = "cpu") -> float:
    """Write the data (once a ``workdir``), train and test through the
    port's CLIs on ``device``; returns the mAP the test CLI prints."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        from test_multiclass_map_cli import make_multiclass_voc
    finally:
        sys.path.remove(os.path.join(REPO, "tests"))

    root = os.path.join(workdir, "VOCdevkit")
    if not os.path.exists(root):
        make_multiclass_voc(root, n_images=100)
    tag = "device" if device_aug else "host"
    exp = os.path.join(workdir, f"exp_{tag}")
    cfg_path = os.path.join(workdir, f"cfg_{tag}.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, exp=exp, epochs=epochs, lr_step=lr_step,
                           device_aug=device_aug))
    for module in ("ssds_tpu_torch.train", "ssds_tpu_torch.test"):
        proc = _cli(module, cfg_path, device)
        if proc.returncode != 0:
            raise RuntimeError(f"{module} ({tag}) failed:\n" + proc.stdout[-2000:]
                               + proc.stderr[-2000:])
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("test: mAP=")]
    if not lines:
        raise RuntimeError(f"no mAP line from the test CLI ({tag}):\n" + proc.stdout[-2000:])
    return float(lines[-1].split("mAP=")[1])


def main(argv=None):
    ap = argparse.ArgumentParser(description="host against device augmentation, mAP through "
                                             "the port's train and test CLIs")
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--lr-step", type=int, default=90)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", default="", help="default: a new temporary directory")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="aug_map_parity_")
    os.makedirs(workdir, exist_ok=True)
    map_host = run_one(False, workdir, args.epochs, args.lr_step, args.device)
    print(f"# host-aug mAP = {map_host:.4f}", file=sys.stderr, flush=True)
    map_dev = run_one(True, workdir, args.epochs, args.lr_step, args.device)
    print(f"# device-aug mAP = {map_dev:.4f}", file=sys.stderr, flush=True)
    result = {"map_host": round(map_host, 4), "map_device": round(map_dev, 4),
              "delta": round(abs(map_host - map_dev), 4), "epochs": args.epochs}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
