"""How the cut YOLO recipe of ``chip_smoke.py`` phase 12 trains, for a few
epoch counts and two warm-ups: the one the ymls give (10 epochs counted over
the cut's 64 images) or the one phase 12 keeps (10 epochs' steps over
VOC07+12).

    python tests/torch_port_yolo_cut.py yolo_v3:3,yolo_v3:10,yolo_v2:20 [--warm-up yml|full]

Each spec ``model:epochs`` trains that model (``chip_smoke.head_config``:
the yml's model and recipe, bf16, 64 / 32 synthetic VOC images drawn at 416
px, the eval in the last epoch) and prints one JSON line: the epoch mean
losses, the eval losses and mAP, and for the checkpoint's eval-mode network
on four test images the raw outputs' largest magnitude, whether the decoded
boxes are finite and their largest magnitude, the scores above 0.01, and
the float32 forward on the card against the CPU (decoded boxes and scores).
Writes every line to ``chiprun_out/yolo_cut.json``. Needs a CUDA device;
imports no JAX; not a test.
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(kind, epochs, warm_up, dev):
    import chip_smoke
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.solver import Solver, forward_raw
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(0, 416)}):
        root, exp = os.path.join(tmp, "VOCdevkit"), os.path.join(tmp, "exp")
        write_voc(root, 0, 64, 32, size=416)
        cfg = chip_smoke.head_config(kind)(root, exp)
        cfg.TRAIN.update(MAX_EPOCHS=epochs, CHECKPOINTS_EPOCHS=epochs)
        if warm_up == "full":
            b = int(cfg.TRAIN.BATCH_SIZE)
            cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 10 * -(-16551 // b) / (64 // b)
        cfg.TEST.TEST_SCOPE = [epochs, epochs]
        w = chip_smoke.ScalarWriter()
        s = Solver(cfg, device=dev, writer=w, seed=0)
        t0 = time.perf_counter()
        s.train_model()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        test = s.get_loader("test").dataset
        imgs = torch.from_numpy(np.stack([test.pull_image(i) for i in range(4)])).to(dev)
        with torch.no_grad():
            s.model.eval()
            raw = forward_raw(s.model, imgs, s.means, torch.float32)
            boxes, scores = s.model.decode(raw, (416, 416))
        cfg32 = copy.deepcopy(cfg)
        cfg32.MODEL.HALF_PRECISION = False
        cfg32.RESUME_CHECKPOINT = os.path.join(exp, f"{cfg.CHECKPOINTS_PREFIX}_epoch_{epochs}.pth")
        x = imgs[:2].cpu()
        g = [a.cpu() for a in ObjectDetector(cfg32, device=dev).forward(x.to(dev))]
        c = ObjectDetector(cfg32, device="cpu").forward(x)
        row = dict(
            kind=kind, epochs=epochs, warm_up=warm_up, steps=s.step, seconds=seconds,
            warm_up_epochs=cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS, lr_last=s.lr_schedule(s.step - 1),
            train_loss=[l + cc for (_, l), (_, cc) in zip(w.scalars["loss_loc"],
                                                          w.scalars["loss_conf"])],
            eval_loss=(w.scalars["Eval/loss_loc"][-1][1], w.scalars["Eval/loss_conf"][-1][1]),
            mAP=w.scalars["Eval/mAP"][-1][1], raw_absmax=[float(r.abs().max()) for r in raw],
            boxes_finite=bool(torch.isfinite(boxes).all()), boxes_absmax=float(boxes.abs().max()),
            served=int((scores[..., 1:] > 0.01).sum()),
            f32_err=[float((a - b).abs().max()) for a, b in zip(g, c)],
            f32_box_rel=float(((g[0] - c[0]).abs() / (c[0].abs() + 1e-4)).max()))
        s.close()
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("specs", help="model:epochs, comma-separated (yolo_v3, yolo_v2)")
    parser.add_argument("--warm-up", choices=("yml", "full"), default="yml")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_yolo_cut: needs a GPU")
    sys.path.insert(0, REPO)
    from ssds_tpu_torch.ops.cuda import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    rows = []
    for spec in args.specs.split(","):
        kind, epochs = spec.split(":")
        rows.append(run(kind, int(epochs), args.warm_up, torch.device("cuda:0")))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "yolo_cut.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
