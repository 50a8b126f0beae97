"""One float32 train step on the card against the same step on the CPU.

    python -m ssds_tpu_torch.tools.step_parity [--model vgg|lite|fssd|rfb|yolo_v3|yolo_v2|
                                                resnet50|ssd512]
        [--batch N] [--seed 0] [--out PATH]

The ``Solver``'s own train step (SGD, the config's LR, momentum and decay),
float32 with TF32 off, from one seed's weights, on one batch of the
synthetic VOC (``tools.synth_voc``, drawn in memory), first on the CPU and
then on the card. Compared: the two losses; each parameter's update (the LR
times SGD's momentum buffer, i.e. gradient plus decay, read before it is
rounded into the weights), as its error's norm over the CPU update's norm
and as its largest error over the largest update of the model; and each
running statistic after the step (BatchNorm models): a mean's error in
units of its channel's standard deviation, a variance's relative to itself.

Models (``config.MODELS``): ``vgg`` is SSD300-VGG16 (the default config),
``lite`` SSDLite-MobileNetV2-300, ``fssd`` FSSD-VGG16-300, ``rfb``
RFBNet-VGG16-300, ``yolo_v3`` YOLOv3-DarkNet53-416, ``yolo_v2``
YOLOv2-DarkNet19-416, ``resnet50`` SSD300-ResNet50 and ``ssd512`` SSD512-VGG16,
all at full width. Needs a CUDA device. ``tests/torch_port_step_causes.py`` runs
the same comparison under the changes that name the cause of a gap.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
from unittest import mock

import numpy as np
import torch


def config(model: str, root: str, exp: str):
    """The default config with the model and optimizer of ``config.MODELS[model]``,
    over the synthetic VOC tree at ``root``."""
    from ssds_tpu_torch.config import MODELS, default_config

    cfg = default_config()
    src = MODELS[model][1]()
    cfg.MODEL.update(src.MODEL)
    cfg.TRAIN.OPTIMIZER.update(src.TRAIN.OPTIMIZER)
    cfg.DATASET.update(DATASET_DIR=root, TRAIN_SETS=[["2007", "trainval"]],
                       TEST_SETS=[["2007", "test"]], PROB=-1, NUM_WORKERS=0)
    cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 0
    cfg.EXP_DIR, cfg.LOG_DIR = exp, os.path.join(exp, "logs")
    return cfg


def float32_solver(cfg, device, seed):
    """A ``Solver`` of ``cfg`` with the forward in float32."""
    from ssds_tpu_torch.solver import Solver

    cfg = copy.deepcopy(cfg)
    cfg.MODEL.HALF_PRECISION = False
    return Solver(cfg, device=device, seed=seed)


def step(solver, batch):
    """The solver's first train step on ``batch``: ``(losses, updates,
    statistics)``, all on the CPU."""
    solver.build_state(steps_per_epoch=1)
    m = solver.make_train_step()(solver._upload(batch), 0)
    lr = solver.optimizer.param_groups[0]["lr"]
    updates = {n: (lr * solver.optimizer.state[p]["momentum_buffer"]).cpu().double()
               for n, p in solver.model.named_parameters()}
    stats = {n: b.cpu().double() for n, b in solver.model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in m.items()}, updates, stats


def errors(got, want):
    """``got`` against ``want``, two :func:`step` results: the measures of
    the module docstring. A running mean's error is taken in units of its
    channel's running standard deviation (what the normalisation divides by),
    a running variance's relative to itself."""
    (mg, ug, sg), (mc, uc, sc) = got, want
    umax = max(float(u.abs().max()) for u in uc.values())
    rel = {n: float((ug[n] - uc[n]).norm() / uc[n].norm()) for n in uc if uc[n].norm() > 0}
    glob = {n: float((ug[n] - uc[n]).abs().max()) / umax for n in uc}
    stat = {}
    for n in sc:
        scale = (sc[n[:-len("mean")] + "var"].sqrt() if n.endswith("running_mean") else sc[n])
        stat[n] = float(((sg[n] - sc[n]).abs() / scale).max())
    worst_rel, worst_glob = max(rel, key=rel.get), max(glob, key=glob.get)
    out = {"card": mg, "cpu": mc,
           "loss_rel_err": {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("loss_l", "loss_c")},
           "update_rel_err_max": rel[worst_rel], "update_rel_err_worst": worst_rel,
           "update_rel_err_median": float(np.median(list(rel.values()))),
           "update_err_over_max_update": glob[worst_glob], "update_err_worst": worst_glob}
    if stat:
        worst = max(stat, key=stat.get)
        out.update(stats_rel_err_max=stat[worst], stats_rel_err_worst=worst,
                   stats_rel_err_median=float(np.median(list(stat.values()))))
    return out


def compare(cfg, device, batch, seed):
    """The step on the CPU, then on ``device``: a dict of the losses on both
    (``card``, ``cpu``) and the errors (see :func:`errors`)."""
    cpu = step(float32_solver(cfg, "cpu", seed), batch)
    return errors(step(float32_solver(cfg, device, seed), batch), cpu)


def synthetic_batch(cfg, seed, batch_size):
    """``batch_size`` train images of the synthetic VOC tree at
    ``cfg.DATASET.DATASET_DIR`` (written by the caller), collated."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc

    with mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed)}):
        dataset = factory.load_data(cfg.DATASET, "train", cfg.MODEL.IMAGE_SIZE).dataset
        return factory.detection_collate([dataset[i] for i in range(batch_size)],
                                         int(cfg.DATASET.MAX_GT))


def describe(r):
    """One line of an :func:`errors` result."""
    extra = (f"; running statistics max {r['stats_rel_err_max']:.2e} "
             f"({r['stats_rel_err_worst']}), median {r['stats_rel_err_median']:.2e}"
             if "stats_rel_err_max" in r else "")
    return (f"loss rel err {r['loss_rel_err']['loss_l']:.2e} / {r['loss_rel_err']['loss_c']:.2e}; "
            f"update err/norm max {r['update_rel_err_max']:.2e} ({r['update_rel_err_worst']}), "
            f"median {r['update_rel_err_median']:.2e}; update err over the largest update "
            f"{r['update_err_over_max_update']:.2e} ({r['update_err_worst']}){extra}")


def run(model="vgg", batch_size=2, seed=0, device="cuda:0"):
    """:func:`compare` over a synthetic VOC tree written for it, TF32 off and
    cuDNN's benchmark off."""
    from ssds_tpu_torch.tools.synth_voc import write_voc

    with tempfile.TemporaryDirectory() as tmp, \
            torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                       allow_tf32=False):
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            root = os.path.join(tmp, "VOCdevkit")
            write_voc(root, seed, n_trainval=batch_size, n_test=1)
            cfg = config(model, root, os.path.join(tmp, "exp"))
            return compare(cfg, device, synthetic_batch(cfg, seed, batch_size), seed)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def main(argv=None):
    from ssds_tpu_torch.tools import card_line, need_cuda

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="vgg",
                        choices=("vgg", "lite", "fssd", "rfb", "yolo_v3", "yolo_v2", "resnet50",
                                 "ssd512"))
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    dev, card = need_cuda("step_parity"), card_line()
    print(f"card: {card}", flush=True)
    r = run(args.model, args.batch, args.seed, dev)
    print(f"step_parity {args.model} batch {args.batch}: {describe(r)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "model": args.model, "batch": args.batch, "results": r},
                      f, indent=1)


if __name__ == "__main__":
    main()
