"""Where the training time goes on the card: ``python -m ssds_tpu_torch.profile_training``.

The training counterpart of :mod:`ssds_tpu_torch.profile_serving` (and of the
JAX package's ``tools/step_profile.py``). On the default SSD300-VGG16 config
(bf16 forward, SGD with momentum and weight decay; ``--model lite``:
SSDLite-MobileNetV2-300 with its yml's SGD) it runs the train step of
:func:`ssds_tpu_torch.solver.build_train_step` at ``--batch`` (default 32) over
one batch drawn with :mod:`ssds_tpu_torch.tools.synth_voc` (1-3 GT boxes an
image), and reports:

- the step's split (CUDA events between the stages, mean of ``--iters``
  steps after warm-up): upload (pinned, non-blocking), forward (mean
  subtraction and the bf16 model), match + MultiBox loss (float32),
  backward, optimizer; and the step on the host clock, synchronised;
- match (``ops.matching.match_batch``), the hard-negative ranks
  (``ops.losses.hard_negative_ranks``) and the loss's forward, each alone at
  the step's shapes (device time: launches queued behind a sleep kernel), the
  candidates for a hand-written kernel;
- over a ``torch.profiler`` window of whole steps: the device's busy share
  (summed kernel time over wall time, an upper bound where kernels overlap)
  and the top kernels by device time.

Needs a GPU; ``--out`` also writes every number as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

STAGES = ("upload", "forward", "match_loss", "backward", "optimizer")


def synth_batch(batch: int, size: int, max_gt: int, seed: int) -> dict:
    """``batch`` images of :func:`synth_voc.sample` with their GT, collated
    as the loader collates them (VOC's 1-based pixel boxes to [0, 1])."""
    from ssds_tpu_torch.data.factory import detection_collate
    from ssds_tpu_torch.data.voc import VOC_CLASSES
    from ssds_tpu_torch.tools.synth_voc import sample

    samples = []
    for i in range(batch):
        img, objects = sample(seed, i, size)
        t = np.array([[(x1 - 1) / size, (y1 - 1) / size, (x2 - 1) / size, (y2 - 1) / size,
                       VOC_CLASSES.index(name)] for name, x1, y1, x2, y2 in objects], np.float32)
        samples.append((img, t, (size, size)))
    return detection_collate(samples, max_gt)


def profile_step(solver, batch: dict, iters: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssds_tpu_torch.ops.losses import hard_negative_ranks, multibox_loss
    from ssds_tpu_torch.ops.matching import match_batch
    from ssds_tpu_torch.solver import apply_gradients, forward_raw
    from ssds_tpu_torch.tools import time_cuda_queued

    model, opt, priors = solver.model, solver.optimizer, solver.priors
    clip = float(solver.cfg.TRAIN.OPTIMIZER.get("CLIP_GRADIENT", 0.0) or 0.0)
    model.train()

    def step(events=None):
        """The train step of ``build_train_step``, with a mark between stages."""
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        dev = solver._upload(batch)
        mark(1)
        loc, conf = forward_raw(model, dev["images"], solver.means, solver.compute_dtype)
        mark(2)
        ll, lc = multibox_loss(loc, conf, dev["boxes"], dev["labels"], dev["valid"], priors)
        mark(3)
        opt.zero_grad(set_to_none=True)
        (ll + lc).backward()
        mark(4)
        apply_gradients(opt, solver.lr_schedule(solver.step), clip)
        mark(5)
        return ll, lc, dev

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    sums = np.zeros(len(STAGES))
    host = []
    for _ in range(iters):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
        t0 = time.perf_counter()
        ll, lc, dev = step(events)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        sums += [events[i].elapsed_time(events[i + 1]) for i in range(len(STAGES))]
    split = dict(zip(STAGES, (sums / iters).tolist()))

    # the kernel candidates alone, at the step's shapes
    with torch.no_grad():
        loc, conf = forward_raw(model, dev["images"], solver.means, solver.compute_dtype)
        _, conf_t = match_batch(dev["boxes"], dev["labels"], dev["valid"], priors)
        loss_c = torch.logsumexp(conf.float(), -1) - torch.gather(
            conf.float(), 2, conf_t[..., None])[..., 0]
        parts = {
            "match_ms": time_cuda_queued(lambda: match_batch(dev["boxes"], dev["labels"],
                                                             dev["valid"], priors), iters),
            "hard_negative_ranks_ms": time_cuda_queued(lambda: hard_negative_ranks(loss_c), iters),
            "multibox_loss_forward_ms": time_cuda_queued(
                lambda: multibox_loss(loc, conf, dev["boxes"], dev["labels"], dev["valid"],
                                      priors), iters),
        }

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device rows, less the device spans of annotations (torch.optim's
    # "Optimizer.step#SGD.step"), which repeat their kernels' time
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.device_time_total, reverse=True)
    busy_us = sum(e.device_time_total for e in kernels)
    return {
        "batch": int(batch["images"].shape[0]), "iters": iters,
        "loss_l": float(ll.detach()), "loss_c": float(lc.detach()),
        "split_ms": split, "split_sum_ms": float(sums.sum() / iters),
        "step_host_ms_mean": float(np.mean(host)), "step_host_ms_min": float(np.min(host)),
        "img_s": float(batch["images"].shape[0] / np.mean(host) * 1e3),
        "parts": parts,
        "device_busy_share_upper_bound": busy_us / wall_us,
        "device_ms_per_step": busy_us / 1e3 / iters,
        "top_kernels": [{"name": e.key[:100], "calls": e.count,
                         "device_ms": e.device_time_total / 1e3 / iters} for e in kernels[:25]],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("vgg", "lite"), default="vgg")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="", help="also write every number to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a GPU (torch.cuda.is_available() is False)")

    from ssds_tpu_torch.config import default_config, ssd_lite_mobilenetv2_config
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools import card_line

    card = card_line()
    cfg = default_config()  # SSD300-VGG16, VOC, bf16 forward, SGD
    name = "SSD300-VGG16"
    if args.model == "lite":
        lite = ssd_lite_mobilenetv2_config()
        cfg.MODEL.update(lite.MODEL)
        cfg.TRAIN.OPTIMIZER.update(lite.TRAIN.OPTIMIZER)
        name = "SSDLite-MobileNetV2-300"
    cfg.TRAIN.BATCH_SIZE = args.batch
    with tempfile.TemporaryDirectory() as exp:
        cfg.EXP_DIR = exp
        solver = Solver(cfg, device="cuda", seed=args.seed)
        solver.build_state(steps_per_epoch=1)
        batch = synth_batch(args.batch, int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.DATASET.MAX_GT),
                            args.seed)
        r = profile_step(solver, batch, args.iters)
    r["card"] = card
    print(f"train step {name} bf16 batch {args.batch} ({card}): host "
          f"{r['step_host_ms_mean']:.3f} ms ({r['img_s']:.1f} img/s); events "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["split_ms"].items())
          + f" (sum {r['split_sum_ms']:.3f}); device busy <= "
          f"{r['device_busy_share_upper_bound']:.3f}, {r['device_ms_per_step']:.3f} device-ms "
          "a step", flush=True)
    print("  alone: " + ", ".join(f"{k} {v:.3f}" for k, v in r["parts"].items()))
    for k in r["top_kernels"][:15]:
        print(f"  {k['device_ms']:8.3f} ms  x{k['calls'] // args.iters:<4} {k['name']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    return r


if __name__ == "__main__":
    main()
