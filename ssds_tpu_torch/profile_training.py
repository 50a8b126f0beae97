"""Where the training time goes on the card: ``python -m ssds_tpu_torch.profile_training``.

The training counterpart of :mod:`ssds_tpu_torch.profile_serving` (and of the
JAX package's ``tools/step_profile.py``). On the default SSD300-VGG16 config
(bf16 forward, SGD with momentum and weight decay; ``--model lite``,
``fssd``, ``rfb``, ``yolo_v3``, ``yolo_v2``, ``resnet50``, ``ssd512``:
SSDLite-MobileNetV2-300, FSSD-VGG16-300, RFBNet-VGG16-300, YOLOv3-DarkNet53-416,
YOLOv2-DarkNet19-416, SSD300-ResNet50, SSD512-VGG16 with their yml's SGD,
``config.MODELS``; a YOLO step's loss is
``yolo_loss`` / ``yolo_v2_loss``, the latter with its warm-up on) it runs
the train step of
:func:`ssds_tpu_torch.solver.build_train_step` at ``--batch`` (default 32) over
one batch drawn with :mod:`ssds_tpu_torch.tools.synth_voc` (1-3 GT boxes an
image), and reports:

- the step's split (CUDA events between the stages, mean of ``--iters``
  steps after warm-up): upload (pinned, non-blocking), forward (mean
  subtraction and the bf16 model), the loss (float32: match + MultiBox, or
  the YOLO loss), backward, optimizer; and the step on the host clock,
  synchronised;
- the loss's forward alone at the step's shapes, and for the SSD heads match
  (``ops.matching.match_batch``) and the hard-negative ranks
  (``ops.losses.hard_negative_ranks``) alone (device time: launches queued
  behind a sleep kernel), the candidates for a hand-written kernel;
- over a ``torch.profiler`` window of whole steps: the device's busy share
  (summed kernel time over wall time, an upper bound where kernels overlap),
  the top kernels by device time, and every kernel's time summed by kind
  (:data:`KINDS`: convolutions and GEMMs, BatchNorm, layout transposes and
  copies, the rest);
- for a head that computes part of its work in float32 whatever the compute
  dtype (FSSD's fusion BN, pyramid and predictors,
  ``FLOAT32_MODULES``): that part's forward and backward alone at the
  step's shapes, as it runs (float32) and, for comparison only, under bf16
  autocast.

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

STAGES = ("upload", "forward", "loss", "backward", "optimizer")
# kernel kinds, by the first pattern found in a kernel's name (lower case)
KINDS = (("conv_gemm", ("conv", "gemm", "xmma", "wgrad", "dgrad", "cutlass", "sm90_", "sm80_")),
         ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
         ("layout", ("transpose", "nchwtonhwc", "nhwctonchw", "permute", "copy")))


def kernel_kinds(kernels, iters: int) -> dict:
    """Device ms a step of each kind of :data:`KINDS` (and ``other``)."""
    out = {k: 0.0 for k, _ in KINDS}
    out["other"] = 0.0
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, pats in KINDS if any(p in name for p in pats)), "other")
        out[kind] += e.device_time_total / 1e3 / iters
    return out


def float32_region(solver, batch: dict, iters: int) -> dict:
    """FSSD's float32 part (fusion BN, pyramid, predictors) alone at the
    step's shapes: forward and backward from the fused map, device ms, as it
    runs (autocast off, float32) and under bf16 autocast."""
    from ssds_tpu_torch.models.heads.common import multibox, run_layers, run_extras
    from ssds_tpu_torch.tools import time_cuda_queued

    model = solver.model
    dev = solver._upload(batch)
    with torch.no_grad(), torch.autocast("cuda", dtype=solver.compute_dtype):
        x = (dev["images"].float() - solver.means).permute(0, 3, 1, 2).contiguous()
        sources, x = run_layers(model.base, model.taps, x)
        run_extras(model.extras, model.extra_blocks, x, sources)
        fused = model.fuse(sources)
    fused.requires_grad_()

    def part():
        sources = model.run_pyramid(model.norm(fused))
        loc, conf = multibox(sources, model.loc, model.conf, model.num_classes)
        (loc.float().sum() + conf.float().sum()).backward()

    def part_bf16():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = model.norm(fused).bfloat16()
            sources = []
            for layer in model.pyramids:
                y = layer(y)
                sources.append(y)
            loc, conf = multibox(sources, model.loc, model.conf, model.num_classes)
        (loc.float().sum() + conf.float().sum()).backward()

    return {"fused_shape": list(fused.shape), "fused_dtype": str(fused.dtype),
            "float32_ms": time_cuda_queued(part, iters),
            "bf16_autocast_ms": time_cuda_queued(part_bf16, iters)}


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

    from ssds_tpu_torch.ops.losses import hard_negative_ranks
    from ssds_tpu_torch.ops.matching import match_batch
    from ssds_tpu_torch.solver import apply_gradients, detection_loss, forward_raw
    from ssds_tpu_torch.tools import time_cuda_queued

    model, opt, priors = solver.model, solver.optimizer, solver.priors
    clip = float(solver.cfg.TRAIN.OPTIMIZER.get("CLIP_GRADIENT", 0.0) or 0.0)
    model.train()
    seen = solver.step * int(batch["images"].shape[0])  # a YOLOv2 loss's warm-up: on at step 0

    def step(events=None):
        """The train step of ``build_train_step``, with a mark between stages."""
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        dev = solver._upload(batch)
        mark(1)
        out = forward_raw(model, dev["images"], solver.means, solver.compute_dtype)
        mark(2)
        ll, lc = detection_loss(model, priors, out, dev, seen_images=seen)
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
        out = forward_raw(model, dev["images"], solver.means, solver.compute_dtype)
        parts = {"loss_forward_ms": time_cuda_queued(
            lambda: detection_loss(model, priors, out, dev, seen_images=seen), iters)}
        if priors is not None:
            loc, conf = out
            _, conf_t = match_batch(dev["boxes"], dev["labels"], dev["valid"], priors)
            loss_c = torch.logsumexp(conf.float(), -1) - torch.gather(
                conf.float(), 2, conf_t[..., None])[..., 0]
            parts["match_ms"] = time_cuda_queued(
                lambda: match_batch(dev["boxes"], dev["labels"], dev["valid"], priors), iters)
            parts["hard_negative_ranks_ms"] = time_cuda_queued(
                lambda: hard_negative_ranks(loss_c), iters)

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
    if getattr(model, "FLOAT32_MODULES", ()):
        parts["float32_region"] = float32_region(solver, batch, iters)
    return {
        "batch": int(batch["images"].shape[0]), "iters": iters,
        "loss_l": float(ll.detach()), "loss_c": float(lc.detach()),
        "split_ms": split, "split_sum_ms": float(sums.sum() / iters),
        "step_host_ms_mean": float(np.mean(host)), "step_host_ms_min": float(np.min(host)),
        "img_s": float(batch["images"].shape[0] / np.mean(host) * 1e3),
        "parts": parts,
        "device_busy_share_upper_bound": busy_us / wall_us,
        "device_ms_per_step": busy_us / 1e3 / iters,
        "kernel_kinds_ms": kernel_kinds(kernels, iters),
        "top_kernels": [{"name": e.key[:100], "calls": e.count,
                         "device_ms": e.device_time_total / 1e3 / iters} for e in kernels[:25]],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="vgg",
                        choices=("vgg", "lite", "fssd", "rfb", "yolo_v3", "yolo_v2", "resnet50",
                                 "ssd512"))
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="", help="also write every number to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training: needs a GPU (torch.cuda.is_available() is False)")

    from ssds_tpu_torch.config import MODELS, default_config
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools import card_line

    card = card_line()
    cfg = default_config()  # VOC, bf16 forward, SGD
    name, make = MODELS[args.model]
    src = make()
    cfg.MODEL.update(src.MODEL)
    cfg.TRAIN.OPTIMIZER.update(src.TRAIN.OPTIMIZER)
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
    print("  alone: " + ", ".join(f"{k} {v:.3f}" for k, v in r["parts"].items()
                                  if isinstance(v, float)))
    if "float32_region" in r["parts"]:
        f = r["parts"]["float32_region"]
        print(f"  float32 part (fusion BN, pyramid, head) forward+backward on {f['fused_shape']}: "
              f"{f['float32_ms']:.3f} ms as run, {f['bf16_autocast_ms']:.3f} ms under bf16 "
              "autocast (comparison only)")
    print("  device ms a step by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["kernel_kinds_ms"].items()))
    for k in r["top_kernels"][:15]:
        print(f"  {k['device_ms']:8.3f} ms  x{k['calls'] // args.iters:<4} {k['name']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
    return r


if __name__ == "__main__":
    main()
