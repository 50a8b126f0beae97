"""Everything a run feeds both sides, made from ``--seed``: weights, images, targets.

- Weights: one float32 state dict in the ssds.pytorch layout that a
  reference module's ``param_spec`` describes, drawn on the device by one
  ``torch.Generator`` in one call and scaled by each tensor's role, so that
  activations keep their scale through the depth (He-normal convs, the conv
  on the image scaled to pixel values, predictors with logits of about
  1.5, a residual branch's last BatchNorm scale at 0.3, running statistics
  measured on seeded images, :func:`weights`). They are no trained model's:
  every class scores about alike, so what a served batch would return
  (every class filling its slots) says nothing of a trained detector, and
  the benchmark serves none of them.
- Images: uint8 BGR ``[N, H, W, 3]``, smooth random fields (bilinear
  upsampling of a coarse uniform grid plus fine noise), drawn on the device.
- Targets: a batch in the program's loader format (``images`` uint8 NHWC,
  ``boxes`` ``[B, MAX_GT, 4]`` corner form, ``labels`` 0-based, ``valid``,
  ``sizes``). The objects an image run over ``objects = [lo, hi]`` once
  each, cycled and shuffled, so every seed has the same objects in all.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_SCALE = 64.0   # about the spread of a mean-subtracted pixel
HEAD_GAIN = 1.5      # the predictors' output spread for inputs of unit scale
RES_SCALE = 0.3      # a residual branch's last BatchNorm scale
BOX_SIZE_GAIN = 0.3  # YOLO's log box sizes against the anchors: a spread of about 0.4
IMAGE_STREAM = 0x9E3779B97F4A7C15  # offsets the image generator's seed from the weights'
CALIBRATION_IMAGES = 8


def weights(ref, tree: dict, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """The run's weights for the reference module ``ref`` at the
    configuration ``tree``: :func:`state_dict` of its ``param_spec``, with
    the BatchNorms' running statistics then set to the batch statistics of a
    float32 train-mode forward of :data:`CALIBRATION_IMAGES` seeded images,
    as a trained model's are, so that an eval-mode forward keeps the scale
    of its activations through the depth."""
    spec = ref.param_spec(tree)
    sd = state_dict(spec, seed, device)
    if any(role == "bn_mean" for _, role in spec.values()):
        from benchmark.reference.layers import Ops, float32_exact

        imgs = torch.from_numpy(images(CALIBRATION_IMAGES, tree["MODEL"]["IMAGE_SIZE"],
                                       seed + 1, device)).to(device)
        ops = Ops(sd, train=True)
        with torch.no_grad(), float32_exact():
            ref.forward(ops, ref.model_input(imgs, tree), tree)
        for name, (mean, var) in ops.bn_stats.items():
            sd[f"{name}.running_mean"] = mean.clone()
            sd[f"{name}.running_var"] = var.clone()
    return sd


def state_dict(spec: "OrderedDict[str, tuple]", seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """``spec``: name -> (shape, role) (a reference's ``param_spec``)."""
    numels = [math.prod(shape) for shape, _ in spec.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**64)
    z = torch.randn(sum(numels), generator=gen, device=device)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    offset = 0
    for (name, (shape, role)), n in zip(spec.items(), numels):
        t = z[offset:offset + n].view(shape)
        offset += n
        if role in ("conv", "conv_in", "conv_res_out"):
            fan_in = math.prod(shape[1:])
            t = t * (math.sqrt(2.0 / fan_in) / (PIXEL_SCALE if role == "conv_in" else 1.0))
        elif role in ("head", "yolo_head"):
            t = t * (HEAD_GAIN / math.sqrt(math.prod(shape[1:])))
            if role == "yolo_head":  # 3 anchors of (tx, ty, tw, th, obj, classes): narrower tw, th
                rows = torch.arange(shape[0], device=device) % (shape[0] // 3)
                t = t * torch.where((rows == 2) | (rows == 3), BOX_SIZE_GAIN, 1.0)[:, None, None, None]
        elif role == "bias":
            t = t * 0.05
        elif role in ("head_bias", "bn_bias", "bn_mean"):
            t = t * 0.1
        elif role == "l2norm":
            t = 20.0 * (1.0 + 0.05 * t)
        elif role == "bn_weight":
            t = 1.0 + 0.1 * t
        elif role == "bn_weight_res":
            t = RES_SCALE * (1.0 + 0.1 * t)
        elif role == "bn_var":
            t = torch.exp(0.2 * t)
        elif role == "bn_count":
            t = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"{name}: unknown role {role!r}")
        out[name] = t
    return out


def images(n: int, hw, seed: int, device) -> np.ndarray:
    """``n`` uint8 BGR images ``[n, H, W, 3]`` on the host, drawn on ``device``."""
    h, w = int(hw[0]), int(hw[1])
    gen = torch.Generator(device=device).manual_seed((int(seed) + IMAGE_STREAM) % 2**64)
    coarse = torch.rand((n, 3, max(1, h // 16), max(1, w // 16)), generator=gen, device=device)
    x = F.interpolate(coarse * 255.0, size=(h, w), mode="bilinear", align_corners=False)
    x = x + 24.0 * (torch.rand((n, 3, h, w), generator=gen, device=device) - 0.5)
    x = x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return x.cpu().numpy()


def object_counts(n: int, lo: int, hi: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(np.resize(np.arange(lo, hi + 1), n))


def train_batches(imgs: np.ndarray, batch: int, objects, box_sides, num_classes: int,
                  max_gt: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """``imgs`` cut into batches of ``batch``, each with its targets.
    ``num_classes`` counts the real classes (labels ``0 .. num_classes - 1``)."""
    rng = np.random.default_rng(int(seed))
    n, h, w = imgs.shape[:3]
    counts = object_counts(n, int(objects[0]), int(objects[1]), rng)
    if counts.max() > max_gt:
        raise ValueError(f"{counts.max()} objects an image, but MAX_GT is {max_gt}")
    lo, hi = float(box_sides[0]), float(box_sides[1])
    boxes = np.zeros((n, max_gt, 4), np.float32)
    labels = np.zeros((n, max_gt), np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i, k in enumerate(counts):
        c = rng.uniform(0.1, 0.9, (k, 2))
        side = rng.uniform(lo, hi, (k, 2))
        boxes[i, :k] = np.clip(np.concatenate([c - side / 2, c + side / 2], 1), 0.0, 1.0)
        labels[i, :k] = rng.integers(0, num_classes, k)
        valid[i, :k] = True
    sizes = np.tile(np.array([h, w], np.int32), (batch, 1))
    return [{"images": imgs[s:s + batch], "boxes": boxes[s:s + batch],
             "labels": labels[s:s + batch], "valid": valid[s:s + batch], "sizes": sizes}
            for s in range(0, n - batch + 1, batch)]
