"""YOLOv3 with the DarkNet-53 backbone, in plain PyTorch (Redmon & Farhadi, arXiv:1804.02767).

ssds.pytorch's ``yolo_v3_darknet_53``: every conv is conv (no bias) ->
BatchNorm -> leaky ReLU (slope 0.1), pad ``k // 2``. DarkNet-53 is a 3x3
stem of 32, then five stages, each a stride-2 3x3 conv and residual blocks
(1x1 to half the width, 3x3 back, plus the input): (64, 1), (128, 2),
(256, 8), (512, 8), (1024, 4). The sources are the ends of the last three
stages (strides 8, 16, 32). The head: at stride 32 a five-conv set of 512
(1x1, 3x3 of 1024, 1x1, 3x3, 1x1), a 3x3 of 1024 and the 1x1 predictor;
a 1x1 of 256 on the set's output, upsampled (bilinear) and joined to the
stride-16 source, a set of 256, a 3x3 of 512 and the predictor; likewise
128 onto stride 8. A predictor emits ``3 * (5 + C)`` channels a cell, C the
real classes (the loss decodes them, :func:`benchmark.reference.losses.yolo_decode`).
Parameter names are the program's ssds.pytorch layout
(``base.{i}``, ``extras_t32``, ``conf0`` ...).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

from benchmark.reference.layers import Ops, leaky, upsample2
from benchmark.reference.losses import yolo_loss

STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
ANCHORS = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)),
           ((116, 90), (156, 198), (373, 326)))  # pixels at 416, stride 8 first


def _cbl(spec, name, cin, cout, k, role="conv"):
    spec[f"{name}.0.weight"] = ((cout, cin, k, k), "conv_in" if name == "base.0" else role)
    bn_role = "bn_weight_res" if role == "conv_res_out" else "bn_weight"
    spec[f"{name}.1.weight"] = ((cout,), bn_role)
    spec[f"{name}.1.bias"] = ((cout,), "bn_bias")
    spec[f"{name}.1.running_mean"] = ((cout,), "bn_mean")
    spec[f"{name}.1.running_var"] = ((cout,), "bn_var")
    spec[f"{name}.1.num_batches_tracked"] = ((), "bn_count")


def _convset(spec, name, cin, ch):
    for i, cout in enumerate((ch, 2 * ch, ch, 2 * ch, ch)):
        _cbl(spec, f"{name}.ConvBNReLU_{i}", cin, cout, 3 if i % 2 else 1)
        cin = cout


def _backbone():
    """``(index, kind, cout)``: kind ``stem``, ``down`` or ``res``."""
    out, i = [(0, "stem", 32)], 1
    for ch, n in STAGES:
        out.append((i, "down", ch))
        i += 1
        for _ in range(n):
            out.append((i, "res", ch))
            i += 1
    return out


def num_classes(cfg) -> int:
    return int(cfg["MODEL"]["NUM_CLASSES"]) - 1  # the head predicts the real classes


def anchors(cfg, device) -> List[torch.Tensor]:
    table = cfg["MODEL"].get("ANCHORS") or ANCHORS
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in table]


def param_spec(cfg) -> "OrderedDict[str, Tuple[tuple, str]]":
    spec: "OrderedDict[str, Tuple[tuple, str]]" = OrderedDict()
    cin = 3
    widths = {}
    for i, kind, ch in _backbone():
        if kind == "res":
            _cbl(spec, f"base.{i}.ConvBNReLU_0", ch, ch // 2, 1)
            _cbl(spec, f"base.{i}.ConvBNReLU_1", ch // 2, ch, 3, role="conv_res_out")
        else:
            _cbl(spec, f"base.{i}", cin, ch, 3)
        cin = widths[i] = ch
    taps = [int(t) for t in cfg["MODEL"]["FEATURE_LAYER"][0]]
    c8, c16, c32 = (widths[t] for t in taps)
    out = 3 * (5 + num_classes(cfg))
    _convset(spec, "extras_t32", c32, 512)
    _cbl(spec, "extras_o32", 512, 1024, 3)
    spec["conf2.weight"], spec["conf2.bias"] = ((out, 1024, 1, 1), "yolo_head"), ((out,), "head_bias")
    _cbl(spec, "extras_r16", 512, 256, 1)
    _convset(spec, "extras_t16", 256 + c16, 256)
    _cbl(spec, "extras_o16", 256, 512, 3)
    spec["conf1.weight"], spec["conf1.bias"] = ((out, 512, 1, 1), "yolo_head"), ((out,), "head_bias")
    _cbl(spec, "extras_r8", 256, 128, 1)
    _convset(spec, "extras_t8", 128 + c8, 128)
    _cbl(spec, "extras_o8", 128, 256, 3)
    spec["conf0.weight"], spec["conf0.bias"] = ((out, 256, 1, 1), "yolo_head"), ((out,), "head_bias")
    return spec


def _cbl_run(ops: Ops, x, name, k, stride=1):
    return leaky(ops.bn(ops.conv(x, f"{name}.0", stride=stride, padding=k // 2), f"{name}.1"))


def _convset_run(ops, x, name):
    for i in range(5):
        x = _cbl_run(ops, x, f"{name}.ConvBNReLU_{i}", 3 if i % 2 else 1)
    return x


def forward(ops: Ops, x: torch.Tensor, cfg) -> List[torch.Tensor]:
    """NCHW float32 mean-subtracted images -> raw ``[B, H, W, 3, 5+C]`` a
    scale, stride 8 first."""
    taps = [int(t) for t in cfg["MODEL"]["FEATURE_LAYER"][0]]
    sources = []
    for i, kind, _ in _backbone():
        if kind == "res":
            y = _cbl_run(ops, x, f"base.{i}.ConvBNReLU_0", 1)
            x = x + _cbl_run(ops, y, f"base.{i}.ConvBNReLU_1", 3)
        else:
            x = _cbl_run(ops, x, f"base.{i}", 3, stride=1 if kind == "stem" else 2)
        if i in taps:
            sources.append(x)
    s8, s16, s32 = sources
    t32 = _convset_run(ops, s32, "extras_t32")
    o32 = ops.conv(_cbl_run(ops, t32, "extras_o32", 3), "conf2")
    r16 = upsample2(_cbl_run(ops, t32, "extras_r16", 1), s16.shape[2:])
    t16 = _convset_run(ops, torch.cat([r16, s16], 1), "extras_t16")
    o16 = ops.conv(_cbl_run(ops, t16, "extras_o16", 3), "conf1")
    r8 = upsample2(_cbl_run(ops, t16, "extras_r8", 1), s8.shape[2:])
    t8 = _convset_run(ops, torch.cat([r8, s8], 1), "extras_t8")
    o8 = ops.conv(_cbl_run(ops, t8, "extras_o8", 3), "conf0")
    c = num_classes(cfg)
    return [o.permute(0, 2, 3, 1).reshape(o.shape[0], o.shape[2], o.shape[3], 3, 5 + c)
            for o in (o8, o16, o32)]


def model_input(images_u8: torch.Tensor, cfg) -> torch.Tensor:
    means = torch.tensor(cfg["DATASET"]["PIXEL_MEANS"], dtype=torch.float32,
                         device=images_u8.device)
    return (images_u8.float() - means).permute(0, 3, 1, 2).contiguous()


def priors(cfg, device):
    return None  # YOLO decodes its own boxes


def train_loss(ops: Ops, batch: Dict[str, torch.Tensor], cfg, prior=None):
    images = batch["images"]
    raws = forward(ops, model_input(images, cfg), cfg)
    return yolo_loss(raws, anchors(cfg, images.device), batch["boxes"], batch["labels"],
                     batch["valid"], tuple(images.shape[1:3]))


def flops_per_image(cfg) -> int:
    meta = {k: torch.empty(shape, device="meta") for k, (shape, _) in param_spec(cfg).items()}
    ops = Ops(meta, count=True)
    h, w = cfg["MODEL"]["IMAGE_SIZE"]
    forward(ops, torch.empty((1, 3, int(h), int(w)), device="meta"), cfg)
    return int(ops.flops)
