"""SSD with the VGG16 backbone, in plain PyTorch (Liu et al., arXiv:1512.02325).

ssds.pytorch's ``ssd_vgg16`` at the configuration's sizes: VGG16's convs
(3x3, pad 1, ReLU; 2x2 pools, the third in ceil mode), pool5 3x3 stride 1,
conv6 3x3 dilation 6 and conv7 1x1 (1024 channels); the sources are
conv4_3 (L2-normalised, a learned scale a channel) and conv7; each extra
block of ``FEATURE_LAYER`` is a 1x1 conv to half the width and a 3x3 conv
(stride 2, pad 1 for ``'S'``; pad 0 for ``''``), both with ReLU; a 3x3 loc
and a 3x3 conf conv a source. Parameter names are ssds.pytorch's
(``base.{i}``, ``norm``, ``extras.{k}``, ``loc.{k}``, ``conf.{k}``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Tuple

import torch

from benchmark.reference.boxes import prior_boxes
from benchmark.reference.layers import Ops, max_pool, relu
from benchmark.reference.losses import multibox_loss

VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512, "M", 512, 512, 512]


def _base_layers():
    """VGG16's entries: ``("conv", cout, kernel, padding, dilation)``,
    ``("relu",)`` or ``("pool", window, stride, padding, ceil)``, indexed as
    ssds.pytorch indexes them."""
    layers = []
    for v in VGG16:
        if v == "M":
            layers.append(("pool", 2, 2, 0, False))
        elif v == "C":
            layers.append(("pool", 2, 2, 0, True))
        else:
            layers += [("conv", v, 3, 1, 1), ("relu",)]
    layers += [("pool", 3, 1, 1, False), ("conv", 1024, 3, 6, 6), ("relu",),
               ("conv", 1024, 1, 0, 1), ("relu",)]
    return layers


def _split(feature_layer):
    taps = [int(t) for t in feature_layer[0] if isinstance(t, int)]
    extras = [(str(t), int(c)) for t, c in zip(feature_layer[0], feature_layer[1])
              if not isinstance(t, int)]
    return taps, extras


def anchors_per_cell(cfg) -> list:
    return [2 + 2 * len(ar) for ar in cfg["MODEL"]["ASPECT_RATIOS"]]


def param_spec(cfg) -> "OrderedDict[str, Tuple[tuple, str]]":
    """name -> (shape, role), in the state dict's order. Roles: ``conv_in``
    (the conv on the image), ``conv``, ``bias``, ``l2norm``, ``head``,
    ``head_bias``."""
    m = cfg["MODEL"]
    spec: "OrderedDict[str, Tuple[tuple, str]]" = OrderedDict()
    cin, widths = 3, []
    for i, layer in enumerate(_base_layers()):
        if layer[0] == "conv":
            cout, k = layer[1], layer[2]
            spec[f"base.{i}.weight"] = ((cout, cin, k, k), "conv_in" if i == 0 else "conv")
            spec[f"base.{i}.bias"] = ((cout,), "bias")
            cin = cout
        widths.append(cin)
    taps, extras = _split(m["FEATURE_LAYER"])
    sources = [widths[t] for t in taps]
    spec["norm.weight"] = ((sources[0],), "l2norm")
    for j, (kind, ch) in enumerate(extras):
        spec[f"extras.{2 * j}.weight"] = ((ch // 2, cin, 1, 1), "conv")
        spec[f"extras.{2 * j}.bias"] = ((ch // 2,), "bias")
        spec[f"extras.{2 * j + 1}.weight"] = ((ch, ch // 2, 3, 3), "conv")
        spec[f"extras.{2 * j + 1}.bias"] = ((ch,), "bias")
        cin = ch
        sources.append(ch)
    c = int(m["NUM_CLASSES"])
    for head, per in (("loc", 4), ("conf", c)):
        for k, (src, a) in enumerate(zip(sources, anchors_per_cell(cfg))):
            spec[f"{head}.{k}.weight"] = ((a * per, src, 3, 3), "head")
            spec[f"{head}.{k}.bias"] = ((a * per,), "head_bias")
    return spec


def features(ops: Ops, x: torch.Tensor, cfg):
    """The sources: NCHW float32 mean-subtracted images -> the maps the
    predictors read."""
    taps, extras = _split(cfg["MODEL"]["FEATURE_LAYER"])
    sources = []
    for i, layer in enumerate(_base_layers()):
        if layer[0] == "conv":
            x = ops.conv(x, f"base.{i}", padding=layer[3], dilation=layer[4])
        elif layer[0] == "relu":
            x = relu(x)
        else:
            x = max_pool(x, layer[1], layer[2], layer[3], layer[4])
        if i in taps:
            sources.append(x)
    s0 = sources[0]
    norm = torch.sqrt(torch.sum(s0 * s0, dim=1, keepdim=True)) + 1e-10
    sources[0] = s0 / norm * ops.p["norm.weight"][None, :, None, None]
    for j, (kind, _) in enumerate(extras):
        x = relu(ops.conv(x, f"extras.{2 * j}"))
        x = relu(ops.conv(x, f"extras.{2 * j + 1}", stride=2 if kind == "S" else 1,
                          padding=1 if kind == "S" else 0))
        sources.append(x)
    return sources


def forward(ops: Ops, x: torch.Tensor, cfg):
    """Raw ``(loc [B, K, 4], conf [B, K, C])``, priors in (map, row,
    column, anchor) order."""
    c = int(cfg["MODEL"]["NUM_CLASSES"])
    locs, confs = [], []
    for k, s in enumerate(features(ops, x, cfg)):
        b = s.shape[0]
        locs.append(ops.conv(s, f"loc.{k}", padding=1).permute(0, 2, 3, 1).reshape(b, -1, 4))
        confs.append(ops.conv(s, f"conf.{k}", padding=1).permute(0, 2, 3, 1).reshape(b, -1, c))
    return torch.cat(locs, 1), torch.cat(confs, 1)


def feature_maps(cfg, params_meta: Dict[str, torch.Tensor]):
    h, w = cfg["MODEL"]["IMAGE_SIZE"]
    x = torch.empty((1, 3, int(h), int(w)), device="meta")
    return [tuple(s.shape[2:]) for s in features(Ops(params_meta), x, cfg)]


def priors(cfg, device) -> torch.Tensor:
    m = cfg["MODEL"]
    meta = {k: torch.empty(shape, device="meta") for k, (shape, _) in param_spec(cfg).items()}
    p = prior_boxes(m["IMAGE_SIZE"], feature_maps(cfg, meta), m["ASPECT_RATIOS"], m["SIZES"],
                    bool(m["CLIP"]))
    return torch.from_numpy(p).to(device)


def model_input(images_u8: torch.Tensor, cfg) -> torch.Tensor:
    means = torch.tensor(cfg["DATASET"]["PIXEL_MEANS"], dtype=torch.float32,
                         device=images_u8.device)
    return (images_u8.float() - means).permute(0, 3, 1, 2).contiguous()


def train_loss(ops: Ops, batch: Dict[str, torch.Tensor], cfg, prior: torch.Tensor):
    loc, conf = forward(ops, model_input(batch["images"], cfg), cfg)
    return multibox_loss(loc, conf, batch["boxes"], batch["labels"], batch["valid"], prior)


def flops_per_image(cfg) -> int:
    """Operations of one image's forward (two a multiply-add), counted on ``meta``."""
    meta = {k: torch.empty(shape, device="meta") for k, (shape, _) in param_spec(cfg).items()}
    ops = Ops(meta, count=True)
    h, w = cfg["MODEL"]["IMAGE_SIZE"]
    forward(ops, torch.empty((1, 3, int(h), int(w)), device="meta"), cfg)
    return int(ops.flops)

