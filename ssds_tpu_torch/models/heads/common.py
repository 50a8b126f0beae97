"""Shared head scaffolding (counterpart of :mod:`ssds_tpu.models.heads.common`).

The FEATURE_LAYER vocabulary shared by the heads:

- ``int`` — tap the output of that backbone layer index as a source;
- ``'S'`` — extra block: 1x1 conv (ch//2) then 3x3 stride-2 pad-1 conv (ch);
- ``''``  — extra block: 1x1 conv (ch//2) then 3x3 pad-0 conv (ch).

Phases (reference ``SSD.forward(x, phase)``): ``'feature'`` returns the
source maps; ``'train'`` raw ``(loc [B,K,4], conf [B,K,C])``; ``'eval'``
``(loc, softmax(conf))`` in float32.

Module names follow the reference torch layout (``extras.{k}``,
``loc.{k}``, ``conf.{k}``), which ``ssds_tpu/torch_import.py`` maps onto the
JAX tree. So extra blocks are flattened into one list of convs, and the
loc/conf predictors are two separate convs per source where the JAX package
runs one fused conv over their concatenated kernels (exact by linearity).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ssds_tpu_torch.models.layers import Conv, LayerSpec


def split_feature_layer(feature_layer) -> Tuple[List[int], List[Tuple[str, int]]]:
    """Split FEATURE_LAYER into backbone taps and extra-block specs."""
    taps: List[int] = []
    extras: List[Tuple[str, int]] = []
    for layer, ch in zip(feature_layer[0], feature_layer[1]):
        if isinstance(layer, int):
            taps.append(layer)
        else:
            extras.append((str(layer), int(ch)))
    return taps, extras


def conv_extra_spec(kind: str, ch: int) -> Tuple[LayerSpec, LayerSpec]:
    """Plain-conv extra block ('S' or ''), as its two conv specs."""
    if kind == "S":
        return (lambda cin: Conv(cin, ch // 2, kernel=1, padding=0, relu=True),
                lambda cin: Conv(cin, ch, kernel=3, stride=2, padding=1, relu=True))
    return (lambda cin: Conv(cin, ch // 2, kernel=1, padding=0, relu=True),
            lambda cin: Conv(cin, ch, kernel=3, padding=0, relu=True))


def multibox_layers(source_channels: Sequence[int], num_anchors: Sequence[int],
                    num_classes: int) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """Per-source 3x3 pad-1 loc and conf predictor convs (reference ``multibox``)."""
    loc = [Conv(c, a * 4, kernel=3, padding=1) for c, a in zip(source_channels, num_anchors)]
    conf = [Conv(c, a * num_classes, kernel=3, padding=1)
            for c, a in zip(source_channels, num_anchors)]
    return nn.ModuleList(loc), nn.ModuleList(conf)


def multibox(sources: Sequence[torch.Tensor], loc_layers: nn.ModuleList,
             conf_layers: nn.ModuleList, num_classes: int):
    """Run the predictors and flatten to ``(loc [B,K,4], conf [B,K,C])``.

    NCHW -> NHWC before the flatten, so priors come in (level, y, x, anchor)
    order, the JAX package's and the anchor generator's.
    """
    locs, confs = [], []
    for x, lc, cc in zip(sources, loc_layers, conf_layers):
        b = x.shape[0]
        locs.append(lc(x).permute(0, 2, 3, 1).reshape(b, -1, 4))
        confs.append(cc(x).permute(0, 2, 3, 1).reshape(b, -1, num_classes))
    return torch.cat(locs, dim=1), torch.cat(confs, dim=1)


def finalize(phase: str, loc: torch.Tensor, conf: torch.Tensor):
    """Phase-dependent outputs (train: raw; eval: float32 softmax)."""
    if phase == "eval":
        return loc.float(), torch.softmax(conf.float(), dim=-1)
    return loc, conf


def run_layers(layers: nn.ModuleList, taps: Sequence[int], x: torch.Tensor):
    """Run a backbone layer list, collecting tapped sources."""
    sources = []
    tapset = set(taps)
    for i, layer in enumerate(layers):
        x = layer(x)
        if i in tapset:
            sources.append(x)
    return sources, x
