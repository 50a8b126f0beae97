"""Shared head scaffolding (counterpart of :mod:`ssds_tpu.models.heads.common`).

The FEATURE_LAYER vocabulary shared by the heads:

- ``int`` — tap the output of that backbone layer index as a source;
- ``'S'`` — extra block: 1x1 conv (ch//2) then 3x3 stride-2 pad-1 conv (ch);
- ``''``  — extra block: 1x1 conv (ch//2) then 3x3 pad-0 conv (ch).

The lite heads (``ssd_lite``) make each extra block a 1x1 conv (ch//2, ReLU)
then a :class:`~ssds_tpu_torch.models.layers.SepConvBNReLU` (ch, ReLU), and
each predictor a depthwise 3x3 then a pointwise 1x1 conv, both with bias.

Phases (reference ``SSD.forward(x, phase)``): ``'feature'`` returns the
source maps; ``'train'`` raw ``(loc [B,K,4], conf [B,K,C])``; ``'eval'``
``(loc, softmax(conf))`` in float32.

Module names follow the reference torch layout (``extras.{k}``,
``loc.{k}``, ``conf.{k}``), which ``ssds_tpu/torch_import.py`` maps onto the
JAX tree. So extra blocks are flattened into one list of convs, and the
loc/conf predictors are two separate convs per source where the JAX package
runs one fused conv over their concatenated kernels (exact by linearity).
A lite predictor is ``nn.Sequential(depthwise, nn.Identity(), pointwise)``:
index 1 holds the reference's ReLU6, which the JAX head does not apply
(``ssds_tpu/models/heads/common.py:117-124``), so the names are
``loc.{k}.0`` / ``loc.{k}.2`` and the computation is the JAX package's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ssds_tpu_torch.models.layers import Conv, LayerSpec, SepConvBNReLU, build_layers


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


def sep_extra_spec(kind: str, ch: int) -> Tuple[LayerSpec, LayerSpec]:
    """Depthwise-separable extra block of the lite heads ('S' halves the map,
    '' shrinks it by 2), as its two specs."""
    stride, padding = (2, 1) if kind == "S" else (1, 0)
    return (lambda cin: Conv(cin, ch // 2, kernel=1, padding=0, relu=True),
            lambda cin: SepConvBNReLU(cin, ch, stride=stride, padding=padding))


def _predictor(cin: int, cout: int, lite: bool) -> nn.Module:
    if not lite:
        return Conv(cin, cout, kernel=3, padding=1)
    return nn.Sequential(Conv(cin, cin, kernel=3, padding=1, groups=cin), nn.Identity(),
                         Conv(cin, cout, kernel=1, padding=0))


def multibox_layers(source_channels: Sequence[int], num_anchors: Sequence[int],
                    num_classes: int, lite: bool = False) -> Tuple[nn.ModuleList, nn.ModuleList]:
    """Per-source loc and conf predictors: 3x3 pad-1 convs (reference
    ``multibox``), or depthwise 3x3 + pointwise 1x1 when ``lite``."""
    loc = [_predictor(c, a * 4, lite) for c, a in zip(source_channels, num_anchors)]
    conf = [_predictor(c, a * num_classes, lite) for c, a in zip(source_channels, num_anchors)]
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


def build_extras(extras: Sequence[Tuple[LayerSpec, ...]],
                 in_channels: int) -> Tuple[nn.ModuleList, Tuple[int, ...], List[int]]:
    """Instantiate extra blocks as ONE flat list (the reference's ``extras``):
    the modules, each block's length, and each block's output width."""
    flat = [spec for block in extras for spec in block]
    layers, widths = build_layers(flat, in_channels)
    lengths = tuple(len(block) for block in extras)
    ends = [sum(lengths[:i + 1]) - 1 for i in range(len(lengths))]
    return layers, lengths, [widths[e] for e in ends]


def run_extras(layers: nn.ModuleList, lengths: Sequence[int], x: torch.Tensor,
               sources: List[torch.Tensor]) -> torch.Tensor:
    """Chain the extra blocks off ``x``, appending each block's output to ``sources``."""
    start = 0
    for n in lengths:
        for layer in layers[start:start + n]:
            x = layer(x)
        start += n
        sources.append(x)
    return x


def run_layers(layers: nn.ModuleList, taps: Sequence[int], x: torch.Tensor):
    """Run a backbone layer list, collecting tapped sources."""
    sources = []
    tapset = set(taps)
    for i, layer in enumerate(layers):
        x = layer(x)
        if i in tapset:
            sources.append(x)
    return sources, x
