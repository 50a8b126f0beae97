"""The FSSD head: feature fusion and a regenerated pyramid (counterpart of
:mod:`ssds_tpu.models.heads.fssd`).

Reference ``lib/modeling/ssds/fssd.py`` / the FSSD paper (arXiv:1712.00960):
a 1x1 transform conv (256, ReLU) on each fusion source, a bilinear resize
of each to the first source's grid, a channel concat, a BatchNorm, then a
small conv pyramid whose every block's output is a detection source, and
the loc/conf predictors.

FEATURE_LAYER has two groups (fusion sources; pyramid)::

    [[[22, 34, 'S'], [512, 1024, 256]],
     [['', 'S', 'S', 'S', '0', '0'], [256, 512, 512, 256, 256, 256]]]

Group 1: ints tap backbone layers; 'S' / '' chain extra conv blocks off
the backbone tail (SSD's vocabulary), each a fusion source. Group 2: ``''``
is a 3x3 stride-1 pad-1 ConvBNReLU, ``'S'`` stride 2 (halve), ``'0'`` pad 0
(shrink by 2, the 3 -> 1 tail). ``lite`` (``fssd_lite``) makes the fusion
extras and every pyramid block but ``'0'`` depthwise-separable, and the
predictors SSDLite's.

Names are the reference torch layout: ``base.{i}``, ``extras.{k}`` (the
fusion extras, flat), ``transforms.{k}``, ``norm`` (the fusion BN),
``pyramids.{k}``, ``loc.{k}``, ``conf.{k}``; ``resizes.{k}``, a fusion
source's resize, has no parameters.

Precision: the JAX package's fusion BN has no ``dtype``, so under bf16 its
float32 scale promotes the output to float32, and every layer after it (the
pyramid and the predictors, whose flax convs compute in their input's
dtype) runs in float32, in serving and in training. Here the fusion BN is a
:class:`~ssds_tpu_torch.models.layers.Float32BatchNorm`, the layers after it
run with autocast off, and :attr:`FSSD.FLOAT32_MODULES` names the modules
that bf16 serving leaves in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ssds_tpu_torch.models.heads.common import (
    build_extras, conv_extra_spec, finalize, multibox, multibox_layers, run_extras, run_layers,
    sep_extra_spec, split_feature_layer)
from ssds_tpu_torch.models.layers import (
    Conv, ConvBNReLU, Float32BatchNorm, LayerSpec, Resize, SepConvBNReLU, build_layers,
    no_autocast)

FUSION_CHANNELS = 256  # the reference's transform width


def pyramid_spec(kind: str, ch: int, lite: bool) -> LayerSpec:
    """One pyramid block of group 2's vocabulary (see the module docstring)."""
    if lite and kind != "0":
        stride = 2 if kind == "S" else 1
        return lambda cin: SepConvBNReLU(cin, ch, stride=stride, padding=1)
    stride, padding = {"S": (2, 1), "0": (1, 0)}.get(kind, (1, 1))
    return lambda cin: ConvBNReLU(cin, ch, 3, stride=stride, padding=padding)


class FSSD(nn.Module):
    # modules that compute in float32 whatever the compute dtype (bf16 serving
    # keeps their weights in float32)
    FLOAT32_MODULES = ("pyramids", "loc", "conf")
    # TRAINABLE_SCOPE / RESUME_SCOPE words beyond the module names: the JAX
    # package's 'fusion' selects the fusion BN, which is 'norm' here
    SCOPE_ALIASES = {"fusion": ("norm",)}

    def __init__(self, base: Sequence[LayerSpec], fusion_extras: Sequence[Tuple[LayerSpec, ...]],
                 pyramid: Sequence[LayerSpec], taps: Sequence[int], num_anchors: Sequence[int],
                 num_classes: int, in_channels: int = 3, lite: bool = False):
        super().__init__()
        self.taps = tuple(taps)
        self.num_classes = num_classes
        self.base, widths = build_layers(base, in_channels)
        self.extras, self.extra_blocks, extra_widths = build_extras(fusion_extras, widths[-1])
        fusion_sources = [widths[t] for t in self.taps] + extra_widths
        self.transforms = nn.ModuleList(
            Conv(c, FUSION_CHANNELS, kernel=1, padding=0, relu=True) for c in fusion_sources)
        self.resizes = nn.ModuleList(Resize() for _ in fusion_sources)  # no parameters
        fused = FUSION_CHANNELS * len(fusion_sources)
        self.norm = Float32BatchNorm(fused)
        self.pyramids, source_channels = build_layers(pyramid, fused)
        self.loc, self.conf = multibox_layers(source_channels, num_anchors, num_classes, lite)

    def forward(self, x: torch.Tensor, phase: str = "train"):
        """``x``: ``[B, 3, H, W]`` mean-subtracted image (NCHW)."""
        fusion_sources, x = run_layers(self.base, self.taps, x)
        run_extras(self.extras, self.extra_blocks, x, fusion_sources)
        fused = self.fuse(fusion_sources)
        with no_autocast(fused):
            sources = self.run_pyramid(self.norm(fused))
            if phase == "feature":
                return sources
            loc, conf = multibox(sources, self.loc, self.conf, self.num_classes)
        return finalize(phase, loc, conf)

    def fuse(self, fusion_sources):
        """Each source through its transform, resized to the first source's
        grid (the first, already on it, passes unchanged, as JAX skips it),
        concatenated: the fusion BN's input, in the compute dtype."""
        target = tuple(fusion_sources[0].shape[2:])
        return torch.cat([r(t(s), target) for t, r, s in
                          zip(self.transforms, self.resizes, fusion_sources)], dim=1)

    def run_pyramid(self, y: torch.Tensor):
        """The pyramid blocks chained off the fusion BN's output; each
        block's output is a detection source."""
        sources = []
        for layer in self.pyramids:
            y = layer(y)
            sources.append(y)
        return sources


def build(base, feature_layer, mbox, num_classes, lite: bool) -> FSSD:
    """The FSSD (``lite`` False) or FSSDLite head over ``base``."""
    fusion_group, pyramid_group = feature_layer[0], feature_layer[1]
    taps, extra_specs = split_feature_layer(fusion_group)
    make_extra = sep_extra_spec if lite else conv_extra_spec
    pyramid = [pyramid_spec(str(kind), int(ch), lite)
               for kind, ch in zip(pyramid_group[0], pyramid_group[1])]
    return FSSD(base=base, fusion_extras=[make_extra(kind, ch) for kind, ch in extra_specs],
                pyramid=pyramid, taps=taps, num_anchors=mbox, num_classes=num_classes, lite=lite)


def build_fssd(base, feature_layer, mbox, num_classes) -> FSSD:
    return build(base, feature_layer, mbox, num_classes, lite=False)
