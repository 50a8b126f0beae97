"""The classic SSD head (counterpart of :mod:`ssds_tpu.models.heads.ssd`).

Reference ``lib/modeling/ssds/ssd.py``: run the backbone collecting sources
at the FEATURE_LAYER indices (L2Norm, scale 20, on the first source), chain
the extra blocks off the backbone tail (each block's output is a source),
then per-source 3x3 loc/conf convs. Parameter names are the reference's:
``base.{i}``, ``norm``, ``extras.{k}``, ``loc.{k}``, ``conf.{k}``. ``lite``
gives the SSDLite predictors (:mod:`ssds_tpu_torch.models.heads.ssd_lite`);
L2Norm still scales the first source, as in the JAX package. The RFB heads
(:mod:`ssds_tpu_torch.models.heads.rfb`) are this wiring with another
``norm`` and other extra blocks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ssds_tpu_torch.models.heads.common import (
    build_extras, conv_extra_spec, finalize, multibox, multibox_layers, run_extras, run_layers,
    split_feature_layer)
from ssds_tpu_torch.models.layers import L2Norm, LayerSpec, build_layers


class SSD(nn.Module):
    """``norm`` makes the module applied to the first source from its width
    (L2Norm, or RFB's ``BasicRFB_a``); its ``out_channels``, where it has
    one, is that source's width from then on."""

    def __init__(self, base: Sequence[LayerSpec], extras: Sequence[Tuple[LayerSpec, ...]],
                 taps: Sequence[int], num_anchors: Sequence[int], num_classes: int,
                 in_channels: int = 3, lite: bool = False, norm: LayerSpec = L2Norm):
        super().__init__()
        self.taps = tuple(taps)
        self.num_classes = num_classes
        self.base, widths = build_layers(base, in_channels)
        source_channels = [widths[t] for t in self.taps]
        self.norm = norm(source_channels[0])
        source_channels[0] = getattr(self.norm, "out_channels", source_channels[0])
        self.extras, self.extra_blocks, extra_widths = build_extras(extras, widths[-1])
        source_channels += extra_widths
        self.loc, self.conf = multibox_layers(source_channels, num_anchors, num_classes, lite)

    def forward(self, x: torch.Tensor, phase: str = "train"):
        """``x``: ``[B, 3, H, W]`` mean-subtracted image (NCHW)."""
        sources, x = run_layers(self.base, self.taps, x)
        sources[0] = self.norm(sources[0])
        run_extras(self.extras, self.extra_blocks, x, sources)
        if phase == "feature":
            return sources
        loc, conf = multibox(sources, self.loc, self.conf, self.num_classes)
        return finalize(phase, loc, conf)


def build_ssd(base, feature_layer, mbox, num_classes) -> SSD:
    taps, extra_specs = split_feature_layer(feature_layer)
    extras = [conv_extra_spec(kind, ch) for kind, ch in extra_specs]
    return SSD(base=base, extras=extras, taps=taps, num_anchors=mbox,
               num_classes=num_classes)
