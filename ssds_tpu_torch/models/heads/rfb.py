"""The RFB head: Receptive Field Blocks (counterpart of
:mod:`ssds_tpu.models.heads.rfb`).

Reference ``lib/modeling/ssds/rfb.py`` / the RFBNet paper
(arXiv:1711.07767): multi-branch blocks of 1x1 and 3x3 convs with growing
dilation, joined by a 1x1 conv and added to a learned 1x1 shortcut.
``BasicRFB_a`` (factorised 1x3 / 3x1 branches, dilations 1/3/3/5, 512 wide
whatever its input) takes L2Norm's place on the first source; ``BasicRFB``
blocks replace the plain extras.

FEATURE_LAYER vocabulary:

- ``int`` — tap the backbone layer's output (the first passes ``BasicRFB_a``);
- ``'R'`` — a stride-1 ``BasicRFB`` (``visual`` 2) chained off the tail;
- ``'S'`` — a stride-2 ``BasicRFB`` (``visual`` 1);
- ``''``  — SSD's plain 1x1 + 3x3 pad-0 conv pair (the 3 -> 1 tail).

``lite`` (``rfb_lite``) makes each branch's 3x3 in ``BasicRFB`` a
depthwise-separable conv and the predictors SSDLite's; the ``''`` pairs and
``BasicRFB_a`` stay plain, as in the JAX package.

Names are the reference torch layout: each ``BasicRFB`` is one entry of
``extras`` (``branch{b}.{j}``, ``ConvLinear``, ``shortcut``, each a
``BasicConv`` with ``.conv`` / ``.bn``; a lite branch's separable conv is a
flat ``SepConvBNReLU`` stack), each ``''`` pair two entries after them, and
``norm`` is the ``BasicRFB_a``. The wiring is SSD's
(:class:`ssds_tpu_torch.models.heads.ssd.SSD`) with that ``norm``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssds_tpu_torch.models.heads.common import conv_extra_spec
from ssds_tpu_torch.models.heads.ssd import SSD
from ssds_tpu_torch.models.layers import BasicConv, SepConvBNReLU

NORM_CHANNELS = 512  # BasicRFB_a's width, whatever the first source's


def _join(block: nn.Module, branches, x: torch.Tensor) -> torch.Tensor:
    out = block.ConvLinear(torch.cat([b(x) for b in branches], dim=1))
    return F.relu(out * block.scale + block.shortcut(x))


class BasicRFB(nn.Module):
    """Three dilated branches, ``ConvLinear`` and a learned shortcut (the
    paper's Fig. 4 left); ``ssds_tpu/models/heads/rfb.py:155-194``."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, scale: float = 1.0,
                 visual: int = 1, lite: bool = False):
        super().__init__()
        inter = max(features // 8, 8)
        v = visual

        def c(cin, ch, k=3, s=1, p=1, d=1, relu=True):
            return BasicConv(cin, ch, k, stride=s, padding=p, dilation=d, relu=relu)

        def conv3(cin, ch, s=1):
            return SepConvBNReLU(cin, ch, stride=s, padding=1) if lite else c(cin, ch, 3, s, 1)

        self.branch0 = nn.Sequential(c(in_channels, 2 * inter, 1, 1, 0),
                                     c(2 * inter, 2 * inter, 3, stride, v, v, relu=False))
        self.branch1 = nn.Sequential(c(in_channels, inter, 1, 1, 0),
                                     conv3(inter, 2 * inter, stride),
                                     c(2 * inter, 2 * inter, 3, 1, v + 1, v + 1, relu=False))
        self.branch2 = nn.Sequential(c(in_channels, inter, 1, 1, 0),
                                     conv3(inter, inter * 3 // 2),
                                     conv3(inter * 3 // 2, 2 * inter, stride),
                                     c(2 * inter, 2 * inter, 3, 1, 2 * v + 1, 2 * v + 1,
                                       relu=False))
        self.ConvLinear = c(6 * inter, features, 1, 1, 0, relu=False)
        self.shortcut = c(in_channels, features, 1, stride, 0, relu=False)
        self.scale = scale
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _join(self, (self.branch0, self.branch1, self.branch2), x)


class BasicRFB_a(nn.Module):
    """Four branches with factorised 1x3 / 3x1 convs and dilations 1/3/3/5
    for the stride-8 source (the paper's Fig. 4 right);
    ``ssds_tpu/models/heads/rfb.py:197-240``. Padding is ``d * (k - 1) // 2``
    on each axis. Its convs stay float under int8 quantisation
    (``QUANT_FLOAT``): JAX builds them with a bare ``nn.Conv``, which it
    does not quantise."""

    QUANT_FLOAT = True

    def __init__(self, in_channels: int, features: int = NORM_CHANNELS, scale: float = 1.0):
        super().__init__()
        inter = features // 4

        def c(cin, ch, kh, kw, d=1, relu=True):
            return BasicConv(cin, ch, (kh, kw), padding=(d * (kh - 1) // 2, d * (kw - 1) // 2),
                             dilation=d, relu=relu)

        self.branch0 = nn.Sequential(c(in_channels, inter, 1, 1),
                                     c(inter, inter, 3, 3, relu=False))
        self.branch1 = nn.Sequential(c(in_channels, inter, 1, 1), c(inter, inter, 3, 1),
                                     c(inter, inter, 3, 3, d=3, relu=False))
        self.branch2 = nn.Sequential(c(in_channels, inter, 1, 1), c(inter, inter, 1, 3),
                                     c(inter, inter, 3, 3, d=3, relu=False))
        self.branch3 = nn.Sequential(c(in_channels, inter // 2, 1, 1),
                                     c(inter // 2, (inter // 4) * 3, 1, 3),
                                     c((inter // 4) * 3, inter, 3, 1),
                                     c(inter, inter, 3, 3, d=5, relu=False))
        self.ConvLinear = c(4 * inter, features, 1, 1, relu=False)
        self.shortcut = c(in_channels, features, 1, 1, relu=False)
        self.scale = scale
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _join(self, (self.branch0, self.branch1, self.branch2, self.branch3), x)


def rfb_extra_spec(kind: str, ch: int, lite: bool):
    """One extra block of the vocabulary above, as its specs: a 1-tuple for
    a ``BasicRFB``, SSD's conv pair for ``''``."""
    if kind == "R":
        return (lambda cin: BasicRFB(cin, ch, stride=1, visual=2, lite=lite),)
    if kind == "S":
        return (lambda cin: BasicRFB(cin, ch, stride=2, visual=1, lite=lite),)
    return conv_extra_spec(kind, ch)


def build(base, feature_layer, mbox, num_classes, lite: bool) -> SSD:
    """The RFB (``lite`` False) or RFBLite head over ``base``."""
    taps, extras = [], []
    for layer, ch in zip(feature_layer[0], feature_layer[1]):
        if isinstance(layer, int):
            taps.append(layer)
        else:
            extras.append(rfb_extra_spec(str(layer), int(ch), lite))
    return SSD(base=base, extras=extras, taps=taps, num_anchors=mbox, num_classes=num_classes,
               lite=lite, norm=BasicRFB_a)


def build_rfb(base, feature_layer, mbox, num_classes) -> SSD:
    return build(base, feature_layer, mbox, num_classes, lite=False)
