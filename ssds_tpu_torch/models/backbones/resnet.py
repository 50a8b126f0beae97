"""ResNet backbones (18/34/50/101), truncated to feature extractors
(counterpart of :mod:`ssds_tpu.models.backbones.resnet`).

Reference ``lib/modeling/nets/resnet.py``: torchvision-style BasicBlock /
Bottleneck stages. Layer-index parity (the FEATURE_LAYER API): the list is
flat, entry 0 the stem (7x7 conv stride 2 + BN + ReLU, 3x3 max pool stride
2), then one entry a residual block, in stage order:

    resnet_18:  stem, 2+2+2+2 blocks  -> 9 entries,  stage ends at 2, 4, 6, 8
    resnet_34:  stem, 3+4+6+3 blocks  -> 17 entries, stage ends at 3, 7, 13, 16
    resnet_50:  stem, 3+4+6+3 blocks  -> 17 entries (Bottleneck, 4x channels)
    resnet_101: stem, 3+4+23+3 blocks -> 34 entries, stage ends at 3, 7, 30, 33

Strides: stem /4, stage 2 /8, stage 3 /16, stage 4 /32.

Every conv is a :class:`~ssds_tpu_torch.models.layers.ConvBNReLU` named as
flax names it, in call order: the stem's ``ConvBNReLU_0``; a block's
``ConvBNReLU_0`` / ``_1`` (Basic) or ``_0`` to ``_2`` (Bottleneck), and the
shortcut projection next (``_2`` / ``_3``), which exists exactly when the
stride is not 1 or the widths differ. So the state-dict keys are
``base.{i}.ConvBNReLU_{g}.{0,1}.*``, which the JAX package's ``torch_import``
places through its trailing-index rule, as DarkNet-53's residual blocks.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ssds_tpu_torch.models.layers import ConvBNReLU, LayerSpec, MaxPool


class BasicBlock(nn.Module):
    """Two 3x3 convs (the second without activation) plus the input or its
    1x1 projection, then ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_channels, features, 3, stride=stride, padding=1)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 3, padding=1, act="none")
        self.projects = stride != 1 or in_channels != features
        if self.projects:
            self.ConvBNReLU_2 = ConvBNReLU(in_channels, features, 1, stride=stride, padding=0,
                                           act="none")
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNReLU_1(self.ConvBNReLU_0(x))
        if self.projects:
            x = self.ConvBNReLU_2(x)
        return F.relu(y + x)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (the stride), 1x1 expand to ``4 * features`` without
    activation, plus the input or its 1x1 projection, then ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.ConvBNReLU_0 = ConvBNReLU(in_channels, features, 1, padding=0)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 3, stride=stride, padding=1)
        self.ConvBNReLU_2 = ConvBNReLU(features, out, 1, padding=0, act="none")
        self.projects = stride != 1 or in_channels != out
        if self.projects:
            self.ConvBNReLU_3 = ConvBNReLU(in_channels, out, 1, stride=stride, padding=0,
                                           act="none")
        self.out_channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBNReLU_2(self.ConvBNReLU_1(self.ConvBNReLU_0(x)))
        if self.projects:
            x = self.ConvBNReLU_3(x)
        return F.relu(y + x)


class Stem(nn.Module):
    """7x7 conv stride 2 padding 3 + BN + ReLU, then a 3x3 max pool stride 2 padding 1."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.ConvBNReLU_0 = ConvBNReLU(in_channels, 64, 7, stride=2, padding=3)
        self.MaxPool_0 = MaxPool(3, 2, padding=1)
        self.out_channels = 64

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MaxPool_0(self.ConvBNReLU_0(x))


def _resnet(block, stage_blocks) -> List[LayerSpec]:
    specs: List[LayerSpec] = [Stem]
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), stage_blocks)):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            specs.append(lambda cin, w=width, s=stride: block(cin, w, stride=s))
    return specs


def resnet_18() -> List[LayerSpec]:
    return _resnet(BasicBlock, (2, 2, 2, 2))


def resnet_34() -> List[LayerSpec]:
    return _resnet(BasicBlock, (3, 4, 6, 3))


def resnet_50() -> List[LayerSpec]:
    return _resnet(Bottleneck, (3, 4, 6, 3))


def resnet_101() -> List[LayerSpec]:
    return _resnet(Bottleneck, (3, 4, 23, 3))
