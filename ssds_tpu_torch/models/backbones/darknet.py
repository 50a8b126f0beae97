"""DarkNet-19 and DarkNet-53 backbones for the YOLO heads (counterpart of
:mod:`ssds_tpu.models.backbones.darknet`).

Reference ``lib/modeling/nets/darknet.py``: conv-BN-leaky stacks with max
pools (19) and a conv-BN-leaky stem with residual stages (53). Layer-index
parity (the FEATURE_LAYER API):

    darknet_19: idx 0 conv32 | 1 pool | 2 conv64 | 3 pool | 4..6 conv128 stack
      | 7 pool | 8..10 conv256 stack | 11 pool | 12..16 conv512 stack (/16)
      | 17 pool | 18..22 conv1024 stack (/32). YOLOv2 taps [16, 22].
    darknet_53: idx 0 stem conv32; then for each stage one stride-2 conv and
      one entry a residual block: 1 down64 | 2 res | 3 down128 | 4,5 res
      | 6 down256 | 7..14 res(8) | 15 down512 | 16..23 res(8) | 24 down1024
      | 25..28 res(4). YOLOv3 taps [14, 23, 28] (strides 8, 16, 32).

Every conv is a :class:`~ssds_tpu_torch.models.layers.ConvBNReLU` with
``act="leaky"`` (``base.{i}.{0,1}``). A :class:`DarkResidual` names its two
convs ``ConvBNReLU_0`` / ``ConvBNReLU_1``, the flax names, so its state-dict
keys are ``base.{i}.ConvBNReLU_{g}.{0,1}.*``, which the JAX package's
``torch_import`` places through its trailing-index rule.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ssds_tpu_torch.models.layers import ConvBNReLU, LayerSpec, MaxPool


def _conv(cin: int, ch: int, kernel: int, stride: int = 1) -> ConvBNReLU:
    return ConvBNReLU(cin, ch, kernel, stride=stride, padding=kernel // 2, act="leaky")


class DarkResidual(nn.Module):
    """darknet_53's residual block: 1x1 to half the channels, 3x3 back to
    ``features``, plus the input."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.ConvBNReLU_0 = _conv(in_channels, features // 2, 1)
        self.ConvBNReLU_1 = _conv(features // 2, features, 3)
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBNReLU_1(self.ConvBNReLU_0(x))


def darknet_19() -> List[LayerSpec]:
    def conv(ch, k):
        return lambda cin: _conv(cin, ch, k)

    def pool(cin):
        return MaxPool(2, 2)

    specs: List[LayerSpec] = [conv(32, 3), pool, conv(64, 3), pool]
    specs += [conv(128, 3), conv(64, 1), conv(128, 3), pool]
    specs += [conv(256, 3), conv(128, 1), conv(256, 3), pool]
    specs += [conv(512, 3), conv(256, 1), conv(512, 3), conv(256, 1), conv(512, 3), pool]
    specs += [conv(1024, 3), conv(512, 1), conv(1024, 3), conv(512, 1), conv(1024, 3)]
    return specs


def darknet_53() -> List[LayerSpec]:
    specs: List[LayerSpec] = [lambda cin: _conv(cin, 32, 3)]
    for ch, n_blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        specs.append(lambda cin, ch=ch: _conv(cin, ch, 3, stride=2))
        specs += [lambda cin, ch=ch: DarkResidual(cin, ch)] * n_blocks
    return specs
