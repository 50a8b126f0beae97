"""MobileNet V1 / V2 backbones with width multipliers (counterpart of
:mod:`ssds_tpu.models.backbones.mobilenet`).

Reference ``lib/modeling/nets/mobilenet.py``: ``conv_bn`` + ``conv_dw``
stacks (V1) and ``InvertedResidual`` stacks (V2), widths 1.0 / 0.75 / 0.5 /
0.25. Layer-index parity (the FEATURE_LAYER API):

    mobilenet_v1: idx 0 = conv_bn(32, s2); idx 1..13 = the 13 conv_dw blocks.
      SSDLite taps [11, 13] (512 ch at /16, 1024 ch at /32 at width 1.0).
    mobilenet_v2: idx 0 = conv_bn(32, s2, relu6); idx 1..17 = the 17
      InvertedResidual blocks; idx 18 = conv_bn(1280, 1x1, relu6).
      SSDLite taps [13, 18] (96 ch at /16, 1280 ch at /32 at width 1.0).

State-dict names: ``base.{i}.{j}`` in V1 (flat conv / BN / ReLU entries),
``base.{i}.conv.{j}`` in V2's blocks, ``base.{0,18}.{j}`` for V2's stem and
tail.
"""

from __future__ import annotations

from typing import List

from ssds_tpu_torch.models.layers import ConvBNReLU, InvertedResidual, LayerSpec, SepConvBNReLU


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding of the MobileNet family (nearest multiple of 8)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# (out_channels, stride) for the 13 conv_dw blocks of MobileNetV1.
_V1_CFG = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]

# (expand_ratio, out_channels, stride) for the 17 InvertedResidual blocks.
_V2_CFG = (
    [(1, 16, 1)]
    + [(6, 24, 2), (6, 24, 1)]
    + [(6, 32, 2), (6, 32, 1), (6, 32, 1)]
    + [(6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1)]
    + [(6, 96, 1), (6, 96, 1), (6, 96, 1)]
    + [(6, 160, 2), (6, 160, 1), (6, 160, 1)]
    + [(6, 320, 1)]
)


def _mobilenet_v1(width: float) -> List[LayerSpec]:
    stem = _make_divisible(32 * width)
    specs: List[LayerSpec] = [lambda cin: ConvBNReLU(cin, stem, 3, stride=2, padding=1)]
    for ch, stride in _V1_CFG:
        c = _make_divisible(ch * width)
        specs.append(lambda cin, c=c, s=stride: SepConvBNReLU(cin, c, stride=s))
    return specs


def _mobilenet_v2(width: float) -> List[LayerSpec]:
    stem = _make_divisible(32 * width)
    specs: List[LayerSpec] = [
        lambda cin: ConvBNReLU(cin, stem, 3, stride=2, padding=1, act="relu6")]
    for t, ch, stride in _V2_CFG:
        c = _make_divisible(ch * width)
        specs.append(lambda cin, c=c, s=stride, t=t: InvertedResidual(cin, c, stride=s,
                                                                      expand_ratio=t))
    last = _make_divisible(1280 * max(width, 1.0))
    specs.append(lambda cin: ConvBNReLU(cin, last, 1, padding=0, act="relu6"))
    return specs


def mobilenet_v1() -> List[LayerSpec]:
    return _mobilenet_v1(1.0)


def mobilenet_v1_075() -> List[LayerSpec]:
    return _mobilenet_v1(0.75)


def mobilenet_v1_050() -> List[LayerSpec]:
    return _mobilenet_v1(0.5)


def mobilenet_v1_025() -> List[LayerSpec]:
    return _mobilenet_v1(0.25)


def mobilenet_v2() -> List[LayerSpec]:
    return _mobilenet_v2(1.0)


def mobilenet_v2_075() -> List[LayerSpec]:
    return _mobilenet_v2(0.75)


def mobilenet_v2_050() -> List[LayerSpec]:
    return _mobilenet_v2(0.5)


def mobilenet_v2_025() -> List[LayerSpec]:
    return _mobilenet_v2(0.25)
