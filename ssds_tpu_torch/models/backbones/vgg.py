"""SSD-modified VGG16 backbone (counterpart of :mod:`ssds_tpu.models.backbones.vgg`).

Reference ``lib/modeling/nets/vgg.py``: the layer list from
``[64,64,'M',128,128,'M',256,256,256,'C',512,512,512,'M',512,512,512]``
(ceil-mode pool3 via 'C'), then pool5 3x3 stride 1 pad 1, dilated conv6
(k3, dilation 6, pad 6) and conv7 1x1, both 1024 channels. Every conv and
every ReLU is its own entry, so the 35 indices are the JAX package's and
the reference's; ``FEATURE_LAYER: [22, 34]`` taps conv4_3 and conv7 after
their ReLUs, and ``base.{i}.weight`` names the reference's parameters.

Only the plain stem (``s2d_block=0`` in the JAX package) is ported.
"""

from __future__ import annotations

from typing import List

from ssds_tpu_torch.models.layers import Conv, LayerSpec, MaxPool, ReLU

_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "C", 512, 512, 512, "M", 512, 512, 512]


def vgg16() -> List[LayerSpec]:
    """The SSD-VGG16 layer-spec list (35 entries)."""
    specs: List[LayerSpec] = []
    for v in _VGG16_CFG:
        if v == "M":
            specs.append(lambda cin: MaxPool(window=2, stride=2))
        elif v == "C":
            specs.append(lambda cin: MaxPool(window=2, stride=2, ceil_mode=True))
        else:
            specs.append(lambda cin, ch=int(v): Conv(cin, ch, kernel=3, padding=1))
            specs.append(lambda cin: ReLU())
    specs.append(lambda cin: MaxPool(window=3, stride=1, padding=1))
    specs.append(lambda cin: Conv(cin, 1024, kernel=3, padding=6, dilation=6))
    specs.append(lambda cin: ReLU())
    specs.append(lambda cin: Conv(cin, 1024, kernel=1, padding=0))
    specs.append(lambda cin: ReLU())
    return specs
