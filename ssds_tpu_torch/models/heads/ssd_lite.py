"""SSDLite: SSD wiring with depthwise-separable extras and predictors
(counterpart of :mod:`ssds_tpu.models.heads.ssd_lite`).

Reference ``lib/modeling/ssds/ssd_lite.py``, the MobileNet-SSDLite recipe:
the sources of SSD, every extra block a 1x1 conv then a depthwise-separable
conv with BatchNorm, every loc/conf predictor a depthwise 3x3 then a
pointwise 1x1 conv.
"""

from __future__ import annotations

from ssds_tpu_torch.models.heads.common import sep_extra_spec, split_feature_layer
from ssds_tpu_torch.models.heads.ssd import SSD


def build_ssd_lite(base, feature_layer, mbox, num_classes) -> SSD:
    taps, extra_specs = split_feature_layer(feature_layer)
    extras = [sep_extra_spec(kind, ch) for kind, ch in extra_specs]
    return SSD(base=base, extras=extras, taps=taps, num_anchors=mbox, num_classes=num_classes,
               lite=True)
