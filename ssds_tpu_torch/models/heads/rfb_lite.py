"""RFBLite: RFB with depthwise-separable branch convs and SSDLite predictors
(counterpart of :mod:`ssds_tpu.models.heads.rfb_lite`; reference
``lib/modeling/ssds/rfb_lite.py``)."""

from __future__ import annotations

from ssds_tpu_torch.models.heads.rfb import build
from ssds_tpu_torch.models.heads.ssd import SSD


def build_rfb_lite(base, feature_layer, mbox, num_classes) -> SSD:
    return build(base, feature_layer, mbox, num_classes, lite=True)
