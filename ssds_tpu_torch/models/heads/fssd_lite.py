"""FSSDLite: FSSD with depthwise-separable fusion extras, pyramid blocks and
predictors (counterpart of :mod:`ssds_tpu.models.heads.fssd_lite`;
reference ``lib/modeling/ssds/fssd_lite.py``)."""

from __future__ import annotations

from ssds_tpu_torch.models.heads.fssd import FSSD, build


def build_fssd_lite(base, feature_layer, mbox, num_classes) -> FSSD:
    return build(base, feature_layer, mbox, num_classes, lite=True)
