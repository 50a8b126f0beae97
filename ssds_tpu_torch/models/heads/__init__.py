"""Detector-head zoo.

Every builder has the wiring contract
``build_X(base, feature_layer, mbox, num_classes) -> nn.Module``, where
``base`` is a backbone layer-spec list, ``feature_layer`` is
``cfg.MODEL.FEATURE_LAYER`` and ``mbox`` the anchors per cell of each map.
Ported: ``ssd`` and ``ssd_lite``.
"""

from ssds_tpu_torch.models.heads.ssd import build_ssd
from ssds_tpu_torch.models.heads.ssd_lite import build_ssd_lite

ssds_map = {
    "ssd": build_ssd,
    "ssd_lite": build_ssd_lite,
}
