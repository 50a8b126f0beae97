"""Detector-head zoo.

Every builder has the wiring contract
``build_X(base, feature_layer, mbox, num_classes) -> nn.Module``, where
``base`` is a backbone layer-spec list, ``feature_layer`` is
``cfg.MODEL.FEATURE_LAYER`` and ``mbox`` the anchors per cell of each map;
the YOLO builders also take ``model_cfg`` (``cfg.MODEL``, for
``MODEL.ANCHORS``). Ported: ``ssd``, ``ssd_lite``, ``fssd``, ``fssd_lite``,
``rfb``, ``rfb_lite``, ``yolo_v2`` and ``yolo_v3``.
"""

from ssds_tpu_torch.models.heads.fssd import build_fssd
from ssds_tpu_torch.models.heads.fssd_lite import build_fssd_lite
from ssds_tpu_torch.models.heads.rfb import build_rfb
from ssds_tpu_torch.models.heads.rfb_lite import build_rfb_lite
from ssds_tpu_torch.models.heads.ssd import build_ssd
from ssds_tpu_torch.models.heads.ssd_lite import build_ssd_lite
from ssds_tpu_torch.models.heads.yolo import build_yolo_v2, build_yolo_v3

ssds_map = {
    "ssd": build_ssd,
    "ssd_lite": build_ssd_lite,
    "fssd": build_fssd,
    "fssd_lite": build_fssd_lite,
    "rfb": build_rfb,
    "rfb_lite": build_rfb_lite,
    "yolo_v2": build_yolo_v2,
    "yolo_v3": build_yolo_v3,
}
