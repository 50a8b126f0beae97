"""Experiment configuration: the reference's YAML schema, key for key.

Counterpart of :mod:`ssds_tpu.config`. The default tree is the same, so
every ``experiments/cfgs/*.yml`` merges into it unchanged; keys only the
JAX package reads (``MODEL.S2D_STEM`` / ``S2D_STAGES``) and ``TPU.DONATE``,
which neither Solver reads, are kept so that a config file is valid for both
packages; the port's Solver reads the rest of ``TPU`` (``MESH``,
``COMPUTE_DTYPE``, ``DEBUG_NANS``, ``REMAT``).
``yaml`` is imported inside :func:`cfg_from_file` / :func:`cfg_from_list`
only: a machine without PyYAML can still build the default config, serve,
and read a config written as JSON.
"""

from __future__ import annotations

import copy
import json
from typing import Any


class AttrDict(dict):
    """dict with attribute access (the reference's EasyDict role)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _ad(**kwargs) -> AttrDict:
    return AttrDict(kwargs)


def default_config() -> AttrDict:
    """The full default tree — equal to ``ssds_tpu.config.default_config()``."""
    return _ad(
        MODEL=_ad(
            SSDS="ssd",
            NETS="vgg16",
            IMAGE_SIZE=[300, 300],
            NUM_CLASSES=21,
            FEATURE_LAYER=[[22, 34, "S", "S", "", ""], [512, 1024, 512, 256, 256, 256]],
            STEPS=[],
            S2D_STEM=-1,  # JAX-only: the port has no space-to-depth stem
            S2D_STAGES=-1,  # JAX-only
            SIZES=[0.2, 0.95],
            ASPECT_RATIOS=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
            CLIP=True,
            HALF_PRECISION=True,  # bf16 forward; softmax/decode/detect in f32
            QUANT="",  # "int8": ObjectDetector quantises at construction (quant.py)
            ANCHORS=[],
        ),
        TRAIN=_ad(
            MAX_EPOCHS=300,
            CHECKPOINTS_EPOCHS=5,
            BATCH_SIZE=32,
            TRAINABLE_SCOPE="base,norm,extras,transforms,pyramids,loc,conf",
            RESUME_SCOPE="",
            OPTIMIZER=_ad(
                OPTIMIZER="sgd",
                LEARNING_RATE=0.001,
                DIFFERENTIAL_LEARNING_RATE=[],
                MOMENTUM=0.9,
                WEIGHT_DECAY=0.0005,
                EPS=1e-8,
                CLIP_GRADIENT=0.0,
            ),
            LR_SCHEDULER=_ad(
                SCHEDULER="step",
                STEPS=[1],
                GAMMA=0.98,
                LR_MIN=0.0,
                WARM_UP_EPOCHS=0,
            ),
        ),
        TEST=_ad(
            BATCH_SIZE=64,
            TEST_SCOPE=[0, 300],
        ),
        POST_PROCESS=_ad(
            NUM_CLASSES=21,
            BACKGROUND_LABEL=0,
            SCORE_THRESHOLD=0.01,
            IOU_THRESHOLD=0.6,
            MAX_DETECTIONS=100,
            TOP_K=200,
            VARIANCE=[0.1, 0.2],
            # class-agnostic pre-NMS prune at batch >= 4 (0 = off); see
            # ops/postprocess.PostProcessConfig.pre_nms_top_n
            PRE_NMS_TOP_N=1024,
        ),
        DATASET=_ad(
            DATASET="voc",
            DATASET_DIR="data/VOCdevkit",
            TRAIN_SETS=[["2007", "trainval"], ["2012", "trainval"]],
            TEST_SETS=[["2007", "test"]],
            PROB=0.6,
            PIXEL_MEANS=(104, 117, 123),  # BGR order, as the reference
            NUM_WORKERS=8,
            DEVICE_ID=[0],
            MAX_GT=64,
            DEVICE_AUG=False,
        ),
        TPU=_ad(  # the port's Solver reads all but DONATE, which neither Solver reads
            # DATA: the data width (-1: the ranks over SPATIAL); SPATIAL > 1
            # splits the image rows over that many ranks (parallel/spatial.py)
            MESH=_ad(DATA=-1, SPATIAL=1),
            COMPUTE_DTYPE="bfloat16",
            DONATE=True,
            DEBUG_NANS=False,
            REMAT=False,
        ),
        EXP_DIR="./experiments/models/ssd_vgg16_voc",
        LOG_DIR="./experiments/models/ssd_vgg16_voc/logs",
        RESUME_CHECKPOINT="",
        CHECKPOINTS_PREFIX="ssd_vgg16_voc",
        PHASE=["train"],
    )


def ssd_lite_mobilenetv2_config() -> AttrDict:
    """``experiments/cfgs/ssd_lite_mobilenetv2_train_voc.yml`` (SSDLite-MobileNetV2-300
    on VOC07+12) over the defaults, written out for machines without PyYAML.
    ``tests/test_torch_port_lite_solver.py`` holds it equal to the file."""
    cfg = default_config()
    cfg.MODEL.update(SSDS="ssd_lite", NETS="mobilenet_v2",
                     FEATURE_LAYER=[[13, 18, "S", "S", "S", "S"], [96, 1280, 512, 256, 256, 128]],
                     ASPECT_RATIOS=[[2, 3]] * 6)
    cfg.TRAIN.update(BATCH_SIZE=64, TRAINABLE_SCOPE="base,norm,extras,loc,conf",
                     RESUME_SCOPE="base")
    cfg.TRAIN.OPTIMIZER.update(LEARNING_RATE=0.01, WEIGHT_DECAY=4e-5)
    cfg.TRAIN.LR_SCHEDULER.update(SCHEDULER="sgdr", WARM_UP_EPOCHS=5)
    cfg.TEST.TEST_SCOPE = [290, 300]
    cfg.DATASET.DATASET_DIR = "./data/VOCdevkit"
    cfg.EXP_DIR = "./experiments/models/ssd_lite_mobilenetv2_voc"
    cfg.LOG_DIR = "./experiments/models/ssd_lite_mobilenetv2_voc/logs"
    cfg.CHECKPOINTS_PREFIX = "ssd_lite_mobilenetv2_voc"
    return cfg


def ssd_lite_mobilenetv2_coco_config() -> AttrDict:
    """``experiments/cfgs/ssd_lite_mobilenetv2_train_coco.yml`` (SSDLite-MobileNetV2-300
    on COCO 2017, 81 classes) over the defaults, written out for machines
    without PyYAML. ``tests/test_torch_port_coco.py`` holds it equal to the file."""
    cfg = ssd_lite_mobilenetv2_config()
    cfg.MODEL.NUM_CLASSES = cfg.POST_PROCESS.NUM_CLASSES = 81
    cfg.TRAIN.MAX_EPOCHS = 250
    cfg.TEST.TEST_SCOPE = [240, 250]
    cfg.DATASET.update(DATASET="coco", DATASET_DIR="./data/coco",
                       TRAIN_SETS=[["2017", "train"]], TEST_SETS=[["2017", "val"]], MAX_GT=128)
    cfg.EXP_DIR = "./experiments/models/ssd_lite_mbv2_coco"
    cfg.LOG_DIR = "./experiments/models/ssd_lite_mbv2_coco/logs"
    cfg.CHECKPOINTS_PREFIX = "ssd_lite_mbv2_coco"
    return cfg


def _voc_config(ssds: str, feature_layer, scope: str, name: str) -> AttrDict:
    """The shared body of ``experiments/cfgs/{ssd,fssd,rfb}_vgg16_train_voc.yml``,
    ``ssd_vgg16_train_voc_512.yml`` and ``ssd_resnet50_train_voc.yml``."""
    cfg = default_config()
    cfg.MODEL.update(SSDS=ssds, FEATURE_LAYER=feature_layer,
                     SIZES=[0.1, 0.2, 0.38, 0.56, 0.74, 0.92, 1.1])
    cfg.TRAIN.update(TRAINABLE_SCOPE=scope, RESUME_SCOPE="base")
    cfg.TRAIN.LR_SCHEDULER.update(SCHEDULER="sgdr", WARM_UP_EPOCHS=10)
    cfg.TEST.TEST_SCOPE = [290, 300]
    cfg.DATASET.DATASET_DIR = "./data/VOCdevkit"
    cfg.EXP_DIR = f"./experiments/models/{name}"
    cfg.LOG_DIR = f"./experiments/models/{name}/logs"
    cfg.CHECKPOINTS_PREFIX = name
    return cfg


def ssd_vgg16_config() -> AttrDict:
    """``experiments/cfgs/ssd_vgg16_train_voc.yml`` (SSD300-VGG16 on VOC07+12: the
    default model with the yml's sizes, scopes and sgdr schedule) over the
    defaults, written out for machines without PyYAML.
    ``tests/test_torch_port_parity_check.py`` holds it equal to the file."""
    return _voc_config("ssd", default_config().MODEL.FEATURE_LAYER, "base,norm,extras,loc,conf",
                       "ssd_vgg16_voc")


def fssd_vgg16_config() -> AttrDict:
    """``experiments/cfgs/fssd_vgg16_train_voc.yml`` (FSSD300-VGG16 on VOC07+12)
    over the defaults, written out for machines without PyYAML.
    ``tests/test_torch_port_fssd.py`` holds it equal to the file."""
    return _voc_config(
        "fssd", [[[22, 34, "S"], [512, 1024, 256]],
                 [["", "S", "S", "S", "0", "0"], [256, 512, 512, 256, 256, 256]]],
        "base,norm,extras,transforms,fusion,pyramids,loc,conf", "fssd_vgg16_voc")


def rfb_vgg16_config() -> AttrDict:
    """``experiments/cfgs/rfb_vgg16_train_voc.yml`` (RFBNet300-VGG16 on VOC07+12)
    over the defaults, written out for machines without PyYAML.
    ``tests/test_torch_port_rfb.py`` holds it equal to the file."""
    return _voc_config("rfb", [[22, "R", "S", "S", "", ""], [512, 1024, 512, 256, 256, 256]],
                             "base,norm,extras,loc,conf", "rfb_vgg16_voc")


def _yolo_voc_config(ssds: str, net: str, feature_layer, aspect_ratios, batch: int,
                     name: str) -> AttrDict:
    """The shared body of ``experiments/cfgs/yolo_v{2,3}_darknet_*_train_voc.yml``."""
    cfg = default_config()
    cfg.MODEL.update(SSDS=ssds, NETS=net, IMAGE_SIZE=[416, 416], FEATURE_LAYER=feature_layer,
                     ASPECT_RATIOS=aspect_ratios)
    cfg.TRAIN.update(BATCH_SIZE=batch, TRAINABLE_SCOPE="base,norm,extras,loc,conf",
                     RESUME_SCOPE="base")
    cfg.TRAIN.LR_SCHEDULER.update(SCHEDULER="sgdr", WARM_UP_EPOCHS=10)
    cfg.TEST.update(BATCH_SIZE=32, TEST_SCOPE=[290, 300])
    cfg.POST_PROCESS.IOU_THRESHOLD = 0.45
    cfg.DATASET.DATASET_DIR = "./data/VOCdevkit"
    cfg.EXP_DIR = f"./experiments/models/{name}"
    cfg.LOG_DIR = f"./experiments/models/{name}/logs"
    cfg.CHECKPOINTS_PREFIX = name
    return cfg


def yolo_v3_darknet53_config() -> AttrDict:
    """``experiments/cfgs/yolo_v3_darknet_53_train_voc.yml`` (YOLOv3-DarkNet53-416
    on VOC07+12, batch 16) over the defaults, written out for machines
    without PyYAML. ``tests/test_torch_port_yolo_models.py`` holds it equal to
    the file."""
    return _yolo_voc_config("yolo_v3", "darknet_53", [[14, 23, 28], [256, 512, 1024]],
                            [[2], [2], [2]], 16, "yolo_v3_darknet53_voc")


def yolo_v3_darknet53_coco_config() -> AttrDict:
    """``experiments/cfgs/yolo_v3_darknet_53_train_coco.yml`` (YOLOv3-DarkNet53-416
    on COCO 2017, 81 classes, batch 64) over the defaults, written out for
    machines without PyYAML. ``tests/test_torch_port_parity_check.py`` holds it
    equal to the file."""
    cfg = yolo_v3_darknet53_config()
    cfg.MODEL.NUM_CLASSES = cfg.POST_PROCESS.NUM_CLASSES = 81
    cfg.TRAIN.update(MAX_EPOCHS=250, BATCH_SIZE=64, TRAINABLE_SCOPE="base,extras,loc,conf")
    cfg.TRAIN.OPTIMIZER.update(LEARNING_RATE=0.01, WEIGHT_DECAY=4e-5)
    cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 5
    cfg.TEST.update(BATCH_SIZE=64, TEST_SCOPE=[240, 250])
    cfg.DATASET.update(DATASET="coco", DATASET_DIR="./data/coco",
                       TRAIN_SETS=[["2017", "train"]], TEST_SETS=[["2017", "val"]], MAX_GT=128)
    cfg.EXP_DIR = "./experiments/models/yolo_v3_darknet_53_coco"
    cfg.LOG_DIR = "./experiments/models/yolo_v3_darknet_53_coco/logs"
    cfg.CHECKPOINTS_PREFIX = "yolo_v3_darknet_53_coco"
    return cfg


def yolo_v2_darknet19_config() -> AttrDict:
    """``experiments/cfgs/yolo_v2_darknet_19_train_voc.yml`` (YOLOv2-DarkNet19-416
    on VOC07+12, batch 32), as :func:`yolo_v3_darknet53_config`."""
    return _yolo_voc_config("yolo_v2", "darknet_19", [[16, 22], [512, 1024]], [[2]], 32,
                            "yolo_v2_darknet19_voc")


def ssd_resnet50_config() -> AttrDict:
    """``experiments/cfgs/ssd_resnet50_train_voc.yml`` (SSD300-ResNet50 on
    VOC07+12, taps at the ends of stages 2-4) over the defaults, written out
    for machines without PyYAML. ``tests/test_torch_port_resnet.py`` holds it
    equal to the file."""
    cfg = _voc_config("ssd", [[7, 13, 16, "S", "S", ""], [512, 1024, 2048, 512, 256, 256]],
                            "base,norm,extras,loc,conf", "ssd_resnet50_voc")
    cfg.MODEL.NETS = "resnet_50"
    return cfg


def ssd512_vgg16_config() -> AttrDict:
    """``experiments/cfgs/ssd_vgg16_train_voc_512.yml`` (SSD512-VGG16 on
    VOC07+12: seven maps, 24,564 priors, batch 16) over the defaults, written
    out for machines without PyYAML. ``tests/test_torch_port_cfgs.py`` holds
    it equal to the file."""
    cfg = _voc_config("ssd", [[22, 34, "S", "S", "S", "S", "S"],
                                    [512, 1024, 512, 256, 256, 256, 256]],
                            "base,norm,extras,loc,conf", "ssd_vgg16_voc_512")
    cfg.MODEL.update(IMAGE_SIZE=[512, 512], SIZES=[0.07, 0.15, 0.3, 0.45, 0.6, 0.75, 0.9, 1.05],
                     ASPECT_RATIOS=[[2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2]])
    cfg.TRAIN.BATCH_SIZE = 16
    cfg.TEST.BATCH_SIZE = 32
    return cfg


#: the full-width configurations the port's tools take by short name:
#: (the name that reports print, the config)
MODELS = {
    "vgg": ("SSD300-VGG16", default_config),
    "lite": ("SSDLite-MobileNetV2-300", ssd_lite_mobilenetv2_config),
    "fssd": ("FSSD-VGG16-300", fssd_vgg16_config),
    "rfb": ("RFBNet-VGG16-300", rfb_vgg16_config),
    "yolo_v3": ("YOLOv3-DarkNet53-416", yolo_v3_darknet53_config),
    "yolo_v2": ("YOLOv2-DarkNet19-416", yolo_v2_darknet19_config),
    "resnet50": ("SSD300-ResNet50", ssd_resnet50_config),
    "ssd512": ("SSD512-VGG16", ssd512_vgg16_config),
}

#: ``experiments/cfgs/<yml>`` -> the maker that writes it out, for the ymls
#: of the mAP-parity table (``ssds_tpu_torch.tools.parity_check.ACCEPTANCE``)
YML_MAKERS = {
    "ssd_vgg16_train_voc.yml": ssd_vgg16_config,
    "ssd_vgg16_train_voc_512.yml": ssd512_vgg16_config,
    "fssd_vgg16_train_voc.yml": fssd_vgg16_config,
    "rfb_vgg16_train_voc.yml": rfb_vgg16_config,
    "ssd_lite_mobilenetv2_train_coco.yml": ssd_lite_mobilenetv2_coco_config,
    "yolo_v3_darknet_53_train_coco.yml": yolo_v3_darknet53_coco_config,
}

#: process-global singleton, for reference-API parity
cfg = default_config()


def _merge_a_into_b(a: dict, b: AttrDict, path: str = "") -> None:
    """Recursively merge yaml dict ``a`` into default tree ``b``, type-checked
    (unknown keys and type mismatches raise, as in the reference)."""
    for k, v in a.items():
        full = f"{path}.{k}" if path else k
        if k not in b:
            raise KeyError(f"{full} is not a valid config key")
        old = b[k]
        if isinstance(old, AttrDict):
            if not isinstance(v, dict):
                raise TypeError(f"config key {full}: expected mapping, got {type(v).__name__}")
            _merge_a_into_b(v, old, full)
            continue
        if old is not None and v is not None:
            old_t, new_t = type(old), type(v)
            if old_t is not new_t:
                if isinstance(old, (tuple, list)) and isinstance(v, (tuple, list)):
                    v = old_t(v)
                elif isinstance(old, bool) and isinstance(v, int):
                    v = bool(v)  # yaml `CLIP: 1` for a bool key
                elif isinstance(old, float) and isinstance(v, int):
                    v = float(v)
                else:
                    raise TypeError(
                        f"config key {full}: type mismatch ({old_t.__name__} vs {new_t.__name__})"
                    )
        b[k] = v


def cfg_from_file(filename: str, base: AttrDict | None = None) -> AttrDict:
    """Load a YAML experiment file merged over the defaults; returns a NEW
    tree and refreshes the module-global ``cfg`` in place. A ``.json`` file
    (JSON is YAML's subset) is read with the standard library, for machines
    without PyYAML."""
    with open(filename) as f:
        if filename.endswith(".json"):
            yaml_cfg = json.load(f)
        else:
            import yaml

            yaml_cfg = yaml.safe_load(f) or {}
    if not isinstance(yaml_cfg, dict):
        raise TypeError(f"{filename}: expected a YAML mapping, got {type(yaml_cfg).__name__}")
    out = copy.deepcopy(base) if base is not None else default_config()
    _merge_a_into_b(yaml_cfg, out)
    cfg.clear()
    cfg.update(copy.deepcopy(out))
    return out


def cfg_from_list(cfg_list, base: AttrDict | None = None) -> AttrDict:
    """Set config keys from a flat ``['KEY.SUBKEY', value, ...]`` list."""
    if len(cfg_list) % 2:
        raise ValueError("cfg_from_list needs KEY VALUE pairs")
    out = copy.deepcopy(base) if base is not None else copy.deepcopy(cfg)
    for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise KeyError(f"{key} is not a valid config key")
        if isinstance(value, str) and not isinstance(node[leaf], str):
            import yaml

            value = yaml.safe_load(value)
        _merge_a_into_b({leaf: value}, node, ".".join(parts[:-1]))
    cfg.clear()
    cfg.update(copy.deepcopy(out))
    return out
