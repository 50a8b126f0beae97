"""Model construction (counterpart of :mod:`ssds_tpu.models.builder`).

Reference ``lib/modeling/model_builder.py``: ``create_model(cfg.MODEL)``
builds the backbone layer list, hands it to the head builder, and measures
each pyramid level's size with a dummy forward (``phase='feature'``); a
YOLO head also takes ``cfg.MODEL`` (for ``MODEL.ANCHORS``) and has no
priors: it decodes its own boxes (:func:`is_yolo`). Here
the model is built and measured on the ``meta`` device — shapes only, no
memory and no arithmetic, the counterpart of the JAX package's
``jax.eval_shape`` — and :func:`init_model` materialises it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ssds_tpu_torch.models.backbones import networks_map
from ssds_tpu_torch.models.heads import ssds_map
from ssds_tpu_torch.models.layers import init_flax_defaults
from ssds_tpu_torch.ops.anchors import AnchorConfig, generate_anchors, num_anchors_per_cell


def _forward_features_size(model: nn.Module, image_size) -> List[Tuple[int, int]]:
    """Pyramid ``(H_k, W_k)`` sizes from an eval-mode forward on the meta
    device (a train-mode BatchNorm refuses the 1x1 maps of a batch of one)."""
    x = torch.empty((1, 3, int(image_size[0]), int(image_size[1])), device="meta")
    model.eval()
    with torch.no_grad():
        feats = model(x, phase="feature")
    return [(int(f.shape[2]), int(f.shape[3])) for f in feats]


def create_model(model_cfg) -> Tuple[nn.Module, List[Tuple[int, int]]]:
    """Build ``(model, feature_maps)`` from a ``cfg.MODEL`` subtree.

    The model lies on the ``meta`` device, uninitialised and in eval mode, as
    the JAX package returns an uninitialised flax module; :func:`init_model`
    gives it weights on a real device.
    """
    if model_cfg.NETS not in networks_map:
        raise KeyError(f"unknown or not yet ported backbone MODEL.NETS={model_cfg.NETS!r}")
    if model_cfg.SSDS not in ssds_map:
        raise KeyError(f"unknown or not yet ported head MODEL.SSDS={model_cfg.SSDS!r}")
    base = networks_map[model_cfg.NETS]()
    mbox = num_anchors_per_cell(model_cfg.ASPECT_RATIOS)
    extra = (model_cfg,) if is_yolo(model_cfg) else ()
    with torch.device("meta"):
        model = ssds_map[model_cfg.SSDS](base, model_cfg.FEATURE_LAYER, mbox,
                                         int(model_cfg.NUM_CLASSES), *extra)
    return model, _forward_features_size(model, model_cfg.IMAGE_SIZE)


def is_yolo(model_cfg) -> bool:
    """A YOLO head (``MODEL.SSDS`` ``yolo_*``): no priors, its own decode."""
    return str(model_cfg.SSDS).startswith("yolo")


def create_priors(model_cfg, feature_maps) -> np.ndarray:
    """The anchor set for a model config: ``[K, 4]`` center-form float32."""
    anchor_cfg = AnchorConfig(
        image_size=tuple(model_cfg.IMAGE_SIZE),
        feature_maps=tuple(feature_maps),
        aspect_ratios=tuple(tuple(a) for a in model_cfg.ASPECT_RATIOS),
        sizes=tuple(model_cfg.SIZES),
        steps=tuple(model_cfg.STEPS) if model_cfg.STEPS else (),
        clip=bool(model_cfg.CLIP),
    )
    return generate_anchors(anchor_cfg)


def init_model(model: nn.Module, seed: int = 0, device="cpu") -> nn.Module:
    """Materialise a meta-device model with flax's default init, seeded.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved, so one seed gives the same weights on every device.
    """
    model = model.to_empty(device="cpu")
    init_flax_defaults(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
