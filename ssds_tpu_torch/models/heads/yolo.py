"""The YOLO v2 / v3 heads (counterpart of :mod:`ssds_tpu.models.heads.yolo`).

Reference ``lib/modeling/ssds/yolo.py``: 1x1 detection convs emitting
``A * (5 + C)`` channels a cell; v2 adds the passthrough route (a 1x1 conv
and a space-to-depth reorg of the stride-16 map, concatenated before the
last conv); v3 predicts at three scales with upsample-and-concat routes.

Phases:

- ``'feature'``: the maps the predictors read (v3 ``[t8, t16, t32]``, v2 ``[y]``);
- ``'train'``: the raw outputs, one ``[B, H, W, A, 5+C]`` a scale (NHWC
  order, the conv's channels ``(anchor, 5+C)``), highest resolution first;
- ``'eval'``: :meth:`YOLO.decode` of those: ``(boxes [B, K, 4], scores
  [B, K, 1+C])`` in float32, K in (scale, row, column, anchor) order,
  column 0 of the scores ``1 - objectness`` and column ``1+c``
  ``objectness * sigmoid(class_c)``, what
  :func:`ssds_tpu_torch.ops.postprocess.detect_decoded` takes.

The solver and the detector run the ``'train'`` phase once and decode it,
so an eval batch needs one forward for both its loss and its detections.

Module names are the flax ones (``extras_0``, ``extras_route``,
``extras_t32``, ``extras_o16``, ``conf0``, ...): the scope words ``extras``
and ``conf`` select them as they select the JAX package's (``reorg``,
``upsample16`` and ``upsample8`` have no parameters), and
``ssds_tpu/torch_import.py`` places a ``.pth`` of this layout (a
:class:`ConvSet`'s convs are ``ConvBNReLU_{k}``, flax's names, and a
``conf{k}`` conv's ``weight`` lands on flax's ``conf{k}/Conv_0/kernel``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from ssds_tpu_torch.models.heads.common import run_layers
from ssds_tpu_torch.models.layers import Conv, ConvBNReLU, LayerSpec, Resize, build_layers
from ssds_tpu_torch.ops.yolo import decode_scale

# Default pixel anchors (YOLO papers, 416 input), high-res scale first.
YOLO_V3_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
YOLO_V2_ANCHORS = (
    ((27, 37), (87, 102), (173, 236), (339, 216), (382, 383)),
)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """YOLOv2's reorg: NCHW ``[B, C, H, W] -> [B, C*b*b, H/b, W/b]``, the
    output channels ordered (row offset, column offset, channel), as the JAX
    package's NHWC reshape orders them. (``F.pixel_unshuffle`` orders them
    (channel, row offset, column offset).)"""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, block * block * c, h // block, w // block)


class Reorg(nn.Module):
    """The reorg, :func:`space_to_depth`, as a module with no parameters: on
    the spatial axis :func:`ssds_tpu_torch.parallel.spatial.partition`
    gives it its rows' geometry (a 2-row window, stride 2, no padding) and
    a banded forward, as it gives a conv."""

    def __init__(self, block: int = 2):
        super().__init__()
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return space_to_depth(x, self.block)


def _leaky(cin: int, ch: int, kernel: int) -> ConvBNReLU:
    return ConvBNReLU(cin, ch, kernel, padding=kernel // 2, act="leaky")


class ConvSet(nn.Sequential):
    """YOLOv3's five-conv block: 1x1 (ch), 3x3 (2ch), 1x1, 3x3, 1x1, each
    conv-BN-leaky, named ``ConvBNReLU_0-4``."""

    def __init__(self, in_channels: int, features: int):
        widths = (features, 2 * features, features, 2 * features, features)
        layers, cin = [], in_channels
        for i, ch in enumerate(widths):
            layers.append((f"ConvBNReLU_{i}", _leaky(cin, ch, 3 if i % 2 else 1)))
            cin = ch
        super().__init__(OrderedDict(layers))
        self.out_channels = features


class YOLO(nn.Module):
    """A backbone and a YOLO head.

    Args:
      base: the backbone's layer specs.
      taps: backbone indices of the sources (v2 uses the last two, v3 the
        last three).
      anchors: per-scale ``(w, h)`` pixel anchors, highest resolution first.
      num_classes: real classes (no background).
      version: 2 or 3.
      declared_channels: FEATURE_LAYER's channel group, when the config
        gives one: it must equal the taps' widths, or this raises.
    """

    def __init__(self, base: Sequence[LayerSpec], taps: Sequence[int],
                 anchors: Tuple, num_classes: int, version: int = 3,
                 declared_channels: Tuple[int, ...] = (), in_channels: int = 3):
        super().__init__()
        self.taps = tuple(taps)
        self.anchors = tuple(tuple(tuple(float(v) for v in wh) for wh in scale)
                             for scale in anchors)
        self.num_anchors = tuple(len(a) for a in self.anchors)
        self.num_classes = num_classes
        self.version = version
        self.base, widths = build_layers(base, in_channels)
        got = tuple(widths[t] for t in self.taps)
        if declared_channels and got != tuple(declared_channels):
            raise ValueError(
                f"MODEL.FEATURE_LAYER declares channels {tuple(declared_channels)} for taps "
                f"{self.taps}, but the backbone produces {got}: fix the yml's channel group "
                "(or drop it to accept the backbone's channels)")
        out = [a * (5 + num_classes) for a in self.num_anchors]
        if version == 2:
            c16, c32 = got[-2:]
            self.extras_0 = _leaky(c32, 1024, 3)
            self.extras_1 = _leaky(1024, 1024, 3)
            self.extras_route = _leaky(c16, 64, 1)
            self.reorg = Reorg(2)
            self.extras_2 = _leaky(4 * 64 + 1024, 1024, 3)
            self.conf0 = Conv(1024, out[0], 1, padding=0)
        else:
            c8, c16, c32 = got[-3:]
            self.extras_t32 = ConvSet(c32, 512)
            self.extras_o32 = _leaky(512, 1024, 3)
            self.conf2 = Conv(1024, out[-1], 1, padding=0)
            self.extras_r16 = _leaky(512, 256, 1)
            self.upsample16 = Resize()
            self.extras_t16 = ConvSet(256 + c16, 256)
            self.extras_o16 = _leaky(256, 512, 3)
            self.conf1 = Conv(512, out[-2], 1, padding=0)
            self.extras_r8 = _leaky(256, 128, 1)
            self.upsample8 = Resize()
            self.extras_t8 = ConvSet(128 + c8, 128)
            self.extras_o8 = _leaky(128, 256, 3)
            self.conf0 = Conv(256, out[-3], 1, padding=0)
        self._anchor_tensors: dict = {}

    @property
    def predictors(self) -> List[nn.Module]:
        """The convs whose outputs the loss reads (``conf0`` ... highest
        resolution first): the spatial axis gathers them whole."""
        return [getattr(self, f"conf{k}") for k in range(len(self.num_anchors))]

    def anchor_tensors(self, device) -> list:
        """The per-scale ``[A, 2]`` float32 anchors on ``device`` (made once)."""
        device = torch.device(device)
        if device not in self._anchor_tensors:
            self._anchor_tensors[device] = [torch.tensor(a, dtype=torch.float32, device=device)
                                            for a in self.anchors]
        return self._anchor_tensors[device]

    def forward(self, x: torch.Tensor, phase: str = "train"):
        img_hw = (x.shape[2], x.shape[3])
        sources, _ = run_layers(self.base, self.taps, x)
        if self.version == 2:
            s16, s32 = sources[-2:]
            y = self.extras_1(self.extras_0(s32))
            route = self.reorg(self.extras_route(s16))
            y = self.extras_2(torch.cat([route, y], dim=1))
            outs, feats = [self.conf0(y)], [y]
        else:
            s8, s16, s32 = sources[-3:]
            t32 = self.extras_t32(s32)
            o32 = self.conf2(self.extras_o32(t32))
            r16 = self.upsample16(self.extras_r16(t32), s16.shape[2:])
            t16 = self.extras_t16(torch.cat([r16, s16], dim=1))
            o16 = self.conf1(self.extras_o16(t16))
            r8 = self.upsample8(self.extras_r8(t16), s8.shape[2:])
            t8 = self.extras_t8(torch.cat([r8, s8], dim=1))
            o8 = self.conf0(self.extras_o8(t8))
            outs, feats = [o8, o16, o32], [t8, t16, t32]
        if phase == "feature":
            return feats
        raw = [o.permute(0, 2, 3, 1).reshape(o.shape[0], o.shape[2], o.shape[3], a,
                                             5 + self.num_classes)
               for o, a in zip(outs, self.num_anchors)]
        if phase == "eval":
            return self.decode(raw, img_hw)
        return raw

    def decode(self, raw: Sequence[torch.Tensor], img_hw: Tuple[int, int]):
        """The ``'eval'`` packaging of the raw outputs: ``(boxes [B, K, 4],
        scores [B, K, 1+C])`` float32, decoded against ``img_hw``, the model
        input's size."""
        boxes_all, scores_all = [], []
        for r, anchors_px in zip(raw, self.anchor_tensors(raw[0].device)):
            boxes, obj, cls = decode_scale(r.float(), anchors_px, img_hw)
            cls_scores = obj[..., None] * torch.sigmoid(cls)  # [B, K, C]
            boxes_all.append(boxes)
            scores_all.append(torch.cat([(1.0 - obj)[..., None], cls_scores], dim=-1))
        return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)

    def num_boxes(self, feature_maps: Sequence[Tuple[int, int]]) -> int:
        """Decoded boxes an image: ``sum(H * W * A)`` over the scales of
        ``feature_maps`` (the ``'feature'`` phase's sizes)."""
        return sum(h * w * a for (h, w), a in zip(feature_maps, self.num_anchors))


def _anchors_from_cfg(model_cfg, default):
    """``MODEL.ANCHORS`` when the config sets it, else ``default``."""
    raw = getattr(model_cfg, "ANCHORS", None) if model_cfg is not None else None
    if not raw:
        return default
    return tuple(tuple((float(w), float(h)) for w, h in scale) for scale in raw)


def _declared_channels(feature_layer):
    """FEATURE_LAYER's optional second group (the taps' channels)."""
    if len(feature_layer) > 1 and feature_layer[1]:
        return tuple(int(ch) for ch in feature_layer[1])
    return ()


def _build(version, default, base, feature_layer, num_classes, model_cfg) -> YOLO:
    return YOLO(base, tuple(int(i) for i in feature_layer[0]),
                _anchors_from_cfg(model_cfg, default), num_classes - 1, version=version,
                declared_channels=_declared_channels(feature_layer))


def build_yolo_v2(base, feature_layer, mbox, num_classes, model_cfg=None) -> YOLO:
    """YOLOv2; ``num_classes`` counts the background (``NUM_CLASSES``), the
    head predicts ``num_classes - 1``; ``mbox`` is unused (the anchors are
    ``MODEL.ANCHORS`` or :data:`YOLO_V2_ANCHORS`)."""
    return _build(2, YOLO_V2_ANCHORS, base, feature_layer, num_classes, model_cfg)


def build_yolo_v3(base, feature_layer, mbox, num_classes, model_cfg=None) -> YOLO:
    """YOLOv3, as :func:`build_yolo_v2` with :data:`YOLO_V3_ANCHORS`."""
    return _build(3, YOLO_V3_ANCHORS, base, feature_layer, num_classes, model_cfg)
