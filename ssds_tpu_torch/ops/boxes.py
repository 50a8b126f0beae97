"""Box geometry: corner/center forms, IoU, variance encode/decode.

Counterpart of :mod:`ssds_tpu.ops.boxes`, operation for operation in the
same order, so float32 results agree to the last bit where neither side
contracts a multiply-add. Shapes are the JAX package's, with leading batch
dims broadcast: "corner" form is ``(x1, y1, x2, y2)``, "center" form is
``(cx, cy, w, h)``, coordinates normalised to ``[0, 1]``.
"""

from __future__ import annotations

import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """``(cx, cy, w, h)`` -> ``(x1, y1, x2, y2)``."""
    cxcy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxcy - wh / 2.0, cxcy + wh / 2.0], dim=-1)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """``(x1, y1, x2, y2)`` -> ``(cx, cy, w, h)``."""
    mins, maxs = boxes[..., :2], boxes[..., 2:]
    return torch.cat([(mins + maxs) / 2.0, maxs - mins], dim=-1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area: ``[..., A, 4], [..., B, 4] -> [..., A, B]``."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    return wh[..., 0] * wh[..., 1]


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of corner-form boxes, negative extents clamped to 0: ``[..., 4] -> [...]``."""
    wh = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def _safe_iou(inter: torch.Tensor, union: torch.Tensor) -> torch.Tensor:
    """``inter / union`` where ``union > 0``, else 0 (degenerate boxes)."""
    pos = union > 0.0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(inter))


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: ``[..., A, 4], [..., B, 4] -> [..., A, B]``."""
    inter = intersect(box_a, box_b)
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    return _safe_iou(inter, union)


def iou_pairwise(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU between aligned boxes: ``[..., 4] -> [...]``."""
    max_xy = torch.minimum(box_a[..., 2:], box_b[..., 2:])
    min_xy = torch.maximum(box_a[..., :2], box_b[..., :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(box_a) + area(box_b) - inter
    return _safe_iou(inter, union)


def encode(matched: torch.Tensor, priors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """Corner-form boxes against center-form priors -> SSD offsets ``[..., K, 4]``."""
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2.0 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    gt_wh = matched[..., 2:] - matched[..., :2]
    g_wh = torch.log(torch.clamp(gt_wh, min=1e-8) / priors[..., 2:]) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def decode(loc: torch.Tensor, priors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD offsets ``[..., K, 4]`` against center-form priors ``[K, 4]`` ->
    corner-form boxes ``[..., K, 4]`` (inverse of :func:`encode`)."""
    cxcy = priors[..., :2] + loc[..., :2] * variances[0] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    return torch.cat([cxcy - wh / 2.0, cxcy + wh / 2.0], dim=-1)


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    """Stable ``log(sum(exp(x)))`` over the last axis, keepdims."""
    x_max = torch.amax(x, dim=-1, keepdim=True)
    return torch.log(torch.sum(torch.exp(x - x_max), dim=-1, keepdim=True)) + x_max
