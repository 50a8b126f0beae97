"""YOLO box decoding and the v3 / v2 training losses (counterpart of
:mod:`ssds_tpu.ops.yolo`), operation for operation in the JAX package's order.

Decoding (cell row ``i``, column ``j``, anchor ``a`` of an ``H x W`` grid,
model input ``img_hw``)::

    bx = (j + sigmoid(tx)) / W        bw = anchor_w * exp(tw) / img_w
    by = (i + sigmoid(ty)) / H        bh = anchor_h * exp(th) / img_h

giving corner-form boxes normalised to the model input, as the SSD
post-processing takes them.

:func:`yolo_loss` (YOLOv3) assigns each valid GT to its best wh-IoU anchor
over every scale; :func:`yolo_v2_loss` is darknet's region layer. Both
gather the predictions at each GT's cell and anchor (one loss row a GT, so
two GTs on one cell-anchor count twice) and scatter one dense positive mask
for the objectness negatives. That scatter is an OR: padded GTs still name a
cell (usually cell 0), so a plain indexed write, last write wins on CUDA,
could clear a positive; here it is ``scatter_reduce(..., "amax")``, the JAX
package's ``.at[...].max``.

Raw outputs ``[B, H, W, A, 5+C]`` (NHWC order, as the heads give them) are
taken to float32 first, whatever the model's dtype, as in JAX. Labels are
0-based with no background class. Both losses return ``(loss_loc,
loss_conf)`` divided by the batch size.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ssds_tpu_torch.ops.boxes import iou_pairwise, jaccard


def decode_scale(raw: torch.Tensor, anchors_px: torch.Tensor, img_hw: Tuple[int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One scale's raw output ``[B, H, W, A, 5+C]`` against its ``[A, 2]``
    (w, h) pixel anchors: boxes ``[B, H*W*A, 4]`` (corner form, normalised),
    objectness ``[B, H*W*A]`` (after the sigmoid) and class logits
    ``[B, H*W*A, C]``, in (row, column, anchor) order."""
    b, h, w, a, _ = raw.shape
    img_h, img_w = img_hw
    gx = torch.arange(w, dtype=torch.float32, device=raw.device)[None, :].expand(h, w)  # column j
    gy = torch.arange(h, dtype=torch.float32, device=raw.device)[:, None].expand(h, w)  # row i
    cx = (gx[None, :, :, None] + torch.sigmoid(raw[..., 0])) / w
    cy = (gy[None, :, :, None] + torch.sigmoid(raw[..., 1])) / h
    anchors = anchors_px.float()
    bw = anchors[None, None, None, :, 0] * torch.exp(raw[..., 2]) / img_w
    bh = anchors[None, None, None, :, 1] * torch.exp(raw[..., 3]) / img_h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    obj = torch.sigmoid(raw[..., 4])
    k = h * w * a
    return boxes.reshape(b, k, 4), obj.reshape(b, k), raw[..., 5:].reshape(b, k, -1)


def _bce_logits(logits: torch.Tensor, targets) -> torch.Tensor:
    """Elementwise binary cross-entropy from logits, ``softplus(x) - x t``,
    with softplus as ``logaddexp(x, 0)`` (JAX's): its gradient is
    ``sigmoid(x) - t`` everywhere, 0.5 - t at x = 0 too."""
    return torch.logaddexp(logits, torch.zeros_like(logits)) - logits * targets


def _one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for a label outside ``[0, c)``."""
    return (labels[..., None] == torch.arange(c, device=labels.device)).float()


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum over the last axis (``jnp.argmax``'s tie rule)."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.amax(dim=-1, keepdim=True), idx, n).amin(dim=-1)


def _wh_iou_best(gt_w, gt_h, anchors: torch.Tensor, img_hw) -> torch.Tensor:
    """``[B, G]`` index of each GT's best anchor by wh-IoU (first on ties)."""
    img_h, img_w = img_hw
    gt_wh_px = torch.stack([gt_w * img_w, gt_h * img_h], dim=-1)  # [B, G, 2]
    inter = torch.minimum(gt_wh_px[..., None, 0], anchors[None, None, :, 0]) * torch.minimum(
        gt_wh_px[..., None, 1], anchors[None, None, :, 1])
    union = (gt_wh_px[..., 0] * gt_wh_px[..., 1])[..., None] + (
        anchors[:, 0] * anchors[:, 1])[None, None, :] - inter
    return _first_argmax(inter / torch.clamp(union, min=1e-9))


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[b, idx[b, g]]``: ``[B, K, D], [B, G] -> [B, G, D]``."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def positive_mask(k: int, flat_idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """``[B, K]`` bool: True at every ``flat_idx[b, g]`` whose ``on[b, g]``
    holds, an OR over the GTs that share an index (JAX's
    ``zeros.at[b, idx].max(on)``)."""
    zeros = torch.zeros(flat_idx.shape[0], k, dtype=torch.float32, device=flat_idx.device)
    return zeros.scatter_reduce(1, flat_idx, on.float(), reduce="amax") > 0


def _cells(gt_cx, gt_cy, h: int, w: int):
    """Each GT centre's cell: ``int32`` truncation toward zero, then clipped."""
    cell_x = torch.clamp((gt_cx * w).to(torch.int32), 0, w - 1)
    cell_y = torch.clamp((gt_cy * h).to(torch.int32), 0, h - 1)
    return cell_x, cell_y


def _targets(gt_cx, gt_cy, gt_w, gt_h, cell_x, cell_y, anchors_px, a_idx, h, w, img_hw):
    """Coordinate targets ``(tx, ty, tw, th)`` of each GT at its cell and anchor."""
    img_h, img_w = img_hw
    tx = gt_cx * w - cell_x.float()
    ty = gt_cy * h - cell_y.float()
    aw = anchors_px[a_idx, 0] / img_w
    ah = anchors_px[a_idx, 1] / img_h
    tw = torch.log(torch.clamp(gt_w, min=1e-9) / torch.clamp(aw, min=1e-9))
    th = torch.log(torch.clamp(gt_h, min=1e-9) / torch.clamp(ah, min=1e-9))
    return tx, ty, tw, th


def yolo_loss(raw_outputs: Sequence[torch.Tensor], anchors_per_scale: Sequence[torch.Tensor],
              gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              img_hw: Tuple[int, int], *, ignore_threshold: float = 0.5,
              noobj_weight: float = 1.0, coord_weight: float = 5.0,
              class_weight: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """YOLOv3 multi-scale loss (``ssds_tpu/ops/yolo.py::yolo_loss``).

    Args:
      raw_outputs: per-scale ``[B, H, W, A, 5+C]``, highest resolution first.
      anchors_per_scale: per-scale ``[A, 2]`` pixel anchors, same order.
      gt_boxes: ``[B, G, 4]`` corner form, normalised, zero-padded.
      gt_labels: ``[B, G]`` 0-based class ids; gt_valid: ``[B, G]`` bool.
    """
    b = gt_labels.shape[0]
    anchors_list = [a.float() for a in anchors_per_scale]
    all_anchors = torch.cat(anchors_list)  # [sumA, 2]
    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0]
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1]
    best_anchor = _wh_iou_best(gt_w, gt_h, all_anchors, img_hw)  # [B, G]
    gt_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0
    gt_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0

    total_loc, total_conf = 0.0, 0.0
    a_off = 0
    for raw, anchors_px in zip(raw_outputs, anchors_list):
        _, h, w, a, ch = raw.shape
        c, k = ch - 5, h * w * a
        raw_flat = raw.reshape(b, k, ch).float()

        on_scale = (best_anchor >= a_off) & (best_anchor < a_off + a) & gt_valid  # [B, G]
        a_idx = torch.clamp(best_anchor - a_off, 0, a - 1)
        a_off += a
        cell_x, cell_y = _cells(gt_cx, gt_cy, h, w)
        flat_idx = (cell_y.long() * w + cell_x.long()) * a + a_idx  # [B, G]

        # positive terms: the predictions at each GT's cell-anchor
        pred = _gather_rows(raw_flat, flat_idx)  # [B, G, 5+C]
        onf = on_scale.float()
        tx, ty, tw, th = _targets(gt_cx, gt_cy, gt_w, gt_h, cell_x, cell_y, anchors_px, a_idx,
                                  h, w, img_hw)
        box_scale = (2.0 - gt_w * gt_h) * onf
        pred_xy = torch.sigmoid(pred[..., 0:2])
        loss_xy = torch.square(pred_xy[..., 0] - tx) + torch.square(pred_xy[..., 1] - ty)
        loss_wh = torch.square(pred[..., 2] - tw) + torch.square(pred[..., 3] - th)
        total_loc = total_loc + coord_weight * torch.sum((loss_xy + loss_wh) * box_scale)

        cls_t = _one_hot(gt_labels, c)
        total_conf = total_conf + class_weight * torch.sum(
            _bce_logits(pred[..., 5:], cls_t) * onf[..., None])
        total_conf = total_conf + torch.sum(_bce_logits(pred[..., 4], torch.ones_like(onf)) * onf)

        # negative objectness over the dense grid
        pos_mask = positive_mask(k, flat_idx, on_scale)
        boxes_dec, _, _ = decode_scale(raw.float(), anchors_px, img_hw)
        ious = jaccard(boxes_dec, gt_boxes)  # [B, K, G]
        ious = torch.where(gt_valid[:, None, :], ious, 0.0)
        best_iou = torch.amax(ious, dim=-1)  # [B, K]
        neg_mask = ~pos_mask & (best_iou <= ignore_threshold)
        obj_bce = _bce_logits(raw_flat[..., 4], torch.zeros_like(raw_flat[..., 4]))
        total_conf = total_conf + noobj_weight * torch.sum(obj_bce * neg_mask.float())

    return total_loc / b, total_conf / b


def yolo_v2_loss(raw_outputs: Sequence[torch.Tensor], anchors_per_scale: Sequence[torch.Tensor],
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 img_hw: Tuple[int, int], *, seen_images: float = math.inf,
                 ignore_threshold: float = 0.6, object_scale: float = 5.0,
                 noobject_scale: float = 1.0, class_scale: float = 1.0,
                 coord_scale: float = 1.0, prior_scale: float = 0.01,
                 prior_seen: float = 12800.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """YOLOv2 region loss (``ssds_tpu/ops/yolo.py::yolo_v2_loss``): one scale,
    anchors matched within it; MSE coordinates weighted ``coord_scale * (2 -
    w h)``; objectness as squared error on its sigmoid, positives toward the
    (detached) IoU of the predicted box with its GT, negatives toward 0 unless
    above ``ignore_threshold``; softmax cross-entropy over the classes; and
    while ``seen_images < prior_seen`` every cell also regressed toward its
    anchor (``prior_scale``). Same arguments as :func:`yolo_loss`."""
    b = gt_labels.shape[0]
    raw = raw_outputs[0]
    anchors_px = anchors_per_scale[0].float()  # [A, 2]
    _, h, w, a, ch = raw.shape
    k = h * w * a
    raw_flat = raw.reshape(b, k, ch).float()

    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0]
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1]
    gt_cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0
    gt_cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0
    a_idx = _wh_iou_best(gt_w, gt_h, anchors_px, img_hw)  # [B, G]
    cell_x, cell_y = _cells(gt_cx, gt_cy, h, w)
    flat_idx = (cell_y.long() * w + cell_x.long()) * a + a_idx  # [B, G]
    onf = gt_valid.float()

    pred = _gather_rows(raw_flat, flat_idx)  # [B, G, 5+C]
    boxes_dec, _, _ = decode_scale(raw.float(), anchors_px, img_hw)

    # coordinates (MSE, small boxes weighted up)
    tx, ty, tw, th = _targets(gt_cx, gt_cy, gt_w, gt_h, cell_x, cell_y, anchors_px, a_idx, h, w,
                              img_hw)
    pred_xy = torch.sigmoid(pred[..., 0:2])
    coord_se = (torch.square(pred_xy[..., 0] - tx) + torch.square(pred_xy[..., 1] - ty)
                + torch.square(pred[..., 2] - tw) + torch.square(pred[..., 3] - th))
    box_scale = coord_scale * (2.0 - gt_w * gt_h) * onf
    total_loc = torch.sum(coord_se * box_scale)

    # the warm-up: every cell toward its anchor
    sig_xy = torch.sigmoid(raw_flat[..., 0:2])
    prior_se = (torch.square(sig_xy[..., 0] - 0.5) + torch.square(sig_xy[..., 1] - 0.5)
                + torch.square(raw_flat[..., 2]) + torch.square(raw_flat[..., 3]))
    warm = float(seen_images < prior_seen)
    total_loc = total_loc + warm * prior_scale * torch.sum(prior_se)

    # objectness: squared error on the sigmoid, positives rescored to their IoU
    sig_obj_all = torch.sigmoid(raw_flat[..., 4])  # [B, K]
    iou_t = iou_pairwise(_gather_rows(boxes_dec, flat_idx), gt_boxes).detach()  # [B, G]
    sig_obj_pos = torch.sigmoid(pred[..., 4])
    total_conf = object_scale * torch.sum(torch.square(iou_t - sig_obj_pos) * onf)

    pos_mask = positive_mask(k, flat_idx, gt_valid)
    ious = torch.where(gt_valid[:, None, :], jaccard(boxes_dec, gt_boxes), 0.0)  # [B, K, G]
    neg_mask = ~pos_mask & (torch.amax(ious, dim=-1) <= ignore_threshold)
    total_conf = total_conf + noobject_scale * torch.sum(
        torch.square(sig_obj_all) * neg_mask.float())

    # classes: softmax cross-entropy at the positive slots
    logp = F.log_softmax(pred[..., 5:], dim=-1)
    ce = -torch.gather(logp, -1, gt_labels.long()[..., None])[..., 0]
    total_conf = total_conf + class_scale * torch.sum(ce * onf)

    return total_loc / b, total_conf / b
