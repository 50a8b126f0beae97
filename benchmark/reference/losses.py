"""The training losses the configurations state, in plain PyTorch.

- SSD's MultiBox loss (ssds.pytorch ``MultiBoxLoss``): every prior takes its
  best GT by IoU, every GT is forced onto its best prior (the later GT wins
  a shared prior), priors under IoU 0.5 are background; smooth-L1 on the
  positives' offsets; the negatives ranked by ``logsumexp(conf) - conf[gt]``
  (stable), the ``3 * positives`` hardest kept; softmax cross-entropy over
  positives and kept negatives; both sums over the batch's positives.
- YOLOv3's loss: each GT on its best anchor by wh-IoU over all scales, at
  its centre's cell; squared error on ``sigmoid(xy)`` and on ``wh`` against
  the log ratio, weighted ``5 (2 - w h)``; binary cross-entropy on the
  classes and the objectness of the positives; objectness negatives where
  no GT overlaps the decoded box above 0.5; both sums over the batch.

Labels are 0-based without the background. GT is padded with a validity mask.
"""

from __future__ import annotations

from typing import Sequence

import torch

from benchmark.reference.boxes import encode, jaccard, point_form


def match(truths, labels, valid, priors, threshold: float = 0.5, variances=(0.1, 0.2)):
    """``[B, G, 4]``, ``[B, G]``, ``[B, G]`` against ``[K, 4]`` priors ->
    ``(loc_t [B, K, 4], conf_t [B, K])``, 0 the background."""
    b, g = labels.shape
    overlaps = torch.where(valid[..., None], jaccard(truths, point_form(priors)), -1.0)
    best_truth_overlap = torch.amax(overlaps, dim=1)
    best_truth_idx = torch.argmax(overlaps, dim=1)
    best_prior_idx = torch.argmax(overlaps, dim=2)
    gt_ids = torch.arange(g, device=truths.device).expand(b, g)
    forced = torch.full_like(best_truth_idx, -1)
    forced.scatter_reduce_(1, best_prior_idx, torch.where(valid, gt_ids, -1), reduce="amax")
    best_truth_idx = torch.where(forced >= 0, forced, best_truth_idx)
    best_truth_overlap = torch.where(forced >= 0, 2.0, best_truth_overlap)
    matched = torch.gather(truths, 1, best_truth_idx[..., None].expand(-1, -1, 4))
    conf_t = torch.gather(labels.long(), 1, best_truth_idx) + 1
    conf_t = torch.where(best_truth_overlap < threshold, 0, conf_t)
    conf_t = torch.where(valid.any(dim=1, keepdim=True), conf_t, 0)
    return encode(matched, priors, variances), conf_t


def multibox_loss(loc, conf, truths, labels, valid, priors, negpos_ratio: float = 3.0):
    loc, conf = loc.float(), conf.float()
    loc_t, conf_t = match(truths, labels, valid, priors)
    pos = conf_t > 0
    num_pos = pos.sum(dim=1)
    d = loc - loc_t
    ad = torch.abs(d)
    loss_l = torch.sum(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5) * pos[..., None].float())
    lse = torch.logsumexp(conf, dim=-1)
    mining = torch.where(pos, 0.0, lse - torch.gather(conf, 2, conf_t[..., None])[..., 0])
    order = torch.argsort(-mining.detach(), dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    num_neg = torch.clamp(negpos_ratio * num_pos.float(), max=conf.shape[1] - 1)
    selected = (pos | (ranks < num_neg[:, None])).float()
    ce = lse - torch.gather(conf, 2, conf_t[..., None])[..., 0]
    loss_c = torch.sum(ce * selected)
    n = torch.clamp(num_pos.sum().float(), min=1.0)
    return loss_l / n, loss_c / n


def yolo_decode(raw: torch.Tensor, anchors_px: torch.Tensor, img_hw):
    """One scale ``[B, H, W, A, 5+C]`` -> boxes ``[B, K, 4]`` (corner,
    normalised), objectness ``[B, K]``, class logits ``[B, K, C]``."""
    b, h, w, a, _ = raw.shape
    img_h, img_w = img_hw
    gx = torch.arange(w, dtype=torch.float32, device=raw.device)[None, None, :, None]
    gy = torch.arange(h, dtype=torch.float32, device=raw.device)[None, :, None, None]
    cx = (gx + torch.sigmoid(raw[..., 0])) / w
    cy = (gy + torch.sigmoid(raw[..., 1])) / h
    bw = anchors_px[:, 0] * torch.exp(raw[..., 2]) / img_w
    bh = anchors_px[:, 1] * torch.exp(raw[..., 3]) / img_h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    k = h * w * a
    return boxes.reshape(b, k, 4), torch.sigmoid(raw[..., 4]).reshape(b, k), \
        raw[..., 5:].reshape(b, k, -1)


def _bce(logits, targets):
    return torch.logaddexp(logits, torch.zeros_like(logits)) - logits * targets


def yolo_loss(raws: Sequence[torch.Tensor], anchors: Sequence[torch.Tensor], truths, labels,
              valid, img_hw, ignore: float = 0.5, coord_weight: float = 5.0):
    b = labels.shape[0]
    img_h, img_w = img_hw
    all_anchors = torch.cat(list(anchors))
    gt_w = truths[..., 2] - truths[..., 0]
    gt_h = truths[..., 3] - truths[..., 1]
    gt_cx = (truths[..., 0] + truths[..., 2]) / 2.0
    gt_cy = (truths[..., 1] + truths[..., 3]) / 2.0
    wh = torch.stack([gt_w * img_w, gt_h * img_h], dim=-1)
    inter = torch.minimum(wh[..., None, 0], all_anchors[:, 0]) * \
        torch.minimum(wh[..., None, 1], all_anchors[:, 1])
    union = (wh[..., 0] * wh[..., 1])[..., None] + all_anchors[:, 0] * all_anchors[:, 1] - inter
    ratio = inter / torch.clamp(union, min=1e-9)
    n_all = ratio.shape[-1]
    idx = torch.arange(n_all, device=ratio.device)
    best = torch.where(ratio == ratio.amax(-1, keepdim=True), idx, n_all).amin(-1)  # first max

    loss_l = truths.new_zeros(())
    loss_c = truths.new_zeros(())
    off = 0
    for raw, anc in zip(raws, anchors):
        _, h, w, a, ch = raw.shape
        k = h * w * a
        flat = raw.reshape(b, k, ch).float()
        on = (best >= off) & (best < off + a) & valid
        a_idx = torch.clamp(best - off, 0, a - 1)
        off += a
        cell_x = torch.clamp((gt_cx * w).to(torch.int32), 0, w - 1)
        cell_y = torch.clamp((gt_cy * h).to(torch.int32), 0, h - 1)
        slot = (cell_y.long() * w + cell_x.long()) * a + a_idx
        pred = torch.gather(flat, 1, slot[..., None].expand(-1, -1, ch))
        onf = on.float()
        tx, ty = gt_cx * w - cell_x.float(), gt_cy * h - cell_y.float()
        tw = torch.log(torch.clamp(gt_w, min=1e-9) / torch.clamp(anc[a_idx, 0] / img_w, min=1e-9))
        th = torch.log(torch.clamp(gt_h, min=1e-9) / torch.clamp(anc[a_idx, 1] / img_h, min=1e-9))
        sxy = torch.sigmoid(pred[..., 0:2])
        se = (sxy[..., 0] - tx) ** 2 + (sxy[..., 1] - ty) ** 2 \
            + (pred[..., 2] - tw) ** 2 + (pred[..., 3] - th) ** 2
        loss_l = loss_l + coord_weight * torch.sum(se * (2.0 - gt_w * gt_h) * onf)
        onehot = (labels[..., None] == torch.arange(ch - 5, device=labels.device)).float()
        loss_c = loss_c + torch.sum(_bce(pred[..., 5:], onehot) * onf[..., None])
        loss_c = loss_c + torch.sum(_bce(pred[..., 4], torch.ones_like(onf)) * onf)
        pos = torch.zeros(b, k, device=raw.device).scatter_reduce(
            1, slot, onf, reduce="amax") > 0
        boxes, _, _ = yolo_decode(raw.float(), anc, img_hw)
        ious = torch.where(valid[:, None, :], jaccard(boxes, truths), 0.0)
        neg = ~pos & (torch.amax(ious, dim=-1) <= ignore)
        loss_c = loss_c + torch.sum(_bce(flat[..., 4], torch.zeros_like(flat[..., 4]))
                                    * neg.float())
    return loss_l / b, loss_c / b
