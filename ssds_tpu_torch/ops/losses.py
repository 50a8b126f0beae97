"""MultiBox loss with hard-negative mining (counterpart of :mod:`ssds_tpu.ops.losses`).

Reference ``lib/layers/modules/multibox_loss.py``: match every image's GT to
the priors; smooth-L1 on the positive priors' loc predictions; rank the
negatives of each image by ``log_sum_exp(conf) - conf[gt]`` and keep the
``negpos_ratio * num_pos`` hardest (at most K - 1); softmax cross-entropy
over positives and kept negatives; both terms divided by the batch's
positive count (at least 1).

One batched function with no host synchronisation. The double argsort
sorts stably, as ``jnp.argsort`` does, so tied losses rank index-ascending
on every device; the class-dim selections are ``torch.gather``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssds_tpu_torch.ops.boxes import log_sum_exp
from ssds_tpu_torch.ops.matching import match_batch


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber with delta=1), as torch's ``smooth_l1_loss``."""
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def hard_negative_ranks(loss_c: torch.Tensor) -> torch.Tensor:
    """Per-image descending rank of each prior's mining loss.

    ``loss_c: [B, K]`` -> int64 ranks ``[B, K]``, rank 0 the largest loss,
    ties in index order (the reference's ``loss_c.sort(1, descending=True)``
    then ``loss_idx.sort(1)``, both stable).
    """
    loss_idx = torch.argsort(-loss_c, dim=1, stable=True)
    return torch.argsort(loss_idx, dim=1, stable=True)


def multibox_sums(
    loc_pred: torch.Tensor,
    conf_pred: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
    priors: torch.Tensor,
    *,
    threshold: float = 0.5,
    negpos_ratio: float = 3.0,
    variances=(0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MultiBox loss's sums over a batch.

    Args:
      loc_pred:  ``[B, K, 4]`` predicted offsets (any float dtype).
      conf_pred: ``[B, K, C]`` raw (pre-softmax) class logits, C incl. background.
      gt_boxes:  ``[B, G, 4]`` corner-form GT, zero-padded.
      gt_labels: ``[B, G]`` int class ids (0-based, background NOT included).
      gt_valid:  ``[B, G]`` bool validity mask.
      priors:    ``[K, 4]`` center-form anchors.

    Returns:
      float32 scalars ``(sum loss_loc, sum loss_conf, positives)``: the two
      sums over the batch and its positive count, which :func:`multibox_loss`
      divides by (a data-parallel step divides by the global count).
    """
    conf_pred = conf_pred.float()
    loc_pred = loc_pred.float()
    loc_t, conf_t = match_batch(gt_boxes, gt_labels, gt_valid, priors, threshold, variances)

    pos = conf_t > 0  # [B, K]
    num_pos = pos.sum(dim=1)  # [B]

    loss_l = torch.sum(smooth_l1(loc_pred - loc_t) * pos[..., None].float())

    # mining loss per prior; positives are never mined
    picked = torch.gather(conf_pred, 2, conf_t[..., None])[..., 0]
    loss_c = log_sum_exp(conf_pred)[..., 0] - picked
    loss_c = torch.where(pos, 0.0, loss_c)

    ranks = hard_negative_ranks(loss_c.detach())
    num_neg = torch.clamp(negpos_ratio * num_pos.float(), max=conf_pred.shape[1] - 1)
    neg = ranks < num_neg[:, None]  # compared as floats, as the JAX package does

    selected = (pos | neg).float()
    ce = -torch.gather(torch.log_softmax(conf_pred, dim=-1), 2, conf_t[..., None])[..., 0]
    loss_conf = torch.sum(ce * selected)

    return loss_l, loss_conf, num_pos.sum().float()


def multibox_loss(loc_pred, conf_pred, gt_boxes, gt_labels, gt_valid, priors,
                  **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss_loc, loss_conf)`` of a batch: :func:`multibox_sums` (same
    arguments), each sum divided by the batch's positive count, at least 1."""
    loss_l, loss_conf, num_pos = multibox_sums(loc_pred, conf_pred, gt_boxes, gt_labels,
                                               gt_valid, priors, **kwargs)
    n = torch.clamp(num_pos, min=1.0)
    return loss_l / n, loss_conf / n
