"""Greedy NMS in plain PyTorch: the oracle and the plain version of the kernel.

Counterpart of :mod:`ssds_tpu.ops.nms`. Semantics (reference
``box_utils.nms``): walk candidates best-first, keep a box, suppress every
later candidate whose IoU with it is strictly greater than the threshold.

Tie contract, as in the JAX package: equal scores rank index-ascending
(the stable descending order). ``torch.argmax`` returns the first maximum,
and :mod:`ssds_tpu_torch.ops.postprocess` sorts with ``stable=True``.

:func:`nms_mask_torch` is the plain version of the CUDA kernel in
:mod:`ssds_tpu_torch.ops.cuda.nms`: the CPU path of the wrapper and the
reference the kernel is held against on the card. The JAX package's
``sorted_nms_batched`` / ``sorted_nms_tiled`` are TPU formulations of the
same mask and have no counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssds_tpu_torch.ops.boxes import iou_pairwise, jaccard

# A score <= NEG_INF / 2 marks an absent (threshold-filtered or padded) entry.
NEG_INF = -1e30


def greedy_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.5,
    top_k: int = 200,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over one unsorted box set (argmax per step).

    Args:
      boxes: ``[N, 4]`` corner-form boxes.
      scores: ``[N]``; entries ``<= NEG_INF / 2`` (or non-finite) are absent.

    Returns:
      ``keep [top_k]`` int32 indices (-1 unused), ``keep_scores [top_k]``
      (0 unused) and the scalar ``count``.
    """
    n = boxes.shape[0]
    active = scores.float()
    active = torch.where(torch.isfinite(active), active, torch.full_like(active, NEG_INF))
    keep = torch.full((top_k,), -1, dtype=torch.int32, device=boxes.device)
    keep_scores = torch.zeros((top_k,), dtype=torch.float32, device=boxes.device)
    count = torch.zeros((), dtype=torch.int32, device=boxes.device)
    for t in range(min(top_k, n)):
        i = torch.argmax(active)
        s = active[i]
        valid = s > NEG_INF / 2
        keep[t] = torch.where(valid, i.to(torch.int32), -1)
        keep_scores[t] = torch.where(valid, s, 0.0)
        suppress = iou_pairwise(boxes[i], boxes) > iou_threshold
        active = torch.where(valid & suppress, NEG_INF, active)
        active[i] = NEG_INF  # retire the pick even if its self-IoU is 0
        count = count + valid.to(torch.int32)
    return keep, keep_scores, count


def nms_mask_torch(boxes: torch.Tensor, scores: torch.Tensor,
                   iou_threshold: float = 0.5) -> torch.Tensor:
    """Batched greedy-NMS keep mask by suppression propagation.

    Args:
      boxes: ``[M, N, 4]`` corner-form candidates, each row score-descending.
      scores: ``[M, N]``; entries ``<= NEG_INF / 2`` are invalid.

    Returns:
      ``[M, N]`` bool: ``keep_i = valid_i and no kept i' < i has
      IoU(i', i) > iou_threshold`` — ``vmap(ssds_tpu.ops.nms.sorted_nms)``.
    """
    m, n = scores.shape
    valid = scores > NEG_INF / 2
    idx = torch.arange(n, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    sup = (jaccard(boxes, boxes) > iou_threshold) & later  # [M, N, N]: i suppresses j
    suppressed = torch.zeros((m, n), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep_i = valid[:, i] & ~suppressed[:, i]
        suppressed |= sup[:, i, :] & keep_i[:, None]
    return valid & ~suppressed


def sorted_nms(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float = 0.5) -> torch.Tensor:
    """One slot of :func:`nms_mask_torch`: ``[N, 4], [N] -> keep [N]`` bool."""
    return nms_mask_torch(boxes[None], scores[None], iou_threshold)[0]
