"""Bipartite GT <-> prior matching (counterpart of :mod:`ssds_tpu.ops.matching`).

Reference ``box_utils.match``: each prior takes its best GT by IoU; then each
GT is forced onto its best prior (overlap set to 2), and where two GTs share a
best prior the later GT wins, as the reference's loop ``j = 0..G-1`` leaves
it; priors below ``threshold`` are background; loc targets are the matched
boxes encoded against the priors.

Ground truth is padded to ``[G, 4]`` with a validity mask, as the JAX
package pads it. The forcing is the JAX package's "largest valid GT index
whose best prior is k", computed by ``scatter_reduce(..., "amax")``, which
is order-free: an indexed assignment with repeated indices gives no promise
on CUDA of which write lands. The matched rows are plain ``gather``s (the
JAX package's one-hot selects are a TPU formulation of the same values).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssds_tpu_torch.ops.boxes import encode, jaccard, point_form


def match_batch(
    truths: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    priors: torch.Tensor,
    threshold: float = 0.5,
    variances=(0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match a batch of padded ground truth to the prior set.

    Args:
      truths: ``[B, G, 4]`` corner-form GT boxes, padded with zeros.
      labels: ``[B, G]`` int class indices (0-based, background NOT included).
      valid:  ``[B, G]`` bool mask of real (non-padding) GT rows.
      priors: ``[K, 4]`` center-form anchors.
      threshold: IoU below which a prior is background (reference: 0.5).
      variances: SSD encoding variances.

    Returns:
      ``loc_t [B, K, 4]`` encoded regression targets and ``conf_t [B, K]``
      int64 class targets, 0 = background and ``c + 1`` = class ``c``.
    """
    b, g = labels.shape
    overlaps = jaccard(truths, point_form(priors))  # [B, G, K]
    # padded GT rows never win a prior
    overlaps = torch.where(valid[..., None], overlaps, -1.0)

    best_truth_overlap = torch.amax(overlaps, dim=1)  # [B, K]
    best_truth_idx = torch.argmax(overlaps, dim=1)    # [B, K], first max as jnp.argmax
    best_prior_idx = torch.argmax(overlaps, dim=2)    # [B, G]

    # the largest valid GT index whose best prior is k, else -1
    gt_ids = torch.arange(g, device=truths.device).expand(b, g)
    forced_gt = torch.full_like(best_truth_idx, -1)
    forced_gt.scatter_reduce_(1, best_prior_idx, torch.where(valid, gt_ids, -1), reduce="amax")
    is_forced = forced_gt >= 0
    best_truth_idx = torch.where(is_forced, forced_gt, best_truth_idx)
    best_truth_overlap = torch.where(is_forced, 2.0, best_truth_overlap)

    matched = torch.gather(truths, 1, best_truth_idx[..., None].expand(-1, -1, 4))  # [B, K, 4]
    conf_t = torch.gather(labels.long(), 1, best_truth_idx) + 1
    conf_t = torch.where(best_truth_overlap < threshold, 0, conf_t)
    loc_t = encode(matched, priors, variances)
    # an image with no valid GT is all background
    conf_t = torch.where(valid.any(dim=1, keepdim=True), conf_t, 0)
    return loc_t, conf_t


def match(
    truths: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    priors: torch.Tensor,
    threshold: float = 0.5,
    variances=(0.1, 0.2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: ``[G, 4]``, ``[G]``, ``[G]`` -> ``(loc_t [K, 4], conf_t [K])``
    (:func:`match_batch` over a batch of one)."""
    loc_t, conf_t = match_batch(truths[None], labels[None], valid[None], priors,
                                threshold, variances)
    return loc_t[0], conf_t[0]
