"""Box geometry and the SSD prior boxes, in plain PyTorch and NumPy.

A frozen copy of the arithmetic the configurations state (ssds.pytorch's
``box_utils`` and ``PriorBox``): corner form ``(x1, y1, x2, y2)``, centre
form ``(cx, cy, w, h)``, coordinates normalised to ``[0, 1]``, SSD's
variance encoding. Kept beside the benchmark so that a later change of the
program cannot move it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    cxcy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxcy - wh / 2.0, cxcy + wh / 2.0], dim=-1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU ``[..., A, 4], [..., B, 4] -> [..., A, B]`` (0 where the union is 0)."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(box_a)[..., :, None] + area(box_b)[..., None, :] - inter
    pos = union > 0.0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)),
                       torch.zeros_like(inter))


def encode(matched: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    g_cxcy = (matched[..., :2] + matched[..., 2:]) / 2.0 - priors[..., :2]
    g_cxcy = g_cxcy / (variances[0] * priors[..., 2:])
    gt_wh = matched[..., 2:] - matched[..., :2]
    g_wh = torch.log(torch.clamp(gt_wh, min=1e-8) / priors[..., 2:]) / variances[1]
    return torch.cat([g_cxcy, g_wh], dim=-1)


def prior_boxes(image_size, feature_maps, aspect_ratios, sizes, clip: bool) -> np.ndarray:
    """SSD's priors ``[K, 4]`` (centre form, float32): per map k and cell
    (row-major), the square ``s_k``, the square ``sqrt(s_k s_{k+1})``, then
    for each aspect ratio ``ar`` the pair ``(s_k sqrt(ar), s_k / sqrt(ar))``
    and its transpose. ``sizes`` is ``[s_min, s_max]`` (spread linearly over
    the maps and one more) or one scale a map and one more."""
    img_h, img_w = image_size
    m = len(feature_maps)
    sizes = list(sizes)
    scales = np.linspace(sizes[0], sizes[1], m + 1) if len(sizes) == 2 and m != 1 \
        else np.asarray(sizes, np.float64)
    out = []
    for k, (fh, fw) in enumerate(feature_maps):
        step_h, step_w = img_h / fh, img_w / fw
        s_k, s_next = scales[k], math.sqrt(scales[k] * scales[k + 1])
        whs = [(s_k, s_k), (s_next, s_next)]
        for ar in aspect_ratios[k]:
            r = math.sqrt(ar)
            whs += [(s_k * r, s_k / r), (s_k / r, s_k * r)]
        whs = np.asarray(whs, np.float64)
        jj, ii = np.meshgrid(np.arange(fw), np.arange(fh))
        centres = np.stack([(jj + 0.5) * step_w / img_w, (ii + 0.5) * step_h / img_h],
                           axis=-1).reshape(fh * fw, 1, 2)
        a = len(whs)
        out.append(np.concatenate([np.broadcast_to(centres, (fh * fw, a, 2)),
                                   np.broadcast_to(whs, (fh * fw, a, 2))], -1).reshape(-1, 4))
    priors = np.concatenate(out).astype(np.float32)
    return np.clip(priors, 0.0, 1.0) if clip else priors
