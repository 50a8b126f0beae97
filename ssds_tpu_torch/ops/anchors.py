"""Prior-box (anchor) generation, in numpy.

Counterpart of :mod:`ssds_tpu.ops.anchors`, with the same arithmetic in the
same order, so the two give bit-equal ``[K, 4]`` float32 arrays (tested).
It is carried here rather than imported because importing
``ssds_tpu.ops.anchors`` runs ``ssds_tpu/ops/__init__.py``, which imports
jax.

For each feature map k of size ``(H_k, W_k)`` and each cell ``(i, j)``::

    cx = (j + 0.5) * step_k / W_img ;  cy = (i + 0.5) * step_k / H_img

and per cell, in order: the min-size square ``s_k``, the square
``sqrt(s_k * s_{k+1})``, then for each aspect ratio ``ar`` the pair
``(s_k*sqrt(ar), s_k/sqrt(ar))``, ``(s_k/sqrt(ar), s_k*sqrt(ar))``. Cells are
row-major (``i`` outer, ``j`` inner), then anchor index — the order of the
heads' ``permute(0, 2, 3, 1).reshape(B, -1, 4)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Static description of the anchor set for one model config.

    ``sizes``: ``[s_min, s_max]`` (interpolated into ``num_maps + 1``
    scales) or an explicit list of ``num_maps + 1`` scales.
    ``steps``: per-map stride in pixels; empty means ``image / feature``.
    """

    image_size: tuple  # (H, W)
    feature_maps: tuple  # ((H_k, W_k), ...)
    aspect_ratios: tuple  # ((2,), (2, 3), ...)
    sizes: tuple
    steps: tuple = ()
    clip: bool = True


def _resolve_scales(cfg: AnchorConfig) -> np.ndarray:
    """Per-map scale fractions, ``num_maps + 1`` entries."""
    m = len(cfg.feature_maps)
    sizes = list(cfg.sizes)
    if len(sizes) == 2 and m != 1:
        s_min, s_max = sizes
        return np.linspace(s_min, s_max, m + 1)
    if len(sizes) == m + 1:
        return np.asarray(sizes, dtype=np.float64)
    raise ValueError(
        f"SIZES must be [s_min, s_max] or have num_maps+1={m + 1} entries; got {sizes}"
    )


def num_anchors_per_cell(aspect_ratios: Sequence[Sequence[float]]) -> list:
    """Anchors per cell for each map: 2 squares + 2 per aspect ratio."""
    return [2 + 2 * len(ars) for ars in aspect_ratios]


def generate_anchors(cfg: AnchorConfig) -> np.ndarray:
    """The full anchor set as a float32 ``[K, 4]`` center-form array."""
    img_h, img_w = cfg.image_size
    scales = _resolve_scales(cfg)
    all_anchors = []
    for k, (fh, fw) in enumerate(cfg.feature_maps):
        if cfg.steps:
            step = cfg.steps[k]
            step_h, step_w = (step, step) if np.isscalar(step) else (step[0], step[1])
        else:
            step_h, step_w = img_h / fh, img_w / fw

        s_k = scales[k]
        s_prime = math.sqrt(scales[k] * scales[k + 1])
        whs = [(s_k, s_k), (s_prime, s_prime)]
        for ar in cfg.aspect_ratios[k]:
            r = math.sqrt(ar)
            whs.append((s_k * r, s_k / r))
            whs.append((s_k / r, s_k * r))
        whs = np.asarray(whs, dtype=np.float64)  # [A, 2] (w, h)

        jj, ii = np.meshgrid(np.arange(fw), np.arange(fh))
        cx = (jj + 0.5) * step_w / img_w
        cy = (ii + 0.5) * step_h / img_h
        centers = np.stack([cx, cy], axis=-1).reshape(fh * fw, 1, 2)
        a = whs.shape[0]
        anchors = np.concatenate(
            [np.broadcast_to(centers, (fh * fw, a, 2)), np.broadcast_to(whs, (fh * fw, a, 2))],
            axis=-1,
        ).reshape(-1, 4)
        all_anchors.append(anchors)

    out = np.concatenate(all_anchors, axis=0).astype(np.float32)
    if cfg.clip:
        out = np.clip(out, 0.0, 1.0)
    return out
