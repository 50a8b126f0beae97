"""Detection post-processing: decode -> per-class threshold -> NMS -> dense rows.

Counterpart of :mod:`ssds_tpu.ops.postprocess` (reference
``lib/layers/functions/detection.py``, ``class Detect``): decode loc
offsets against the priors; for every class but the background, keep
scores above ``score_threshold``, take the ``top_k`` best as NMS
candidates, run greedy NMS, and emit the best ``max_detections`` survivors
as a dense ``[B, C, max_detections, 5]`` tensor of
``(score, x1, y1, x2, y2)`` rows (zeros in unused slots and the background
row).

All (image x class) slots of a batch go through ONE batched NMS call:
:func:`ssds_tpu_torch.ops.cuda.nms.nms_mask`, which is the CUDA kernel for
CUDA tensors and the plain version for CPU tensors (under ``torch.export``
the same through the registered op ``ssds_tpu_torch::nms_mask``). The
class-agnostic prune runs at a concrete batch of 4 or more only: a batch
that ``torch.export`` leaves symbolic takes no prune (:func:`_static_ge`).
Every selection sorts with ``stable=True`` and slices, so equal scores rank
index-ascending as ``lax.top_k`` ranks them (``torch.topk`` promises no tie
order on CUDA).
"""

from __future__ import annotations

import dataclasses

import torch

from ssds_tpu_torch.ops.boxes import decode
from ssds_tpu_torch.ops.cuda.nms import nms_mask
from ssds_tpu_torch.ops.nms import NEG_INF


@dataclasses.dataclass(frozen=True)
class PostProcessConfig:
    """Mirror of the reference's ``cfg.POST_PROCESS`` subtree."""

    num_classes: int = 21
    background_label: int = 0
    score_threshold: float = 0.01
    iou_threshold: float = 0.6
    max_detections: int = 100
    # NMS candidate pool per class (wider than the output, so suppressed
    # high-rank boxes do not starve lower-ranked detections).
    top_k: int = 200
    variance: tuple = (0.1, 0.2)
    # Class-agnostic pre-prune at a concrete batch >= 4: keep only the
    # pre_nms_top_n priors with the highest max-over-foreground score before
    # the per-class selection (0 = off, exact reference semantics).
    pre_nms_top_n: int = 0

    @classmethod
    def from_cfg(cls, post) -> "PostProcessConfig":
        """From a ``cfg.POST_PROCESS`` subtree."""
        return cls(
            num_classes=int(post.NUM_CLASSES),
            background_label=int(post.BACKGROUND_LABEL),
            score_threshold=float(post.SCORE_THRESHOLD),
            iou_threshold=float(post.IOU_THRESHOLD),
            max_detections=int(post.MAX_DETECTIONS),
            top_k=int(post.TOP_K),
            variance=tuple(post.VARIANCE),
            pre_nms_top_n=int(post.get("PRE_NMS_TOP_N", 0)),
        )


def _static_ge(dim, n: int) -> bool:
    """``dim >= n`` for a concrete size; False for a symbolic one (a batch
    left dynamic by ``torch.export``), where a comparison would install a
    guard that specialises the program to one side. The JAX package's rule
    (``ssds_tpu/ops/postprocess.py::_static_ge``): an artifact must serve any
    batch size, so a symbolic batch takes the formulation that is right at
    every size, here the unpruned one."""
    return isinstance(dim, int) and dim >= n


def _nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The keep mask: the registered op ``ssds_tpu_torch::nms_mask`` while
    ``torch.export`` traces (it cannot trace the wrapper's pointer reads and
    ``ctypes`` launch), the wrapper :func:`nms_mask` itself otherwise (the
    op's dispatch would add host time to every eager call). Both launch
    ``csrc/nms.cu`` on CUDA tensors and take the plain version on CPU ones."""
    if torch.compiler.is_exporting():
        return torch.ops.ssds_tpu_torch.nms_mask(boxes, scores, float(iou_threshold))
    return nms_mask(boxes, scores, iou_threshold)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values and indices, ties index-ascending."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[b, idx[b, m]]``: ``[B, N, D], [B, M] -> [B, M, D]``."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _detect_batched(boxes_per_class: torch.Tensor, scores: torch.Tensor,
                    config: PostProcessConfig) -> torch.Tensor:
    """Shared tail: per-class top-k, batched NMS, compact, zero background.

    boxes_per_class: ``[B, C, K, 4]`` (or ``[B, 1, K, 4]`` shared by all
    classes) decoded boxes; scores: ``[B, C, K]`` float32.
    """
    b, c, k = scores.shape
    dev = scores.device
    bg = (torch.arange(c, device=dev) == config.background_label)[None, :, None]
    masked = torch.where(scores > config.score_threshold, scores, NEG_INF)
    masked = masked.masked_fill(bg, NEG_INF)  # background: all-invalid slots

    if 0 < config.pre_nms_top_n < k and boxes_per_class.shape[1] == 1 and _static_ge(b, 4):
        best = torch.amax(masked, dim=1)  # [B, K]
        _, pool_idx = _top_k(best, config.pre_nms_top_n)  # [B, N]
        masked = torch.gather(masked, 2, pool_idx[:, None, :].expand(-1, c, -1))
        boxes_per_class = _gather_rows(boxes_per_class[:, 0], pool_idx)[:, None]
        k = config.pre_nms_top_n

    top_k = min(max(config.top_k, config.max_detections), k)
    cand_scores, cand_idx = _top_k(masked, top_k)  # [B, C, top_k]
    if boxes_per_class.shape[1] == 1:
        cand_boxes = _gather_rows(boxes_per_class[:, 0], cand_idx.reshape(b, -1))
    else:
        cand_boxes = torch.gather(boxes_per_class, 2,
                                  cand_idx[..., None].expand(-1, -1, -1, 4))
    cand_boxes = cand_boxes.reshape(b * c, top_k, 4)

    keep = _nms(cand_boxes, cand_scores.reshape(b * c, top_k).contiguous(),
                config.iou_threshold).reshape(b, c, top_k)

    # Candidates are score-descending, so the out_k best KEPT scores (stable
    # ties) are exactly the first out_k survivors, in order.
    out_k = min(config.max_detections, top_k)
    final_s, final_i = _top_k(torch.where(keep, cand_scores, NEG_INF), out_k)
    final_b = _gather_rows(cand_boxes, final_i.reshape(b * c, out_k)).reshape(b, c, out_k, 4)
    rows = torch.cat([final_s[..., None], final_b], dim=-1)
    rows = torch.where((final_s > NEG_INF / 2)[..., None], rows, 0.0)
    out = rows.masked_fill(bg[..., None], 0.0)
    if out_k < config.max_detections:
        out = torch.nn.functional.pad(out, (0, 0, 0, config.max_detections - out_k))
    return out


def detect(loc: torch.Tensor, conf: torch.Tensor, priors: torch.Tensor,
           config: PostProcessConfig = PostProcessConfig()) -> torch.Tensor:
    """Full Detect forward.

    Args:
      loc: ``[B, K, 4]`` predicted offsets.
      conf: ``[B, K, C]`` class probabilities (post-softmax).
      priors: ``[K, 4]`` center-form anchors.

    Returns:
      ``[B, C, max_detections, 5]`` float32 rows ``(score, x1, y1, x2, y2)``.
    """
    decoded = decode(loc.float(), priors, config.variance)  # [B, K, 4]
    scores = conf.float().transpose(1, 2)  # [B, C, K]
    return _detect_batched(decoded[:, None], scores, config)


def detect_decoded(boxes: torch.Tensor, conf: torch.Tensor,
                   config: PostProcessConfig = PostProcessConfig()) -> torch.Tensor:
    """Detect over already-decoded corner-form boxes ``[B, K, 4]`` (the YOLO
    eval path); same contract as :func:`detect`."""
    scores = conf.float().transpose(1, 2)
    return _detect_batched(boxes.float()[:, None], scores, config)
