"""Batched greedy-NMS keep mask: the CUDA kernel and its wrapper.

Replaces the TPU kernel ``ssds_tpu/ops/pallas/nms.py::_nms_kernel``
(``nms_mask_pallas``). The kernel is ``ssds_tpu_torch/csrc/nms.cu``, built by
:mod:`ssds_tpu_torch.ops.cuda._build` and called through its plain C entry
point. What bounds it on the card is not bytes but the latency of the
N-step dependent propagation loop; the kernel computes the suppression bits
with all its warps, then walks the N steps in one warp with the bit words
in registers (details in the source). One thread block per (image x class)
slot, so the M slots of a batch run in parallel.

:func:`nms_mask` takes the plain version
(:func:`ssds_tpu_torch.ops.nms.nms_mask_torch`) for a tensor on the CPU,
and only then. For a CUDA tensor it launches the kernel or raises: there
is no fallback.
"""

from __future__ import annotations

import torch

from ssds_tpu_torch.ops.nms import nms_mask_torch

MAX_N = 512  # candidates per slot: N x ceil(N/32) suppression words in 32 KB


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Batched greedy-NMS keep mask.

    Args:
      boxes: ``[M, N, 4]`` float32 corner-form candidates, score-descending per row.
      scores: ``[M, N]`` float32; ``<= -5e29`` marks an invalid entry.
      iou_threshold: suppress a later candidate whose IoU is ``> iou_threshold``.

    Returns:
      ``[M, N]`` bool keep mask, equal to ``nms_mask_torch(boxes, scores, thr)``.
    """
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return nms_mask_torch(boxes, scores, iou_threshold)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"nms_mask: boxes on {boxes.device}, scores on {scores.device}; "
                         "need both on the CPU or both on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_mask: need float32, got {boxes.dtype} / {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_mask: need boxes [M, N, 4] and scores [M, N], "
                         f"got {tuple(boxes.shape)} / {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_mask: boxes and scores must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_mask: boxes must be 16-byte aligned (read as float4)")
    m, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"nms_mask: N={n} candidates per slot, the kernel takes <= {MAX_N}")
    keep = torch.empty((m, n), dtype=torch.uint8, device=boxes.device)
    if m == 0 or n == 0:
        return keep.view(torch.bool)

    from ssds_tpu_torch.ops.cuda import _build

    lib = _build.load()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssds_nms_mask(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                                m, n, float(iou_threshold), stream)
    if err:
        raise RuntimeError(f"nms_mask: CUDA kernel launch failed (cudaError {err})")
    nms_mask.launches += 1
    return keep.view(torch.bool)


nms_mask.launches = 0
