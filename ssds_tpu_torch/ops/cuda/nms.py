"""Batched greedy-NMS keep mask: the CUDA kernel and its wrapper.

Replaces the TPU kernel ``ssds_tpu/ops/pallas/nms.py::_nms_kernel``
(``nms_mask_pallas``). The kernel is ``ssds_tpu_torch/csrc/nms.cu``, built by
:mod:`ssds_tpu_torch.ops.cuda._build` and called through its plain C entry
point. Its work is tiny, so latency and issue rate bound it: the launch, the
N-step greedy chain and the IoU tests' instructions. A launch plan chosen
from (M, N) sizes shared memory by N and fills the SMs (several slots a
block at large M, a block of 16 warps a slot at small M); phase 1 builds only the
upper-triangle suppression words, 32 IoU tests a thread; phase 2 walks the
chain 32 candidates a word in registers (details in the source).

This module mirrors the kernel's host and index arithmetic in Python —
:func:`slot_layout`, :func:`launch_plan`, :func:`block_tiles` — and emulates
its algorithm in plain PyTorch (:func:`suppression_words`,
:func:`nms_mask_emulated`), so that the CPU tests can pin what this machine
cannot run.

:func:`nms_mask` takes the plain version
(:func:`ssds_tpu_torch.ops.nms.nms_mask_torch`) for a tensor on the CPU,
and only then. For a CUDA tensor it launches the kernel or raises: there
is no fallback. :func:`nms_mask_op` registers the same as the operator
``torch.ops.ssds_tpu_torch.nms_mask``, which ``torch.export`` captures and
an exported program calls (``ssds_tpu_torch/export.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ssds_tpu_torch.ops.nms import NEG_INF, nms_mask_torch

MAX_N = 512           # candidates a slot
THREADS = 512         # 16 warps a block
BLOCKS_PER_SM = 2     # the kernel's launch bounds: <= 64 registers a thread
MAX_SLOTS = THREADS // 32  # slots a block: a phase-2 warp each
CLUSTER = 2           # blocks a slot at small M
MAX_SMEM = 232448     # bytes of dynamic shared memory a block can have on Hopper
SM_SMEM = 233472      # bytes of shared memory of an SM
BLOCK_RESERVE = 1024  # the runtime's shared bytes a block
HEADER_BYTES = 128    # each slot's n_eff, before the slots
H100_SMS = 132

_MASK32 = 0xFFFFFFFF
_POISON = _MASK32     # what the emulation holds where the kernel writes nothing


class Layout(NamedTuple):
    """One slot's shared memory (``layout`` in csrc/nms.cu)."""

    words: int   # ceil(n / 32)
    rows: int    # 32 * words: boxes and areas padded to whole words
    stride: int  # rows + 1: word c of row i at c * stride + i (odd: 32 lanes on 32 banks)
    bytes: int   # boxes, areas, valid words, suppression words; to 16 bytes


class Plan(NamedTuple):
    """The kernel's launch (``plan`` in csrc/nms.cu)."""

    slots: int    # slots a block
    threads: int  # threads a block
    blocks: int
    smem: int     # dynamic shared bytes a block
    cluster: int  # blocks a slot (a thread block cluster), 1 where slots share a block


def slot_layout(n: int) -> Layout:
    words = -(-n // 32)
    rows = 32 * words
    floats = 4 * rows + rows + words + words * (rows + 1)
    return Layout(words, rows, rows + 1, -(-floats * 4 // 16) * 16)


def launch_plan(m: int, n: int, sms: int = H100_SMS) -> Plan:
    """Small M: a cluster of :data:`CLUSTER` blocks a slot, where that keeps
    the grid within two blocks an SM. Otherwise slots a block: enough that
    two blocks an SM take every slot in one wave, or, where two such blocks
    do not fit an SM's shared memory, enough for one block an SM; at most
    what fits a block and :data:`MAX_SLOTS`."""
    lay = slot_layout(n)
    cap = min((MAX_SMEM - HEADER_BYTES) // lay.bytes, MAX_SLOTS)
    cluster = CLUSTER if m * CLUSTER <= BLOCKS_PER_SM * sms else 1
    slots = 1 if cluster > 1 else max(1, min(-(-m // (BLOCKS_PER_SM * sms)), cap))
    if BLOCKS_PER_SM * (HEADER_BYTES + slots * lay.bytes + BLOCK_RESERVE) > SM_SMEM:
        slots = max(1, min(-(-m // sms), cap))
    return Plan(slots, THREADS, -(-m // slots) * cluster, HEADER_BYTES + slots * lay.bytes,
                cluster)


def block_slots(m: int, plan: Plan, block: int) -> range:
    """The slots block ``block`` takes (the last block may hold fewer; the
    blocks of a cluster share one)."""
    first = block // plan.cluster * plan.slots
    return range(first, min(m, first + plan.slots))


def block_tiles(n_effs: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Phase 1's tiles of one block (or cluster) in order (``tile_at``):
    ``(slot, r, c)``, row block ``r`` and word ``c >= r`` below each slot's
    ``n_eff``; :func:`tile_owner` says which warp takes each."""
    out = []
    for s, neff in enumerate(n_effs):
        we = -(-neff // 32)
        out += [(s, r, c) for r in range(we) for c in range(r, we)]
    return out


def tile_owner(k: int, plan: Plan) -> Tuple[int, int]:
    """(block rank in the cluster, warp) that tests tile ``k``."""
    warps = plan.threads // 32
    return k // warps % plan.cluster, k % warps


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """``[..., 32 * W]`` bool -> ``[..., W]`` int64 words, bit t = element 32w + t."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64) << shifts).sum(-1)


def suppression_words(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float):
    """Phase 1 as the kernel computes it, in its layout.

    Returns ``(sup, valid, n_eff)``: ``sup [M, words, rows]`` int64, word ``c``
    of row ``i`` at ``[c, i]`` (bit ``t``: ``IoU(i, 32c + t) > thr`` and
    ``32c + t > i``) where the kernel writes it, that is for rows below
    ``n_eff`` and words ``i // 32 <= c < ceil(n_eff / 32)``; every other word,
    padding rows included, holds :data:`_POISON`, so a read that mattered would
    show. ``valid [M, words]`` are the ballots of the scores and ``n_eff [M]``
    one past each slot's last valid candidate.
    """
    m, n = scores.shape
    lay = slot_layout(n)
    pad = lay.rows - n
    valid_bits = scores > NEG_INF / 2
    idx = torch.arange(n, device=boxes.device)
    n_eff = torch.where(valid_bits, idx + 1, 0).amax(1)

    # the kernel's operations, in its order: area at load, then per pair
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0) * \
        torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    bi, bj = boxes[:, :, None, :], boxes[:, None, :, :]
    iw = torch.clamp(torch.minimum(bi[..., 2], bj[..., 2]) - torch.maximum(bi[..., 0], bj[..., 0]),
                     min=0.0)
    ih = torch.clamp(torch.minimum(bi[..., 3], bj[..., 3]) - torch.maximum(bi[..., 1], bj[..., 1]),
                     min=0.0)
    inter = iw * ih
    uni = (area[:, :, None] + area[:, None, :]) - inter
    pos = (inter > 0.0) & (uni > 0.0)  # elsewhere the kernel divides 1 by 1
    one = torch.ones_like(uni)
    iou = torch.where(pos, torch.where(pos, inter, one) / torch.where(pos, uni, one),
                      torch.zeros_like(inter))
    live = idx[None, :] < n_eff[:, None]
    hit = (iou > iou_threshold) & (idx[None, None, :] > idx[None, :, None])
    hit &= live[:, :, None] & live[:, None, :]
    words = _pack(F.pad(hit, (0, pad))).transpose(1, 2)  # [M, words, N]

    row_block = (idx // 32)[None, None, :]
    word = torch.arange(lay.words, device=boxes.device)[None, :, None]
    we = (-(-n_eff // 32))[:, None, None]
    written = live[:, None, :] & (word >= row_block) & (word < we)
    sup = torch.full((m, lay.words, lay.rows), _POISON, dtype=torch.int64, device=boxes.device)
    sup[..., :n] = torch.where(written, words, _POISON)
    valid = _pack(F.pad(valid_bits, (0, pad)))
    return sup, valid, n_eff


def nms_mask_emulated(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: :func:`suppression_words`,
    then phase 2 a word at a time — the 32 x 32 diagonal block loaded whole
    and resolved bit by bit, the kept rows' later words ORed into the
    "removed" words — then the keep bits. Equal to :func:`nms_mask_torch`;
    the CPU tests hold it against the JAX package's Pallas kernel."""
    m, n = scores.shape
    lay = slot_layout(n)
    sup, valid, n_eff = suppression_words(boxes, scores, iou_threshold)
    we = -(-n_eff // 32)
    lanes = torch.arange(lay.words, device=boxes.device)
    bit = torch.arange(32, dtype=torch.int64, device=boxes.device)
    removed = torch.zeros((m, lay.words), dtype=torch.int64, device=boxes.device)
    kept_words = torch.zeros_like(removed)
    for w in range(lay.words):
        row0 = 32 * w
        d = sup[:, w, row0:row0 + 32]                  # unguarded, as the kernel loads it
        kept = valid[:, w] & ~removed[:, w] & _MASK32  # live
        for t in range(32):
            on = ((kept >> t) & 1).bool()
            kept = torch.where(on, kept & ~d[:, t] & _MASK32, kept)
        kept_words[:, w] = kept
        later = (lanes > w)[None, :] & (lanes[None, :] < we[:, None])  # [M, words]
        rows_kept = ((kept[:, None] >> bit) & 1).bool()               # [M, 32]
        own = sup[:, :, row0:row0 + 32]                               # [M, words, 32]
        loads = torch.where(later[:, :, None] & rows_kept[:, None, :], own, 0)
        acc = torch.zeros_like(removed)
        for t in range(32):
            acc |= loads[:, :, t]
        removed |= acc
    bits = (kept_words[:, :, None] >> bit) & 1
    return bits.reshape(m, -1)[:, :n].bool()


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Batched greedy-NMS keep mask.

    Args:
      boxes: ``[M, N, 4]`` float32 corner-form candidates, score-descending per row.
      scores: ``[M, N]`` float32; ``<= -5e29`` marks an invalid entry.
      iou_threshold: suppress a later candidate whose IoU is ``> iou_threshold``.

    Returns:
      ``[M, N]`` bool keep mask, equal to ``nms_mask_torch(boxes, scores, thr)``.
    """
    if not (boxes.is_cuda and scores.is_cuda):
        if boxes.device.type == "cpu" and scores.device.type == "cpu":
            return nms_mask_torch(boxes, scores, iou_threshold)
        raise ValueError(f"nms_mask: boxes on {boxes.device}, scores on {scores.device}; "
                         "need both on the CPU or both on one CUDA device")
    device = boxes.get_device()
    if scores.get_device() != device:
        raise ValueError(f"nms_mask: boxes on {boxes.device}, scores on {scores.device}; "
                         "need both on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_mask: need float32, got {boxes.dtype} / {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_mask: need boxes [M, N, 4] and scores [M, N], "
                         f"got {tuple(boxes.shape)} / {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("nms_mask: boxes and scores must be contiguous")
    ptr = boxes.data_ptr()
    if ptr % 16:
        raise ValueError("nms_mask: boxes must be 16-byte aligned (read as float4)")
    m, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"nms_mask: N={n} candidates per slot, the kernel takes <= {MAX_N}")
    keep = boxes.new_empty((m, n), dtype=torch.bool)  # the kernel writes bytes 0 / 1
    if m == 0 or n == 0:
        return keep

    from ssds_tpu_torch.ops.cuda import _build

    lib = _build.load()
    # current_stream(device).cuda_stream without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(device)
    args = (ptr, scores.data_ptr(), keep.data_ptr(), m, n, float(iou_threshold), stream)
    if device == torch.cuda.current_device():
        err = lib.ssds_nms_mask(*args)
    else:
        with torch.cuda.device(device):
            err = lib.ssds_nms_mask(*args)
    if err:
        raise RuntimeError(f"nms_mask: CUDA kernel launch failed (cudaError {err})")
    nms_mask.launches += 1
    return keep


nms_mask.launches = 0


# The kernel as an operator that ``torch.export`` can capture: the wrapper
# reads data pointers and launches through ctypes, which a trace cannot
# follow, so an exported program calls ``ssds_tpu_torch::nms_mask`` instead.
# Its CUDA implementation is the wrapper above (the kernel, counted in
# ``nms_mask.launches``, or an error: no fallback), its CPU implementation
# the plain version, and its fake implementation gives the mask's shape and
# dtype without running either. Importing this module registers it, which
# is all a process that loads an exported program needs of the port.
@torch.library.custom_op("ssds_tpu_torch::nms_mask", mutates_args=(), device_types="cuda")
def nms_mask_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``torch.ops.ssds_tpu_torch.nms_mask``: :func:`nms_mask` as an operator."""
    return nms_mask(boxes, scores, iou_threshold)


@nms_mask_op.register_kernel("cpu")
def _nms_mask_op_cpu(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    return nms_mask_torch(boxes, scores, iou_threshold)


@nms_mask_op.register_fake
def _nms_mask_op_fake(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    return scores.new_empty(scores.shape, dtype=torch.bool)
