"""Shifted bf16 row/column sums: the CUDA kernel and its wrapper.

Replaces the 17 non-dot probe kernels of the conv prototype's probe ladder
(``ssds_tpu_torch.ops.stencil.PROBES`` names each by file and line). The
kernel is ``ssds_tpu_torch/csrc/stencil.cu``: one thread per 8 channels
(16 bytes) of one output pixel, reading each term's row from device memory
and rounding to bf16 after every add, so it is bit-identical to
:func:`ssds_tpu_torch.ops.stencil.row_stencil_torch`. It moves bytes and
does almost no arithmetic, so device-memory bandwidth bounds it.

:func:`row_stencil` takes the plain version for a tensor on the CPU, and
only then. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ssds_tpu_torch.ops.stencil import WMODES, check_stencil, row_stencil_torch

MAX_TERMS = 8  # the kernel's fixed-size term table
MAX_VECS = 1 << 30  # outputs / 8: the kernel indexes in 32 bits


def row_stencil(x: torch.Tensor, terms: Sequence[Tuple[int, int]], out_rows: int,
                out_cols: int, wmode: str = "valid") -> torch.Tensor:
    """``out[b, r, w] = sum over terms (dr, dw), in order, of x[b, r + dr, w + dw]``.

    Same contract as :func:`ssds_tpu_torch.ops.stencil.row_stencil_torch`.
    The kernel takes ``x`` bf16 ``[B, H, W, C]``, contiguous and 16-byte
    aligned, with ``C % 8 == 0``, at most 8 terms and at most 2^33 outputs.
    """
    if x.device.type == "cpu":
        return row_stencil_torch(x, terms, out_rows, out_cols, wmode)
    if x.device.type != "cuda":
        raise ValueError(f"row_stencil: x on {x.device}; need the CPU or a CUDA device")
    terms = [(int(dr), int(dw)) for dr, dw in terms]
    check_stencil(x.shape, terms, out_rows, out_cols, wmode)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"row_stencil: the kernel takes bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_stencil: x must be contiguous")
    b, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"row_stencil: C={c}; the kernel reads 8 channels at a time (C % 8 == 0)")
    if x.data_ptr() % 16:
        raise ValueError("row_stencil: x must be 16-byte aligned")
    if len(terms) > MAX_TERMS:
        raise ValueError(f"row_stencil: {len(terms)} terms; the kernel takes <= {MAX_TERMS}")
    if b * out_rows * out_cols * c // 8 > MAX_VECS:
        raise ValueError(f"row_stencil: {b * out_rows * out_cols * c} outputs; the kernel takes "
                         f"<= {8 * MAX_VECS}")
    out = torch.empty((b, out_rows, out_cols, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out

    from ssds_tpu_torch.ops.cuda import _build

    lib = _build.load()
    drs = (ctypes.c_int * len(terms))(*(dr for dr, _ in terms))
    dws = (ctypes.c_int * len(terms))(*(dw for _, dw in terms))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssds_row_stencil(x.data_ptr(), out.data_ptr(), b, h, w, c, out_rows, out_cols,
                                   len(terms), drs, dws, WMODES.index(wmode), stream)
    if err:
        raise RuntimeError(f"row_stencil: CUDA kernel launch failed (cudaError {err})")
    row_stencil.launches += 1
    return out


row_stencil.launches = 0
