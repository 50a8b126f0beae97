"""Shifted bf16 row/column sums: the plain version of the CUDA stencil kernel.

The conv prototype's probe ladder (``tools/pallas_conv_bisect.py``,
``pallas_conv_bisect2.py``, ``pallas_conv_bisect3.py`` and
``pallas_elem_halo_probe.py``) isolates the pieces of the 3x3 conv kernel:
the halo row window, the zero W pad, the dy-stack and the shifted sums. What
each probe computes is one row window read at a few (row, column) offsets and
summed. :func:`row_stencil_torch` is that function, and :data:`PROBES` maps
every non-dot probe to its offsets. (The two dot probes, ``k_dot`` and
``k_dot3d``, are :func:`ssds_tpu_torch.ops.conv.vconv3_torch`.)

Every sum is bf16 and rounded after each add, left to right, as JAX adds
bf16 arrays one operation at a time; the CUDA kernel
(:mod:`ssds_tpu_torch.ops.cuda.stencil`) does the same adds in the same
order, so the two are compared bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

WMODES = ("valid", "zero", "wrap")

# The tools' sizes (module globals TH, W, C, B of the probe files).
TOOL_TH, TOOL_W, TOOL_C, TOOL_B = 30, 300, 64, 4


def row_stencil_torch(x: torch.Tensor, terms: Sequence[Tuple[int, int]], out_rows: int,
                      out_cols: int, wmode: str = "valid") -> torch.Tensor:
    """``out[b, r, w] = sum over terms (dr, dw), in order, of x[b, r + dr, w + dw]``.

    Args:
      x: ``[B, H, W, C]``.
      terms: ``(dr, dw)`` offsets, ``dr >= 0``; the first term is copied, each
        later one added with one rounding to ``x.dtype``.
      out_rows, out_cols: the output's H and W; ``out_rows + dr <= H``.
      wmode: columns ``w + dw`` outside ``[0, W)`` are refused (``valid``),
        read as +0.0 (``zero``, a zero pad) or wrapped modulo W (``wrap``, a
        roll).

    Returns:
      ``[B, out_rows, out_cols, C]``, contiguous.
    """
    check_stencil(x.shape, terms, out_rows, out_cols, wmode)
    width = x.shape[2]
    acc = None
    for dr, dw in terms:
        rows = x[:, dr:dr + out_rows]
        if wmode == "wrap":
            term = torch.roll(rows, -dw, dims=2)[:, :, :out_cols]
        elif wmode == "zero":
            lo, hi = max(0, -dw), max(0, out_cols + dw - width)
            padded = F.pad(rows, (0, 0, lo, hi))  # +0.0 outside [0, W)
            term = padded[:, :, lo + dw:lo + dw + out_cols]
        else:
            term = rows[:, :, dw:dw + out_cols]
        acc = term.clone(memory_format=torch.contiguous_format) if acc is None else acc + term
    return acc


def check_stencil(shape, terms, out_rows: int, out_cols: int, wmode: str) -> None:
    """Raise ValueError unless ``terms`` read only rows of ``x`` (and columns, for ``valid``)."""
    if len(shape) != 4:
        raise ValueError(f"row_stencil: need x [B, H, W, C], got {tuple(shape)}")
    if wmode not in WMODES:
        raise ValueError(f"row_stencil: wmode {wmode!r} is not one of {WMODES}")
    if not terms:
        raise ValueError("row_stencil: need at least one term")
    _, height, width, _ = shape
    drs = [dr for dr, _ in terms]
    dws = [dw for _, dw in terms]
    if out_rows < 0 or min(drs) < 0 or out_rows + max(drs) > height:
        raise ValueError(f"row_stencil: rows r + dr for r < {out_rows}, dr in {drs} "
                         f"leave [0, {height})")
    bad_cols = (out_cols > width if wmode == "wrap" else
                out_cols < 0 or (wmode == "valid" and (min(dws) < 0 or out_cols + max(dws) > width)))
    if bad_cols:
        raise ValueError(f"row_stencil: {out_cols} output columns with dw in {dws} do not fit "
                         f"{width} input columns in mode {wmode!r}")


@dataclass(frozen=True)
class Probe:
    """One Pallas probe kernel as a stencil."""

    source: str                        # the Pallas kernel, file:line
    shape: Tuple[int, int, int, int]   # input [B, H, W, C] at the tool's sizes
    terms: Tuple[Tuple[int, int], ...]
    out_rows: int
    wmode: str = "valid"

    @property
    def out_cols(self) -> int:
        """Every input column in the zero and wrap modes; the valid ones otherwise."""
        width = self.shape[2]
        return width if self.wmode != "valid" else width - max(dw for _, dw in self.terms)


_COPY = ((0, 0),)
_ROWS3 = ((0, 0), (1, 0), (2, 0))       # x[r] + x[r+1] + x[r+2]
_GRID = (TOOL_B, 302, TOOL_W, TOOL_C)   # the DMA / grid probes' input: H-padded stem rows
_BLOCK = (1, TOOL_TH + 2, TOOL_W, TOOL_C)  # bisect2's one VMEM block (no leading dim there)

PROBES: Dict[str, Probe] = {
    # tools/pallas_conv_bisect.py: DMA of the (TH+2)-row halo, then one row tile
    "copy": Probe("tools/pallas_conv_bisect.py:45", _GRID, _COPY, 300),
    "pad": Probe("tools/pallas_conv_bisect.py:50", _GRID, _COPY, 300),
    "cat": Probe("tools/pallas_conv_bisect.py:56", _GRID, _ROWS3, 300),
    "reshape": Probe("tools/pallas_conv_bisect.py:63", _GRID, _ROWS3, 300),
    # tools/pallas_conv_bisect2.py: one block, no grid, no DMA
    "pad_w": Probe("tools/pallas_conv_bisect2.py:31", _BLOCK, _COPY, TOOL_TH + 2),
    "pad_h": Probe("tools/pallas_conv_bisect2.py:36", _BLOCK, _COPY, TOOL_TH + 2),
    "cat_lane": Probe("tools/pallas_conv_bisect2.py:41", _BLOCK, _ROWS3, TOOL_TH),
    "cat_lane_same": Probe("tools/pallas_conv_bisect2.py:46", _BLOCK, ((0, 0),) * 3, TOOL_TH),
    "add_shifted": Probe("tools/pallas_conv_bisect2.py:52", _BLOCK, _ROWS3, TOOL_TH),
    "w_shift_slice": Probe("tools/pallas_conv_bisect2.py:57", (1, TOOL_TH + 2, TOOL_W + 2, TOOL_C),
                           ((0, 0), (0, 1), (0, 2)), TOOL_TH),
    "roll_w": Probe("tools/pallas_conv_bisect2.py:62", _BLOCK, ((0, 0), (0, -1), (0, 1)),
                    TOOL_TH, "wrap"),
    # tools/pallas_conv_bisect3.py: grid (B, 10), with and without the DMA
    "pad_nodma": Probe("tools/pallas_conv_bisect3.py:45", _GRID, _COPY, 300),
    "dma_add": Probe("tools/pallas_conv_bisect3.py:50", _GRID, _ROWS3, 300),
    "dma_pad": Probe("tools/pallas_conv_bisect3.py:55", _GRID, _COPY, 300),
    "dma_pad_read": Probe("tools/pallas_conv_bisect3.py:61", _GRID, ((0, -1), (0, 1)), 300,
                          "zero"),
    "dma_cat": Probe("tools/pallas_conv_bisect3.py:68", _GRID, _ROWS3, 300),
    # tools/pallas_elem_halo_probe.py: overlapping all-Element row windows
    "elem_halo": Probe("tools/pallas_elem_halo_probe.py:35", _GRID, _ROWS3, 300),
}

# The two dot probes run the conv kernel's 3x1 form (ops.conv.vconv3_torch).
DOT_PROBES: Dict[str, str] = {
    "dot": "tools/pallas_conv_bisect.py:71",
    "dot3d": "tools/pallas_conv_bisect.py:80",
}
