"""3x3 stem conv on the tensor cores: the CUDA kernel and its wrappers.

Replaces the TPU kernels ``tools/pallas_conv_bench.py::_conv_rows_kernel``
(:func:`conv3x3_rows`, the counterpart of ``pallas_conv``) and the dot
probes ``tools/pallas_conv_bisect.py::k_dot`` / ``k_dot3d`` (:func:`vconv3`).
Both wrappers launch one kernel, ``ssds_tpu_torch/csrc/conv3x3.cu``: an
implicit GEMM over NHWC bf16 with ``nvcuda::wmma`` fragments and float32
accumulation, which zero-pads H and W itself (no padded copy of the input).
A block stages a 64-output-channel slice of the weights in shared memory and
walks ``tile_rows`` x ``32 * col_groups`` output tiles, double-buffering each
tile's halo with ``cp.async`` (details in the source).

Weights stay in the JAX tool's HWIO layout: ``w.reshape(9 * Cin, Cout)`` is
the kernel's K x N matrix as it is, and for :func:`vconv3` the dy-stacked
``wd0 [3 * C, Cout]`` is already the 3x1 kernel's (row ``dy * C + ci``).

Each wrapper takes its plain version (:mod:`ssds_tpu_torch.ops.conv`) for
tensors on the CPU, and only then. For CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ssds_tpu_torch.ops.conv import conv3x3_rows_torch, vconv3_torch

# (tile_rows, col_groups): a block computes tile_rows x 32*col_groups output
# pixels with one warp per 32-pixel row segment. The first is the default.
TILES: Tuple[Tuple[int, int], ...] = ((8, 1), (6, 1), (4, 2), (4, 1))
MAX_SMEM = 232448  # bytes of dynamic shared memory a block can have on Hopper
MAX_WARPS = 16
_LDW, _CHAN_PAD = 72, 16  # csrc/conv3x3.cu kLdW, kChanPad


def smem_bytes(cin: int, kw: int, tile: Tuple[int, int]) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in csrc/conv3x3.cu)."""
    rows, groups = tile
    weights = 3 * kw * cin * _LDW
    halo = (rows + 2) * (32 * groups + kw - 1) * (cin + _CHAN_PAD)
    return (weights + 2 * halo) * 2 + rows * groups * 256 * 4


def _launch(x: torch.Tensor, w: torch.Tensor, kw: int, pad_h: int, tile, name: str):
    """Checks, then one launch of the core; ``w`` is ``[3 * kw * Cin, Cout]``."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, weights on {w.device}; need both on the "
                         "CPU or both on one CUDA device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16, got {x.dtype} / {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and the weights must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and the weights must be 16-byte aligned")
    b, hin, win, cin = x.shape
    cout = w.shape[1]
    if cin % 16 or cout % 8:
        raise ValueError(f"{name}: Cin={cin}, Cout={cout}; the kernel takes Cin % 16 == 0 "
                         "(16-deep fragments) and Cout % 8 == 0 (16-byte stores)")
    rows, groups = tile
    if rows < 1 or groups < 1 or rows * groups > MAX_WARPS:
        raise ValueError(f"{name}: tile {tile}; need tile_rows * col_groups <= {MAX_WARPS} warps")
    smem = smem_bytes(cin, kw, tile)
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: Cin={cin} with tile {tile} needs {smem} bytes of shared "
                         f"memory, more than a block's {MAX_SMEM}")
    out = torch.empty((b, hin + 2 * pad_h - 2, win, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out

    from ssds_tpu_torch.ops.cuda import _build

    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssds_conv_rows(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, hin, win, cin,
                                 cout, kw, pad_h, rows, groups, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {err})")
    return out


def conv3x3_rows(x: torch.Tensor, w: torch.Tensor, tile: Tuple[int, int] = TILES[0]
                 ) -> torch.Tensor:
    """3x3 SAME conv, stride 1, no bias (``pallas_conv``).

    Args:
      x: ``[B, H, W, Cin]`` bf16 NHWC.
      w: ``[3, 3, Cin, Cout]`` bf16 HWIO.
      tile: ``(tile_rows, col_groups)``, the kernel's output tile (see :data:`TILES`).

    Returns:
      ``[B, H, W, Cout]`` bf16, equal to ``conv3x3_rows_torch(x, w)`` up to the
      order of the float32 sums (within one bf16 ulp).

    The kernel takes ``Cin % 16 == 0``, ``Cout % 8 == 0`` and a ``Cin`` whose
    weights and halo tiles fit a block's shared memory (:func:`smem_bytes`;
    ``Cin <= 64`` with the default tile), contiguous 16-byte-aligned tensors.
    """
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_rows_torch(x, w)
    if x.dim() != 4 or w.shape != (3, 3, x.shape[3], w.shape[3]):
        raise ValueError(f"conv3x3_rows: need x [B,H,W,Cin] and w [3,3,Cin,Cout], "
                         f"got {tuple(x.shape)} / {tuple(w.shape)}")
    out = _launch(x, w.reshape(9 * w.shape[2], w.shape[3]), 3, 1, tile, "conv3x3_rows")
    conv3x3_rows.launches += 1
    return out


def vconv3(xp: torch.Tensor, wd0: torch.Tensor) -> torch.Tensor:
    """The 3x1 valid conv of ``k_dot`` / ``k_dot3d``.

    Args:
      xp: ``[B, H+2, W, C]`` bf16 NHWC, already padded in H.
      wd0: ``[3*C, Cout]`` bf16, one dy-stacked slice (``dy_stack(w)[dx]``).

    Returns:
      ``[B, H, W, Cout]`` bf16, equal to ``vconv3_torch(xp, wd0)`` within one
      bf16 ulp. Takes the shapes :func:`conv3x3_rows` takes, with its default tile.
    """
    if xp.device.type == "cpu" and wd0.device.type == "cpu":
        return vconv3_torch(xp, wd0)
    if xp.dim() != 4 or wd0.dim() != 2 or wd0.shape[0] != 3 * xp.shape[3] or xp.shape[1] < 3:
        raise ValueError(f"vconv3: need xp [B,H+2,W,C] and wd0 [3*C,Cout], "
                         f"got {tuple(xp.shape)} / {tuple(wd0.shape)}")
    out = _launch(xp, wd0, 1, 0, TILES[0], "vconv3")
    vconv3.launches += 1
    return out


conv3x3_rows.launches = 0
vconv3.launches = 0
