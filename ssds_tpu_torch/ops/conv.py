"""3x3 stem conv in plain PyTorch: the plain versions of the CUDA conv kernel.

Counterpart of the JAX package's conv prototype, ``tools/pallas_conv_bench.py``
(``pallas_conv`` / ``xla_conv``) and the dot probes of
``tools/pallas_conv_bisect.py`` (``k_dot``, ``k_dot3d``). Layouts are the JAX
tool's: activations NHWC, weights HWIO.

These functions are the CPU path of :mod:`ssds_tpu_torch.ops.cuda.conv` and
the reference its kernel is held against on the card. Each takes bf16 in,
sums the products in float32 (TF32 off) and rounds once to the input dtype,
as the Pallas kernels accumulate in f32 and cast at the end.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# Two versions of these convs sum the same float32 products in different
# orders and round once to bf16, so they agree within one bf16 ulp: a
# relative 2^-7 (bf16 keeps 8 significant bits), and 1e-4 absolute for sums
# that cancel to near zero.
RTOL, ATOL = 2.0 ** -7, 1e-4


@contextlib.contextmanager
def _full_f32():
    """cuDNN's float32 convolutions in full float32 (its TF32 default off)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def dy_stack(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, Cin, Cout]`` -> per-dx dy-stacked ``[3, 3*Cin, Cout]``.

    Row ``dy*Cin + ci`` of slice ``dx`` is ``w[dy, dx, ci]``: the weight layout
    of ``pallas_conv`` (``tools/pallas_conv_bench.py:76``). Slice ``dx`` is the
    ``wd0`` that :func:`vconv3_torch` takes for that column of taps.
    """
    kh, kw, cin, cout = w.shape
    return w.permute(1, 0, 2, 3).reshape(kw, kh * cin, cout)


def conv3x3_rows_torch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, stride 1, no bias.

    Args:
      x: ``[B, H, W, Cin]`` NHWC (bf16 in the tool).
      w: ``[3, 3, Cin, Cout]`` HWIO.

    Returns:
      ``[B, H, W, Cout]`` NHWC in ``x.dtype``: float32 products and sums,
      rounded once.
    """
    if x.dim() != 4 or w.shape != (3, 3, x.shape[3], w.shape[3]):
        raise ValueError(f"conv3x3_rows_torch: need x [B,H,W,Cin] and w [3,3,Cin,Cout], "
                         f"got {tuple(x.shape)} / {tuple(w.shape)}")
    with _full_f32():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def vconv3_torch(xp: torch.Tensor, wd0: torch.Tensor) -> torch.Tensor:
    """The 3x1 valid conv of ``k_dot`` / ``k_dot3d``.

    ``out[b, r, x] = sum_dy xp[b, r + dy, x] @ wd0[dy*C:(dy+1)*C]``.

    Args:
      xp: ``[B, H+2, W, C]`` NHWC, already padded in H.
      wd0: ``[3*C, Cout]``, one dy-stacked slice (``dy_stack(w)[dx]``).

    Returns:
      ``[B, H, W, Cout]`` in ``xp.dtype``: float32 sums, rounded once.
    """
    if xp.dim() != 4 or wd0.dim() != 2 or wd0.shape[0] != 3 * xp.shape[3] or xp.shape[1] < 3:
        raise ValueError(f"vconv3_torch: need xp [B,H+2,W,C] and wd0 [3*C,Cout], "
                         f"got {tuple(xp.shape)} / {tuple(wd0.shape)}")
    c, cout = xp.shape[3], wd0.shape[1]
    weight = wd0.float().reshape(3, c, cout).permute(2, 1, 0).unsqueeze(-1)  # [Cout, C, 3, 1]
    with _full_f32():
        y = F.conv2d(xp.float().permute(0, 3, 1, 2), weight)
    return y.permute(0, 2, 3, 1).to(xp.dtype).contiguous()
