"""int8 post-training quantisation: the plain PyTorch versions of the kernels
(counterpart of the arithmetic in :mod:`ssds_tpu.quant`).

The serving path of :class:`ssds_tpu_torch.quant.QuantConv2d` is three steps,
each JAX's (``ssds_tpu/quant.py:64-87``):

1. :func:`quantize_act_torch`: ``clamp(round_half_even(x / act_scale), -127,
   127)`` in float32, a division, not a multiply by the reciprocal; the
   result NHWC int8 with the channels zero-padded to a multiple of 4 (the
   layout the CUDA kernel reads a 4-byte word at a time);
2. :func:`int8_conv_torch`: the ``s8 x s8 -> s32`` convolution, as
   ``F.conv2d`` in float64 over the int8 values, cast to int32. It is exact:
   every partial sum is an integer of magnitude at most ``127^2 * K``, far
   below 2^53;
3. :func:`dequant_torch`: ``acc.float() * (act_scale * w_scale)`` (the two
   scales multiplied first), ``+ bias``, cast to the output dtype, then the
   ReLU where the conv has one.

:func:`quantize_weight` is ``_quantize_kernel`` (``ssds_tpu/quant.py:113-117``):
per output channel, ``max|w|`` floored at 1e-12, over 127, in float32;
``rint`` and a clip to +-127. :func:`act_scale_of` is the activation scale
``np.float32(max(absmax, 1e-8) / 127.0)``, the division in float64 first.

The CUDA kernels (:mod:`ssds_tpu_torch.ops.cuda.int8_conv`,
``csrc/int8_conv.cu``) are held bit-identical to these.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

QMAX = 127
CHANNEL_ALIGN = 4  # the kernel reads 4 channels (one 4-byte word) at a time


def padded_channels(c: int) -> int:
    """``c`` rounded up to a multiple of :data:`CHANNEL_ALIGN`."""
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def act_scale_of(absmax: float) -> np.float32:
    """The per-tensor activation scale of a calibrated ``absmax``."""
    return np.float32(max(float(absmax), 1e-8) / 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an OIHW float32 kernel:
    ``(int8 OIHW, w_scale [Cout] float32)``."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
    q = torch.clamp(torch.round(w / s[:, None, None, None]), -QMAX, QMAX).to(torch.int8)
    return q, s


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the kernels' ``[Cout, KH, KW, Cin_pad]`` (channels last,
    zero-padded to :func:`padded_channels`)."""
    cin = wq.shape[1]
    out = wq.permute(0, 2, 3, 1)
    return F.pad(out, (0, padded_channels(cin) - cin)).contiguous()


def quantize_act_torch(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """NCHW float32 / bf16 -> NHWC int8 ``[B, H, W, Cin_pad]``."""
    q = torch.clamp(torch.round(x.float() / act_scale), -QMAX, QMAX).to(torch.int8)
    c = x.shape[1]
    return F.pad(q.permute(0, 2, 3, 1), (0, padded_channels(c) - c)).contiguous()


def int8_conv_torch(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                    padding: Sequence[int], dilation: Sequence[int]) -> torch.Tensor:
    """NHWC int8 ``[B, H, W, Cp]`` x ``[Cout, KH, KW, Cp]`` int8 -> NCHW int32
    accumulators, exact (float64 sums of integers). cuDNN is off for it on
    the card: its FFT algorithms would round."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                       stride=tuple(stride), padding=tuple(padding), dilation=tuple(dilation))
    return acc.to(torch.int32).contiguous()


def dequant_torch(acc: torch.Tensor, act_scale: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor], relu: bool, out_dtype: torch.dtype) -> torch.Tensor:
    """The float epilogue on NCHW int32 accumulators."""
    y = acc.float() * (act_scale * w_scale)[None, :, None, None]
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    y = y.to(out_dtype)
    return torch.relu(y) if relu else y


def int8_conv_plain(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu: bool,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version of the conv kernel: raw accumulators for
    ``out_dtype`` int32, else the dequantised output."""
    acc = int8_conv_torch(xq, wq, stride, padding, dilation)
    if out_dtype == torch.int32:
        return acc
    return dequant_torch(acc, act_scale, w_scale, bias, relu, out_dtype)


def conv_out_size(n: int, k: int, s: int, p: int, d: int) -> int:
    """A convolution's output length along one axis."""
    return (n + 2 * p - d * (k - 1) - 1) // s + 1
