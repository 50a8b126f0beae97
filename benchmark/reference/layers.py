"""Plain functional layers of the reference models, over a dict of tensors.

Every reference model is written as functions of a parameter dict in the
ssds.pytorch state-dict layout, so the same dict that the benchmark hands to
the program can be handed here. :class:`Ops` carries that dict, the
precision the reference computes in, the train/eval mode of the BatchNorms
and an optional count of the convolutions' operations.

Precisions: ``"float32"`` is the reference proper (the caller turns TF32
off, :func:`float32_exact`); ``"fp8"`` is the control of a bf16 training
configuration, a training step computed as fp8 training computes it: every
conv's input and weight are rounded to float8 e4m3 with a per-tensor scale
(amax to 448) before a float32 convolution, and in the backward the
gradient reaching each conv's output is rounded to float8 e5m2 (amax to
57344) before the convolution's input and weight gradients are taken.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # running = 0.9 running + 0.1 batch (flax's convention, the biased variance)
FP8_MAX = 448.0       # float8 e4m3
FP8_GRAD_MAX = 57344.0  # float8 e5m2


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convolutions inside, restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


class _RoundFP8(torch.autograd.Function):
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes unchanged (straight through)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-12)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradFP8(torch.autograd.Function):
    """The identity; the gradient through it is rounded to float8 e5m2
    under a per-tensor scale."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        amax = g.abs().amax().clamp_min(1e-30)
        scale = FP8_GRAD_MAX / amax
        return (g * scale).to(torch.float8_e5m2).to(g.dtype) / scale


class Ops:
    """The parameters and the arithmetic of one reference forward.

    Args:
      params: name -> tensor, the ssds.pytorch layout.
      precision: ``"float32"`` or ``"fp8"`` (see the module's docstring).
      train: BatchNorms on the batch's statistics (recorded in
        :attr:`bn_stats` for the running update) instead of the running ones.
      count: count each convolution's operations into :attr:`flops`
        (two a multiply-add), e.g. on the ``meta`` device.
    """

    def __init__(self, params: Dict[str, torch.Tensor], precision: str = "float32",
                 train: bool = False, count: bool = False):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"unknown reference precision {precision!r}")
        self.p = params
        self.precision = precision
        self.train = train
        self.flops: Optional[int] = 0 if count else None
        self.bn_stats: Dict[str, tuple] = {}

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(x) if self.precision == "fp8" else x

    def conv(self, x: torch.Tensor, name: str, stride: int = 1, padding: int = 0,
             dilation: int = 1) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        b = self.p.get(f"{name}.bias")
        y = F.conv2d(self._q(x), self._q(w), b, stride=stride, padding=padding,
                     dilation=dilation)
        if self.precision == "fp8":
            y = _RoundGradFP8.apply(y)
        if self.flops is not None:
            n, cout, ho, wo = y.shape
            self.flops += 2 * n * cout * ho * wo * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """BatchNorm, eps 1e-5: batch statistics (biased variance) in train
        mode, running ones in eval mode."""
        g, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            # a recompute gives the same values: the dict keeps one entry a layer
            self.bn_stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean[None, :, None, None]) * (inv * g)[None, :, None, None] \
            + b[None, :, None, None]

    def update_running_stats(self, buffers: Dict[str, torch.Tensor]) -> None:
        """Blend the recorded batch statistics into ``buffers`` in place."""
        with torch.no_grad():
            for name, (mean, var) in self.bn_stats.items():
                buffers[f"{name}.running_mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                buffers[f"{name}.running_var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
                buffers[f"{name}.num_batches_tracked"].add_(1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0.0)


def leaky(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x > 0, x, slope * x)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)


def upsample2(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear upsampling to ``size`` (half-pixel centres)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
