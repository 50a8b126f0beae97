"""Building blocks for backbones and heads (counterpart of :mod:`ssds_tpu.models.layers`).

NCHW inside, as PyTorch convolutions want it. Padding follows the torch
conventions of the reference models, so feature-map sizes match the JAX
package and the anchor set exactly (ceil-mode pool3: 75 -> 38).

A ``LayerSpec`` here is a callable ``spec(in_channels) -> nn.Module`` (the
JAX package's specs take no argument because flax infers input widths; torch
layers need them). :func:`build_layers` instantiates a spec list and tracks
the channel count through modules that have an ``out_channels``.

Only the plain float paths are ported; the JAX package's int8 serving and
space-to-depth stem wait (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LayerSpec = Callable[[int], nn.Module]

# flax.linen.Conv's default kernel init, lecun_normal: a normal truncated at
# +-2 std, rescaled so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class ReLU(nn.ReLU):
    """``max(x, 0)`` (the JAX package's output-keyed VJP is a TPU memory trick)."""


class MaxPool(nn.MaxPool2d):
    """2D max pool; torch ``ceil_mode`` is the reference's pool3 ('C' entry)."""

    def __init__(self, window: int = 2, stride: int = 2, padding: int = 0,
                 ceil_mode: bool = False):
        super().__init__(window, stride, padding, ceil_mode=ceil_mode)


class Conv(nn.Conv2d):
    """Plain conv (+ optional ReLU) with torch-style symmetric padding.

    It computes in its weights' dtype: :class:`ssds_tpu_torch.detector.ObjectDetector`
    casts every conv once for bf16 serving, where flax casts per call.
    """

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True, relu: bool = False):
        super().__init__(in_channels, features, kernel, stride=stride, padding=padding,
                         dilation=dilation, groups=groups, bias=use_bias)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return F.relu(x) if self.relu else x

    @torch.no_grad()
    def init_lecun(self, generator: torch.Generator) -> None:
        """flax's default init: lecun-normal kernel, zero bias."""
        fan_in = self.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class L2Norm(nn.Module):
    """Channelwise L2 normalisation with a learned per-channel scale (init 20).

    Computed in float32 with ``eps`` added AFTER the sqrt, then cast back to
    the input's dtype (``ssds_tpu/models/layers.py:677-678``).
    """

    def __init__(self, channels: int, scale_init: float = 20.0, eps: float = 1e-10):
        super().__init__()
        self.scale_init = scale_init
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)) + self.eps
        return (xf / norm * self.weight.float()[None, :, None, None]).to(x.dtype)


def build_layers(specs: Sequence[LayerSpec],
                 in_channels: int) -> Tuple[nn.ModuleList, List[int]]:
    """Instantiate a spec list; returns the modules and each one's output width."""
    layers, widths, c = [], [], in_channels
    for spec in specs:
        layer = spec(c)
        c = getattr(layer, "out_channels", c)
        layers.append(layer)
        widths.append(c)
    return nn.ModuleList(layers), widths


@torch.no_grad()
def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> None:
    """Give every layer flax's default init, drawn in module order from ``generator``."""
    for m in model.modules():
        if isinstance(m, Conv):
            m.init_lecun(generator)
        elif isinstance(m, L2Norm):
            m.weight.fill_(m.scale_init)
