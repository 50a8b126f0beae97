"""Building blocks for backbones and heads (counterpart of :mod:`ssds_tpu.models.layers`).

NCHW inside, as PyTorch convolutions want it. Padding follows the torch
conventions of the reference models, so feature-map sizes match the JAX
package and the anchor set exactly (ceil-mode pool3: 75 -> 38).

A ``LayerSpec`` here is a callable ``spec(in_channels) -> nn.Module`` (the
JAX package's specs take no argument because flax infers input widths; torch
layers need them). :func:`build_layers` instantiates a spec list and tracks
the channel count through modules that have an ``out_channels``.

The BatchNorm blocks (``ConvBNReLU``, ``SepConvBNReLU``, ``InvertedResidual``)
are flat ``nn.Sequential`` stacks of (conv, BN, activation) entries, so their
state-dict names are those of the reference's ``conv_bn`` / ``conv_dw`` /
``InvertedResidual.conv`` (``tests/ref_torch_skeletons.py``).

The RFB heads' ``BasicConv`` (conv, BN, optional ReLU as named children
``.conv`` / ``.bn``) takes square, non-square (1x3, 3x1) and dilated kernels.
:func:`resize_bilinear` is ``jax.image.resize``'s bilinear resize (:class:`Resize`
its module form, which the spatial axis splits by rows), and
:func:`no_autocast` opens the float32 region of a head that runs part of its
work in float32 whatever the compute dtype (FSSD after its fusion BN).

Under data parallelism (a process group of more than one rank) a train-mode
:class:`BatchNorm` takes its statistics over every rank's batch, as the JAX
package's jitted step over a sharded batch does (:class:`_GlobalBatchNorm`);
on the spatial axis each rank holds a band of rows, and the same sums over
every rank's pixels are the global batch's statistics.

These are the float paths: int8 serving swaps a :class:`Conv` for
:class:`ssds_tpu_torch.quant.QuantConv2d`; the JAX package's space-to-depth
stem is not ported (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ssds_tpu_torch.parallel import sharding

LayerSpec = Callable[[int], nn.Module]
Size2 = Union[int, Tuple[int, int]]  # a kernel, stride, padding or dilation: one int or (h, w)

# flax.linen.Conv's default kernel init, lecun_normal: a normal truncated at
# +-2 std, rescaled so the truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class ReLU(nn.ReLU):
    """``max(x, 0)`` (the JAX package's output-keyed VJP is a TPU memory trick)."""


class ReLU6(nn.ReLU6):
    """``min(max(x, 0), 6)``; the gradient passes where ``0 < x < 6``, as the
    JAX package's ``relu6`` VJP (``ssds_tpu/models/layers.py:54-68``)."""


class LeakyReLU(nn.Module):
    """``x`` where ``x > 0``, else ``slope * x`` (DarkNet's slope 0.1), and the
    gradient ``g`` or ``slope * g`` likewise: the JAX package's
    ``leaky_relu`` (``ssds_tpu/models/layers.py:73-91``), whose output-keyed
    VJP picks the same branch. JAX multiplies by the Python float as a weakly
    typed scalar, i.e. rounded to the input's dtype first (0.10009765625 in
    bf16), so the slope here is rounded to the input's dtype too: the bf16
    products are then the same."""

    def __init__(self, negative_slope: float = 0.1):
        super().__init__()
        self.negative_slope = negative_slope
        self._slopes: dict = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        slope = self._slopes.get(x.dtype)
        if slope is None:
            slope = self._slopes[x.dtype] = float(torch.tensor(self.negative_slope,
                                                               dtype=x.dtype))
        return F.leaky_relu(x, slope)


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

    def __init__(self, in_channels: int, features: int, kernel: Size2 = 3, stride: Size2 = 1,
                 padding: Size2 = 0, dilation: Size2 = 1, groups: int = 1,
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


class BatchNorm(nn.BatchNorm2d):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` under torch's names.

    Train mode normalises with the batch's biased statistics, as both
    frameworks do, and blends them into the running buffers the flax way:
    ``running = 0.9 running + 0.1 batch``, with the BIASED batch variance
    (``torch.nn.BatchNorm2d`` blends the unbiased one, n/(n-1) larger).
    Eval mode normalises with the running buffers. Either way the statistics
    and the normalisation are float32 and the output takes the input's dtype
    (bf16 under autocast and in bf16 serving), as flax's ``dtype=x.dtype``
    BatchNorm computes. ``num_batches_tracked`` counts train-mode calls and
    is read by nothing: the momentum is fixed. A train-mode input with one
    value a channel raises here (``F.batch_norm``), where flax gives the bias.
    Under a process group of several ranks the train-mode statistics are the
    global batch's (:func:`global_statistics`, :class:`_GlobalBatchNorm`).
    Inside :func:`recomputing` the running buffers stay as they are.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if global_statistics():
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            mean, var = mean.to(self.running_mean.dtype), var.to(self.running_var.dtype)
            to_biased = 1.0
        else:
            # momentum 1 writes the batch's own statistics into the scratch
            # vectors: the mean, and the variance unbiased, as torch keeps it
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            n = x.numel() // x.shape[1]
            to_biased = (n - 1) / n
        if not _RECOMPUTING:  # the forward moved them; its recompute does not
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * to_biased * var)
                self.num_batches_tracked.add_(1)
        return y


_RECOMPUTING: List[bool] = []


@contextlib.contextmanager
def recomputing():
    """The backward's recompute of a forward under ``TPU.REMAT``
    (``torch.utils.checkpoint``'s recompute context): a train-mode
    :class:`BatchNorm` computes as in the forward, but leaves its running
    statistics where the forward moved them, so they move once a step."""
    _RECOMPUTING.append(True)
    try:
        yield
    finally:
        _RECOMPUTING.pop()


def global_statistics() -> bool:
    """Whether a train-mode :class:`BatchNorm` takes its statistics over the
    batches of every rank: under a process group of more than one rank."""
    return sharding.world_size() > 1


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalisation over the global batch of a process
    group: ``(y, mean, var)`` of ``x [N, C, H, W]``.

    Forward: one all-reduce of ``(count, sum x, sum x^2)`` a channel, then
    ``mean = sum x / n`` and ``var = max(sum x^2 / n - mean^2, 0)``, flax's
    fast variance (what the JAX step computes over the sharded batch), and
    ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, flax's order.
    Backward: one all-reduce of ``(sum dy, sum dy * xhat)``, the gradient
    of every rank's loss through the shared statistics, as
    ``torch.nn.SyncBatchNorm`` computes it; the weight's and bias's
    gradients are this rank's sums, which DDP averages with the rest. The
    statistics are float32 (float64 for a float64 model) and ``y`` takes
    ``x``'s dtype. Plain torch operations and ``torch.distributed``, so the
    same code runs on gloo on the CPU and on NCCL on the card."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dtype = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dtype)
        c = x.shape[1]
        stats = torch.stack([torch.full((c,), x.numel() // c, dtype=dtype, device=x.device),
                             xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])
        sharding.all_reduce_sum_(stats)
        n = stats[0]
        mean = stats[1] / n
        var = torch.clamp_min(stats[2] / n - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        y = (xf - mean[:, None, None]) * (invstd * weight.to(dtype))[:, None, None] \
            + bias.to(dtype)[:, None, None]
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, n = ctx.saved_tensors
        dyf = dy.to(xhat.dtype)
        local = torch.stack([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        total = sharding.all_reduce_sum_(local.clone())
        dx = (dyf - (total[0] / n)[:, None, None] - xhat * (total[1] / n)[:, None, None]) \
            * (invstd * weight.to(xhat.dtype))[:, None, None]
        return (dx.to(dy.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype), None)


class Float32BatchNorm(BatchNorm):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` with no ``dtype``:
    the input's dtype and the parameters' promote, so a bf16 input comes out
    float32 (FSSD's fusion BN, ``ssds_tpu/models/heads/fssd.py:68``). The
    input is widened first; the statistics and the normalisation are those of
    :class:`BatchNorm` on the same values."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


def no_autocast(x: torch.Tensor):
    """A region where autocast is off on ``x``'s device: nothing to switch
    off where it is not on (serving, which ``torch.export`` traces, or the
    ``meta`` device, where models are measured)."""
    device = x.device.type
    if torch.amp.is_autocast_available(device) and torch.is_autocast_enabled(device):
        return torch.autocast(device, enabled=False)
    return contextlib.nullcontext()


_ACTIVATIONS = {"relu": ReLU, "relu6": ReLU6, "leaky": LeakyReLU}


class ConvBNReLU(nn.Sequential):
    """conv (no bias) -> :class:`BatchNorm` -> activation, as entries 0, 1, 2
    (``act`` relu / relu6 / leaky; ``none`` leaves entry 2 out). Reference
    ``conv_bn``; ``ssds_tpu/models/layers.py:543``."""

    def __init__(self, in_channels: int, features: int, kernel: Size2 = 3, stride: int = 1,
                 padding: Size2 = 1, dilation: int = 1, groups: int = 1, act: str = "relu"):
        layers = [Conv(in_channels, features, kernel, stride=stride, padding=padding,
                       dilation=dilation, groups=groups, use_bias=False), BatchNorm(features)]
        if act != "none":
            layers.append(_ACTIVATIONS[act]())
        super().__init__(*layers)
        self.out_channels = features


class BasicConv(nn.Module):
    """conv (no bias) -> :class:`BatchNorm` -> ReLU when ``relu``, as the
    children ``.conv`` and ``.bn``: the reference RFB's ``BasicConv``
    (``tests/ref_torch_skeletons.py``). Kernels may be non-square with
    per-axis padding (``BasicRFB_a``'s 1x3 and 3x1) and dilated; the JAX
    package's counterpart is ``ConvBNReLU`` in ``BasicRFB`` and an inline
    ``nn.Conv`` + ``nn.BatchNorm`` in ``BasicRFB_a``
    (``ssds_tpu/models/heads/rfb.py:155-240``)."""

    def __init__(self, in_channels: int, features: int, kernel: Size2 = 3, stride: int = 1,
                 padding: Size2 = 1, dilation: int = 1, relu: bool = True):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride=stride, padding=padding,
                         dilation=dilation, use_bias=False)
        self.bn = BatchNorm(features)
        self.relu = relu
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class SepConvBNReLU(nn.Sequential):
    """Depthwise-separable conv: a depthwise ``expand_kernel`` conv, BN, act,
    then a 1x1 conv, BN, act, as one flat stack (entries 0-5). Reference
    ``conv_dw``; ``ssds_tpu/models/layers.py:609``."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, padding: int = 1,
                 act: str = "relu", expand_kernel: int = 3):
        super().__init__(
            *ConvBNReLU(in_channels, in_channels, expand_kernel, stride=stride, padding=padding,
                        groups=in_channels, act=act),
            *ConvBNReLU(in_channels, features, 1, padding=0, act=act))
        self.out_channels = features


class InvertedResidual(nn.Module):
    """MobileNetV2 block: 1x1 expand (relu6; none when ``expand_ratio`` is 1),
    3x3 depthwise (stride, relu6), 1x1 linear projection, plus the input when
    the stride is 1 and the widths agree. The stack is ``.conv``, as in the
    reference; ``ssds_tpu/models/layers.py:633``."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, expand_ratio: int = 6):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers += ConvBNReLU(in_channels, hidden, 1, padding=0, act="relu6")
        layers += ConvBNReLU(hidden, hidden, 3, stride=stride, padding=1, groups=hidden,
                             act="relu6")
        layers += ConvBNReLU(hidden, features, 1, padding=0, act="none")
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and in_channels == features
        self.out_channels = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + x if self.residual else y


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` float32 weights of ``jax.image.resize``'s bilinear
    (triangle) kernel along one axis: half-pixel centres, the kernel widened
    by ``n_in / n_out`` when shrinking (antialiasing), each output's weights
    renormalised to sum to 1 (which clamps at the edges), with the float32
    operations of ``jax._src.image.scale.compute_weight_mat``. Upsampling,
    the weights equal JAX's bit for bit; shrinking, XLA's compiled kernel
    rounds some of them one ulp apart."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    widen = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
                   / widen)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


_RESIZE_CACHE: dict = {}


def _resize_matrix(n_in: int, n_out: int, x: torch.Tensor) -> torch.Tensor:
    """:func:`_resize_weights` rounded to ``x``'s dtype, then held in float32
    on ``x``'s device; made once for each size, dtype and device, but not
    kept from a ``torch.export`` trace, whose tensors are the trace's own."""
    key = (n_in, n_out, x.dtype, x.device)
    w = _RESIZE_CACHE.get(key)
    if w is None:
        w = torch.from_numpy(_resize_weights(n_in, n_out)).to(x.dtype).float().to(x.device)
        if not torch.compiler.is_compiling():
            _RESIZE_CACHE[key] = w
    return w


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize to ``size``: ``jax.image.resize(..., "bilinear")``
    (``ssds_tpu/models/layers.py:695``), what the JAX package's FSSD calls.

    Upsampling, this is ``F.interpolate(mode="bilinear", align_corners=False)``
    in float32; shrinking, it antialiases as JAX does (``antialias=True``).
    Each axis whose size changes is one contraction with its weight matrix,
    computed in float32 with the weights rounded to ``x``'s dtype and the
    result rounded to it after each axis, in the order ``jnp.einsum`` picks
    (the fewer multiply-adds; rows first on a tie): in bf16 that is what
    ``jax.image.resize`` gives on the CPU, bit for bit. Autocast is off
    inside, so the result keeps ``x``'s dtype.
    """
    h, w = x.shape[2], x.shape[3]
    out_h, out_w = int(size[0]), int(size[1])

    def rows(y):
        if out_h == h:
            return y
        return torch.matmul(_resize_matrix(h, out_h, x).t(), y.float()).to(x.dtype)

    def cols(y):
        if out_w == w:
            return y
        return torch.matmul(y.float(), _resize_matrix(w, out_w, x)).to(x.dtype)

    with no_autocast(x):
        if w * out_h * (h + out_w) <= h * out_w * (w + out_h):
            return cols(rows(x))
        return rows(cols(x))


class Resize(nn.Module):
    """:func:`resize_bilinear` as a module with no parameters or buffers
    (it adds no state-dict key), one a call site: on the spatial axis
    :func:`ssds_tpu_torch.parallel.spatial.partition` gives it its global
    heights and a banded forward, as it gives a conv."""

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        return resize_bilinear(x, size)


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
        elif isinstance(m, BatchNorm):
            m.reset_parameters()  # scale 1, bias 0, mean 0, var 1, as flax's
