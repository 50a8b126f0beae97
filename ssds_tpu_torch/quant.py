"""Post-training int8 quantisation of the serving path (counterpart of
:mod:`ssds_tpu.quant` and ``ObjectDetector.quantize_int8``).

The JAX package's recipe, symmetric and per-tensor for activations:

- **calibration** (:func:`collect_absmax`): a few forwards in the detector's
  dtype, recording each quantisable conv's float32 ``max |input|`` with
  forward pre-hooks (JAX sows it), removed afterwards;
- **weights** (:func:`quantize_model`): per output channel, ``max|w|`` over
  ``(Cin, KH, KW)`` floored at 1e-12, over 127, in float32; ``rint`` and a
  clip to +-127, from the float32 weights;
- **serving**: each chosen conv becomes a :class:`QuantConv2d`, which
  quantises its input (``x / act_scale``, rounded half to even), runs the
  ``s8 x s8 -> s32`` convolution and dequantises in float32
  (``acc * (act_scale * w_scale) + bias``) to its input's dtype, with its
  ReLU after. On the card these are the kernels of ``csrc/int8_conv.cu``;
  on the CPU their plain versions (:mod:`ssds_tpu_torch.ops.quant`).

Which convs are quantised: exactly the JAX package's
(``ssds_tpu/quant.py:120-181``). JAX quantises the convs of its
``layers.Conv`` and ``ConvBNReLU`` (the port's :class:`~ssds_tpu_torch.models.layers.Conv`
modules), and the fused loc|conf conv over each source of a plain multibox
head: here ``loc.{k}`` and ``conf.{k}``, quantised as a unit (both or
neither) with one activation scale and each its own per-channel scales. It
keeps in float: depthwise convs (one input channel a group), convs whose
name matches ``skip_re`` (matched against the port's module names, ``base.24``,
``loc.0``, so ``"loc|conf"`` keeps the same convs float in both packages), convs
that saw no input (a zero-sized map), and the convs JAX builds with a bare
``nn.Conv``: the subtree of a module whose class sets ``QUANT_FLOAT = True``
(RFB's ``BasicRFB_a``). There is no BN folding: a ``ConvBNReLU``'s BatchNorm
and activation follow the quantised conv, as in JAX.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ssds_tpu_torch.models.layers import Conv
from ssds_tpu_torch.ops.cuda.int8_conv import int8_conv2d
from ssds_tpu_torch.ops.quant import act_scale_of, pack_weight, quantize_weight

_PAIR = re.compile(r"(loc|conf)\.(\d+)$")  # a plain multibox head's predictors


class QuantConv2d(nn.Module):
    """An int8 conv for serving: the int8 weights in the kernels' layout
    ``[Cout, KH, KW, Cin_pad]`` (buffer ``weight``), ``w_scale [Cout]`` and
    ``act_scale []`` (float32 buffers), the float32 ``bias`` or None, the
    conv's stride, padding and dilation, and a fused ReLU flag. Its output
    takes its input's dtype."""

    def __init__(self, weight: torch.Tensor, w_scale: torch.Tensor, act_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], in_channels: int, stride, padding, dilation,
                 relu: bool = False):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("act_scale", act_scale)
        self.register_buffer("bias", bias)
        self.in_channels, self.out_channels = in_channels, weight.shape[0]
        self.kernel_size = tuple(weight.shape[1:3])
        self.stride, self.padding, self.dilation = tuple(stride), tuple(padding), tuple(dilation)
        self.relu = relu

    @classmethod
    def from_conv(cls, conv: Conv, weight_q: torch.Tensor, w_scale: torch.Tensor,
                  act_scale, bias: Optional[torch.Tensor]) -> "QuantConv2d":
        """Replace ``conv`` (int8 OIHW ``weight_q``) on ``conv``'s device."""
        dev = conv.weight.device
        return cls(pack_weight(weight_q).to(dev), w_scale.float().to(dev),
                   torch.tensor(np.float32(act_scale), device=dev),
                   None if bias is None else bias.float().to(dev), conv.in_channels,
                   conv.stride, conv.padding, conv.dilation, relu=bool(conv.relu))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv2d(x, self.weight, self.act_scale, self.w_scale, self.bias, self.stride,
                           self.padding, self.dilation, self.relu)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding}, dilation={self.dilation}, "
                f"relu={self.relu}")


def candidate_convs(model: nn.Module) -> Dict[str, Conv]:
    """The convs JAX would calibrate: every :class:`Conv` outside a
    ``QUANT_FLOAT`` subtree, by module name."""
    out: Dict[str, Conv] = {}

    def walk(module: nn.Module, prefix: str):
        if getattr(module, "QUANT_FLOAT", False):
            return
        if isinstance(module, Conv):
            out[prefix] = module
            return
        for name, child in module.named_children():
            walk(child, f"{prefix}.{name}" if prefix else name)

    walk(model, "")
    return out


def collect_absmax(model: nn.Module, batches: Iterable, forward) -> Dict[str, float]:
    """Run ``forward(batch)`` for each batch with a forward pre-hook on every
    candidate conv; returns ``{name: max over batches of max |input|}``
    (float32 maxima, as floats). A conv whose input was empty records
    nothing. Raises when nothing was recorded."""
    amax: Dict[str, float] = {}

    def hook(name):
        def record(_module, args):
            x = args[0]
            if x.numel() > 0:
                v = float(x.detach().float().abs().max())
                amax[name] = max(amax.get(name, 0.0), v)
        return record

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in candidate_convs(model).items()]
    try:
        with torch.no_grad():
            for batch in batches:
                forward(batch)
    finally:
        for h in handles:
            h.remove()
    if not amax:
        raise ValueError("calibration recorded no conv input (no candidate conv ran)")
    return amax


def plan(model: nn.Module, amax: Mapping[str, float],
         skip_re: Optional[str] = None) -> List[Tuple[str, ...]]:
    """The units to quantise, each a tuple of conv names (a loc/conf pair or
    one conv), in module order."""
    convs = candidate_convs(model)
    skip = re.compile(skip_re) if skip_re else None

    def eligible(name):
        conv = convs.get(name)
        return (conv is not None and name in amax and conv.weight.shape[1] != 1
                and not (skip is not None and skip.search(name)))

    units, seen = [], set()
    for name in convs:
        if name in seen:
            continue
        m = _PAIR.fullmatch(name)
        if m:
            pair = (f"loc.{m[2]}", f"conf.{m[2]}")
            seen.update(pair)
            if all(eligible(n) for n in pair):
                units.append(pair)
        elif eligible(name):
            units.append((name,))
    return units


def quantize_model(model: nn.Module, amax: Mapping[str, float], skip_re: Optional[str] = None,
                   float_weights: Optional[Mapping[str, Tuple[torch.Tensor, Optional[torch.Tensor]]]]
                   = None) -> int:
    """Swap every convolution that :func:`plan` picks for a
    :class:`QuantConv2d`, in place; returns how many.

    ``float_weights`` maps a conv's name to its float32 ``(weight, bias)``
    where the model holds them in another dtype (bf16 serving); otherwise
    the module's own are used. A pair's convs share the first one's
    activation scale (both saw the same input). Raises when nothing is
    quantised, as JAX does."""
    units = plan(model, amax, skip_re)
    if not units:
        raise ValueError("nothing was quantized (skip_re matched all convs?)")
    state = {}
    for unit in units:
        act = act_scale_of(amax[unit[0]])
        for name in unit:
            conv = model.get_submodule(name)
            w, b = (float_weights or {}).get(name, (conv.weight, conv.bias))
            wq, w_scale = quantize_weight(w.detach().float().cpu())
            state[name] = {"weight": wq, "w_scale": w_scale, "act_scale": act,
                           "bias": None if b is None else b.detach().float().cpu()}
    return load_quantized(model, state)


def load_quantized(model: nn.Module, state: Mapping[str, Mapping]) -> int:
    """Swap each named conv for a :class:`QuantConv2d` of ``state[name]``:
    ``weight`` (int8 OIHW), ``w_scale``, ``act_scale`` and ``bias`` (a
    missing bias is the conv's own, in float32). What
    :func:`ssds_tpu_torch.weights.quant_state_from_jax` gives loads here."""
    for name, s in state.items():
        conv = model.get_submodule(name)
        bias = s.get("bias", None if conv.bias is None else conv.bias)
        q = QuantConv2d.from_conv(conv, torch.as_tensor(s["weight"]), torch.as_tensor(s["w_scale"]),
                                  s["act_scale"], None if bias is None else torch.as_tensor(bias))
        parent, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, leaf, q)
    return len(state)


def num_quantized(model: nn.Module) -> int:
    """How many convs of ``model`` are int8 (0: a float model)."""
    return sum(isinstance(m, QuantConv2d) for m in model.modules())
