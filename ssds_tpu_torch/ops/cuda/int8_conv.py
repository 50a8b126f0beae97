"""int8 serving kernels: activation quantisation and the ``s8 x s8 -> s32``
convolution with its float epilogue, and their wrappers.

The kernels are ``ssds_tpu_torch/csrc/int8_conv.cu`` (``ssds_quantize_act``,
``ssds_int8_conv``), built by :mod:`ssds_tpu_torch.ops.cuda._build` and called
through their plain C entry points. They replace the JAX package's
``ssds_tpu/quant.py:64`` ``quantize_act`` and ``:70`` ``int8_conv`` (with
``:80`` ``dequant`` as the epilogue), which XLA compiles there; PyTorch has
no CUDA int8 convolution. The source says what bounds them and how.

Each launch follows a plan computed here, on the host, from the shapes
alone (:func:`quantize_plan`, :func:`conv_plan`): tile sizes, copy and store
widths and the grid. Every conv takes the one ``wgmma`` kernel; no shape is
routed elsewhere. The C entry points check the plan they are given and
refuse one they cannot run.

:func:`quantize_act` and :func:`int8_conv` take the plain versions
(:mod:`ssds_tpu_torch.ops.quant`) for tensors on the CPU, and only then. For
CUDA tensors they launch the kernel or raise: there is no fallback. Each
counts its launches (``.launches``). The same are registered as the
operators ``torch.ops.ssds_tpu_torch.quantize_act`` and ``int8_conv`` (CUDA:
the wrapper; CPU: the plain version; a fake for tracing), which
``torch.export`` captures and an exported program calls.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ssds_tpu_torch.ops.quant import (
    conv_out_size, int8_conv_plain, padded_channels, quantize_act_torch)

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

# quantize_act: values a block (csrc/int8_conv.cu kQaTile)
QA_TILE = 4096
# int8_conv's wgmma kernel (csrc/int8_conv.cu): output pixels a block (two
# warpgroups of 64), bytes of K a stage, and the output-channel tiles that
# are instantiated, each a legal N of wgmma m64nNk32 .s32.s8.s8
CONV_BM, CONV_BK = 128, 128
CONV_BN = (16, 32, 64, 96, 128)


class QuantizePlan(NamedTuple):
    """``quantize_act``'s launch: ``ct`` channels x ``pixels`` flattened
    pixels a block and ``store`` int8 channels a thread's store (``ct`` and
    ``store`` are passed to the kernel), and the grid (pixel tiles, channel
    tiles, batch) that follows, as the kernel computes it."""
    ct: int
    pixels: int
    store: int
    grid: tuple


def store_width(cp: int) -> int:
    """The widest of 16, 8 and 4 bytes that divides ``cp``."""
    return 16 if cp % 16 == 0 else 8 if cp % 8 == 0 else 4


def quantize_plan(b: int, c: int, h: int, w: int) -> QuantizePlan:
    """The plan of one ``quantize_act`` of an NCHW ``[b, c, h, w]`` input: the
    channel tile is the padded channel count rounded up to a power of 2,
    from 4 to 64, and the pixel tile fills the block's :data:`QA_TILE`
    values, so a narrow map fills every block."""
    cp = padded_channels(c)
    ct = 4
    while ct < min(cp, 64):
        ct *= 2
    pixels = QA_TILE // ct
    return QuantizePlan(ct, pixels, store_width(cp), (-(-h * w // pixels), -(-cp // ct), b))


class ConvPlan(NamedTuple):
    """``int8_conv``'s launch: the output-channel tile ``bn`` (the wgmma N)
    and the bytes a ``cp.async`` copies (``vec``, dividing Cp), which the
    kernel is given; and the tiles along M (output pixels), N (output
    channels) and K (stages of :data:`CONV_BK` bytes) and the grid (blocks)
    that follow from them, as the kernel computes them."""
    bn: int
    vec: int
    m_tiles: int
    n_tiles: int
    k_stages: int
    grid: int


def conv_plan(b: int, ho: int, wo: int, cp: int, cout: int, kh: int, kw: int) -> ConvPlan:
    """The plan of one ``int8_conv``: the smallest instantiated N tile that
    holds ``cout``, else the largest; copies as wide as ``cp`` allows."""
    bn = next((n for n in CONV_BN if n >= cout), CONV_BN[-1])
    m_tiles, n_tiles = -(-b * ho * wo // CONV_BM), -(-cout // bn)
    return ConvPlan(bn, store_width(cp), m_tiles, n_tiles, -(-kh * kw * cp // CONV_BK),
                    m_tiles * n_tiles)


def _launch(fn, device: int, *args) -> None:
    if device == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__}: CUDA kernel launch failed (cudaError {err})")


def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """The one CUDA device of ``tensors``; raises on a mix, a CPU tensor or a
    non-contiguous one."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or not tensors[0].is_cuda:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; need all on the CPU "
                         "or all on one CUDA device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: tensors must be 4-byte aligned")
    return tensors[0].get_device()


def _check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The kernels' 16-byte copies need 16-byte aligned base pointers."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: int8 tensors must be 16-byte aligned, got an offset of "
                             f"{t.data_ptr() % 16} bytes")


def _check_scale(name: str, act_scale: torch.Tensor) -> None:
    if act_scale.dtype != torch.float32 or act_scale.numel() != 1:
        raise TypeError(f"{name}: act_scale must be one float32 value, got "
                        f"{act_scale.dtype} {tuple(act_scale.shape)}")


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """NCHW float32 / bf16 ``x`` -> NHWC int8 ``[B, H, W, Cin_pad]``,
    ``clamp(rint(x / act_scale), -127, 127)``, padding channels 0."""
    if x.device.type == "cpu" and act_scale.device.type == "cpu":
        return quantize_act_torch(x, act_scale)
    device = _check_cuda("quantize_act", x, act_scale)
    _check_scale("quantize_act", act_scale)
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise TypeError(f"quantize_act: need a 4-d float32 or bf16 NCHW tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, c, h, w = x.shape
    cp = padded_channels(c)
    out = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    from ssds_tpu_torch.ops.cuda import _build

    plan = quantize_plan(b, c, h, w)
    lib = _build.load()
    stream = torch._C._cuda_getCurrentRawStream(device)
    _launch(lib.ssds_quantize_act, device, x.data_ptr(), int(x.dtype == torch.bfloat16),
            act_scale.data_ptr(), out.data_ptr(), b, c, h, w, cp, plan.ct, plan.store, stream)
    quantize_act.launches += 1
    return out


quantize_act.launches = 0


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, act_scale: torch.Tensor,
              w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: Sequence[int],
              padding: Sequence[int], dilation: Sequence[int], relu: bool,
              out_dtype: torch.dtype) -> torch.Tensor:
    """NHWC int8 ``xq [B, H, W, Cp]`` convolved with int8 ``wq [Cout, KH, KW,
    Cp]`` -> NCHW ``[B, Cout, Ho, Wo]``: the int32 accumulators when
    ``out_dtype`` is int32, else ``acc * (act_scale * w_scale) + bias`` in
    float32, cast to ``out_dtype`` (float32 or bf16), then the ReLU when
    ``relu``. ``stride``, ``padding``, ``dilation``: (h, w) pairs."""
    stride, padding, dilation = (tuple(int(v) for v in a) for a in (stride, padding, dilation))
    tensors = [t for t in (xq, wq, act_scale, w_scale, bias) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return int8_conv_plain(xq, wq, act_scale, w_scale, bias, stride, padding, dilation,
                               relu, out_dtype)
    device = _check_cuda("int8_conv", *tensors)
    _check_scale("int8_conv", act_scale)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4 or wq.dim() != 4:
        raise TypeError(f"int8_conv: need 4-d int8 input and weights, got {xq.dtype} "
                        f"{tuple(xq.shape)} / {wq.dtype} {tuple(wq.shape)}")
    b, h, w, cp = xq.shape
    cout, kh, kw, wcp = wq.shape
    if cp != wcp or cp % 4:
        raise ValueError(f"int8_conv: input channels {cp} and weight channels {wcp} must agree "
                         "and be a multiple of 4")
    _check_aligned16("int8_conv", xq, wq)
    if w_scale.dtype != torch.float32 or w_scale.shape != (cout,):
        raise ValueError(f"int8_conv: w_scale must be float32 [{cout}]")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (cout,)):
        raise ValueError(f"int8_conv: bias must be float32 [{cout}]")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"int8_conv: out_dtype {out_dtype} (float32, bf16 or int32)")
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    out = torch.empty((b, cout, ho, wo), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    from ssds_tpu_torch.ops.cuda import _build

    plan = conv_plan(b, ho, wo, cp, cout, kh, kw)
    lib = _build.load()
    stream = torch._C._cuda_getCurrentRawStream(device)
    args = _build.ConvArgs(b, h, w, cp, cout, kh, kw, ho, wo, *stride, *padding, *dilation,
                           int(relu), _OUT_KIND[out_dtype], plan.bn, plan.vec)
    _launch(lib.ssds_int8_conv, device, xq.data_ptr(), wq.data_ptr(), act_scale.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(), args,
            stream)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


# The kernels as operators that ``torch.export`` can capture (the wrappers
# read data pointers and launch through ctypes, which a trace cannot follow):
# CUDA is the wrapper (the kernel, counted, or an error), CPU the plain
# version, and the fake gives the output's shape and dtype. Importing this
# module registers them.
@torch.library.custom_op("ssds_tpu_torch::quantize_act", mutates_args=(), device_types="cuda")
def quantize_act_op(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """``torch.ops.ssds_tpu_torch.quantize_act``: :func:`quantize_act`."""
    return quantize_act(x, act_scale)


@quantize_act_op.register_kernel("cpu")
def _quantize_act_op_cpu(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    return quantize_act_torch(x, act_scale)


@quantize_act_op.register_fake
def _quantize_act_op_fake(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.new_empty((b, h, w, padded_channels(c)), dtype=torch.int8)


@torch.library.custom_op("ssds_tpu_torch::int8_conv", mutates_args=(), device_types="cuda")
def int8_conv_op(xq: torch.Tensor, wq: torch.Tensor, act_scale: torch.Tensor,
                 w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: List[int],
                 padding: List[int], dilation: List[int], relu: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``torch.ops.ssds_tpu_torch.int8_conv``: :func:`int8_conv`."""
    return int8_conv(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu, out_dtype)


@int8_conv_op.register_kernel("cpu")
def _int8_conv_op_cpu(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu,
                      out_dtype):
    return int8_conv_plain(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu,
                           out_dtype)


@int8_conv_op.register_fake
def _int8_conv_op_fake(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu,
                       out_dtype):
    b, h, w, _ = xq.shape
    cout, kh, kw, _ = wq.shape
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    return xq.new_empty((b, cout, ho, wo), dtype=out_dtype)


def int8_conv2d(x: torch.Tensor, wq: torch.Tensor, act_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor], stride: Sequence[int],
                padding: Sequence[int], dilation: Sequence[int], relu: bool) -> torch.Tensor:
    """A quantised conv of NCHW ``x``, output in ``x``'s dtype: the two
    wrappers, or while ``torch.export`` traces, the two operators."""
    if torch.compiler.is_exporting():
        ops = torch.ops.ssds_tpu_torch
        xq = ops.quantize_act(x, act_scale)
        return ops.int8_conv(xq, wq, act_scale, w_scale, bias, list(stride), list(padding),
                             list(dilation), relu, x.dtype)
    xq = quantize_act(x, act_scale)
    return int8_conv(xq, wq, act_scale, w_scale, bias, stride, padding, dilation, relu, x.dtype)
