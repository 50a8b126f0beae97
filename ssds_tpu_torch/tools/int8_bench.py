"""The int8 serving kernels on the card: ``quantize_act`` and ``int8_conv``
(``csrc/int8_conv.cu``) held bit-identical to their plain versions
(:mod:`ssds_tpu_torch.ops.quant`) and timed beside their bounds, their plain
versions, cuDNN's bf16 convolution of the same shape and ``torch._int_mm``.

    python -m ssds_tpu_torch.tools.int8_bench [--batches 1,32] [--seed 0] [--out PATH]

The shapes are every quantised conv of SSD300-VGG16 (``MODEL.QUANT: int8``
over the default config, found by running its quantised model once) plus a
3x3 stride-2 and a 1x1 conv of MobileNetV2-300 and of DarkNet-53-416
(:data:`EXTRA_SHAPES`). At each batch and shape: ``quantize_act`` on the
bf16 and the float32 input and ``int8_conv``'s int32 accumulators and its bf16
output must equal the plain versions bit for bit (the plain conv runs in
float64 on the card with cuDNN off, exact for integers), and so must the
yardstick's accumulators. Kernel, cuDNN and ``_int_mm`` times are device
times: CUDA events over back-to-back launches queued behind a sleep
(``tools.time_cuda_queued``), so a kernel shorter than its launch is timed
and not the host's launch rate, the median of three such runs; the plain
versions' are CUDA events over back-to-back calls. A conv's bound is the
larger of its int8 operations at the dense int8 tensor-core peak and its
bytes (the int8 input read once, the weights, the bf16 output written once)
at the HBM rate; ``quantize_act``'s is its bytes; a batch's sums count all
the shapes' operations and bytes as one piece of work. Each case records
its share of the bound (bound / time) and its plan
(``ops/cuda/int8_conv.py::conv_plan``: the N tile and the copy width; every
case takes the one ``wgmma`` kernel).

The library yardstick (``library_ms``) is cuBLASLt's ``s8 x s8 -> s32`` GEMM
through ``torch._int_mm``, timed alone, and only the GEMM: its operands are
built outside the timed region (:func:`int_mm_operands`). For a 1x1
stride-1 unpadded conv the A operand is the NHWC input itself, ``[M, Cp]``;
for the others the input im2col'd to ``[M, KH * KW * Cp]`` in the weights'
``(ky, kx, c)`` order (:func:`im2col`). It skips the dequant epilogue and,
for the im2col'd convs, the im2col itself, so it is a lower yardstick than
the kernel's work. ``_int_mm`` on the card wants more than 16 rows and K and
N multiples of 8: operands short of that are zero-padded (zero K columns add
nothing; the extra rows and output columns are computed and dropped). The
port never calls ``_int_mm``.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ssds_tpu_torch.tools import card_line, need_cuda, roofline_ms, time_cuda, time_cuda_queued

INT8_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core peak


class ConvShape(NamedTuple):
    name: str
    cin: int
    cout: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    padding: Tuple[int, int]
    dilation: Tuple[int, int]
    hw: Tuple[int, int]
    bias: bool
    relu: bool


# a 3x3 stride-2 and a 1x1 conv of MobileNetV2-300 (the stem; the first
# block's expand at 150 px) and of DarkNet-53-416 (the first downsample; the
# first residual's 1x1), all ConvBNReLU convs: no bias, the ReLU after the BN
EXTRA_SHAPES = (
    ConvShape("mobilenet_v2.stem_3x3_s2", 3, 32, (3, 3), (2, 2), (1, 1), (1, 1), (300, 300),
              False, False),
    ConvShape("mobilenet_v2.expand_1x1", 16, 96, (1, 1), (1, 1), (0, 0), (1, 1), (150, 150),
              False, False),
    ConvShape("darknet53.down_3x3_s2", 32, 64, (3, 3), (2, 2), (1, 1), (1, 1), (416, 416),
              False, False),
    ConvShape("darknet53.residual_1x1", 64, 32, (1, 1), (1, 1), (0, 0), (1, 1), (208, 208),
              False, False),
)


def model_shapes(model: torch.nn.Module, img_hw, device,
                 dtype: torch.dtype = torch.bfloat16) -> List[ConvShape]:
    """Every :class:`~ssds_tpu_torch.quant.QuantConv2d` of ``model`` with the
    input size it sees, in call order (one forward of a zero ``dtype`` image)."""
    from ssds_tpu_torch.quant import QuantConv2d

    found: Dict[str, ConvShape] = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, QuantConv2d):
            def record(mod, args, name=name):
                found[name] = ConvShape(name, mod.in_channels, mod.out_channels, mod.kernel_size,
                                        mod.stride, mod.padding, mod.dilation,
                                        tuple(args[0].shape[2:]), mod.bias is not None, mod.relu)
            hooks.append(m.register_forward_pre_hook(record))
    try:
        with torch.no_grad():
            model(torch.zeros((1, 3, *img_hw), dtype=dtype, device=device), phase="eval")
    finally:
        for h in hooks:
            h.remove()
    return list(found.values())


def _operands(shape: ConvShape, batch: int, gen: torch.Generator, device):
    from ssds_tpu_torch.ops.quant import act_scale_of, pack_weight, quantize_weight

    x = torch.randn((batch, shape.cin, *shape.hw), device=device) * 3.0  # the device's generator
    w = torch.randn((shape.cout, shape.cin, *shape.kernel), generator=gen) * 0.05
    wq, w_scale = quantize_weight(w)
    bias = (torch.randn((shape.cout,), generator=gen) * 0.1).to(device) if shape.bias else None
    act = torch.tensor(act_scale_of(float(x.abs().max())), device=device)
    return x, pack_weight(wq).to(device), w_scale.to(device), bias, act


def conv_work(shape: ConvShape, batch: int, out_bytes: int = 2):
    """(int8 operations, bytes) of one conv at ``batch``: two a multiply-add;
    the int8 input and weights read once and the output written once."""
    from ssds_tpu_torch.ops.quant import conv_out_size, padded_channels

    ho = conv_out_size(shape.hw[0], shape.kernel[0], shape.stride[0], shape.padding[0],
                       shape.dilation[0])
    wo = conv_out_size(shape.hw[1], shape.kernel[1], shape.stride[1], shape.padding[1],
                       shape.dilation[1])
    cp = padded_channels(shape.cin)
    macs = batch * shape.cout * ho * wo * shape.cin * shape.kernel[0] * shape.kernel[1]
    nbytes = (batch * shape.hw[0] * shape.hw[1] * cp + shape.cout * shape.kernel[0]
              * shape.kernel[1] * cp + batch * shape.cout * ho * wo * out_bytes)
    return 2.0 * macs, nbytes


def im2col(xq: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
           padding: Sequence[int], dilation: Sequence[int]) -> torch.Tensor:
    """NHWC ``xq [B, H, W, Cp]`` -> ``[B * Ho * Wo, KH * KW * Cp]``: each output
    pixel's receptive field in the weights' ``(ky, kx, c)`` order, zeros
    outside the image."""
    from ssds_tpu_torch.ops.quant import conv_out_size

    b, h, w, cp = xq.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    ho, wo = conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph))
    taps = [xp[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh, kx * dw:kx * dw + (wo - 1) * sw + 1:sw]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * cp)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def int_mm_operands(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                    padding: Sequence[int], dilation: Sequence[int]):
    """``(A [M', K'], B [K', N'])`` int8 for ``torch._int_mm(A, B)``: A the NHWC
    input viewed ``[M, Cp]`` for a 1x1 stride-1 unpadded conv, else
    :func:`im2col`; B the ``[Cout, KH, KW, Cp]`` weights as ``[Cout, K]``,
    transposed (a column-major view). Zero-padded to ``M' > 16`` rows and
    ``K', N'`` multiples of 8, as ``_int_mm`` on the card requires; the first
    ``M x Cout`` of the product are the conv's accumulators."""
    cout, kh, kw, cp = wq.shape
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) and tuple(padding) == (0, 0):
        a = xq.reshape(-1, cp)
    else:
        a = im2col(xq, (kh, kw), stride, padding, dilation)
    m, k = a.shape
    rows, depth, cols = max(m, 17), -(-k // 8) * 8, -(-cout // 8) * 8
    return _pad_to(a, rows, depth), _pad_to(wq.reshape(cout, k), cols, depth).t()


def int_mm_acc(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
               padding: Sequence[int], dilation: Sequence[int]) -> torch.Tensor:
    """The conv's NCHW int32 accumulators through ``torch._int_mm`` (the
    yardstick's function, which must equal ``int8_conv_torch``'s)."""
    from ssds_tpu_torch.ops.quant import conv_out_size

    b, h, w, _ = xq.shape
    cout, kh, kw, _ = wq.shape
    ho = conv_out_size(h, kh, stride[0], padding[0], dilation[0])
    wo = conv_out_size(w, kw, stride[1], padding[1], dilation[1])
    acc = torch._int_mm(*int_mm_operands(xq, wq, stride, padding, dilation))
    return acc[:b * ho * wo, :cout].reshape(b, ho, wo, cout).permute(0, 3, 1, 2).contiguous()


def quantize_bytes(shape: ConvShape, batch: int) -> int:
    """``quantize_act``'s bytes: the bf16 input read, the padded int8 written."""
    from ssds_tpu_torch.ops.quant import padded_channels

    return batch * shape.hw[0] * shape.hw[1] * (2 * shape.cin + padded_channels(shape.cin))


ITERS = 10  # timed launches a case (the plain conv: 2)
REPEATS = 3  # device times are the median of this many runs of ITERS launches


def _device_ms(fn) -> float:
    """Median device milliseconds of ``fn()`` over :data:`REPEATS` queued runs."""
    return statistics.median(time_cuda_queued(fn, ITERS) for _ in range(REPEATS))


def run(shapes: Sequence[ConvShape], batches=(1, 32), seed: int = 0, log=print,
        time_it: bool = True) -> dict:
    """Check every shape at every batch and, with ``time_it``, time it.
    Returns ``{"cases": {"<name>/b<batch>": {...}}, "max_abs_err": 0.0,
    per-batch sums}``; raises on the first mismatch."""
    from ssds_tpu_torch.ops.cuda.int8_conv import conv_plan, int8_conv, quantize_act
    from ssds_tpu_torch.ops.quant import (
        conv_out_size, dequant_torch, int8_conv_torch, padded_channels, quantize_act_torch)

    dev = need_cuda("int8_bench")
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    cases, sums = {}, {}
    for batch in batches:
        total = {"kernel_ms": 0.0, "quantize_ms": 0.0, "plain_ms": 0.0, "plain_quantize_ms": 0.0,
                 "cudnn_bf16_ms": 0.0, "library_ms": 0.0}
        ops = nbytes = qbytes_all = 0.0
        for shape in shapes:
            x, wq, w_scale, bias, act = _operands(shape, batch, gen, dev)
            args = (shape.stride, shape.padding, shape.dilation)
            xb = x.to(torch.bfloat16)
            for inp in (x, xb):
                got, want = quantize_act(inp, act), quantize_act_torch(inp, act)
                if not torch.equal(got, want):
                    raise AssertionError(f"quantize_act != plain at {shape.name} batch {batch} "
                                         f"{inp.dtype}: {(got != want).sum().item()} values")
            xq = quantize_act(xb, act)
            acc = int8_conv(xq, wq, act, w_scale, bias, *args, shape.relu, torch.int32)
            want_acc = int8_conv_torch(xq, wq, *args)
            if not torch.equal(acc, want_acc):
                raise AssertionError(f"int8_conv accumulators != plain at {shape.name} batch "
                                     f"{batch}: {(acc != want_acc).sum().item()} values")
            y = int8_conv(xq, wq, act, w_scale, bias, *args, shape.relu, torch.bfloat16)
            want_y = dequant_torch(want_acc, act, w_scale, bias, shape.relu, torch.bfloat16)
            if not torch.equal(y, want_y):
                raise AssertionError(f"int8_conv output != plain at {shape.name} batch {batch}")
            if not torch.equal(int_mm_acc(xq, wq, *args), want_acc):
                raise AssertionError(f"torch._int_mm accumulators != plain at {shape.name} "
                                     f"batch {batch}")
            ho = conv_out_size(shape.hw[0], shape.kernel[0], shape.stride[0], shape.padding[0],
                               shape.dilation[0])
            wo = conv_out_size(shape.hw[1], shape.kernel[1], shape.stride[1], shape.padding[1],
                               shape.dilation[1])
            plan = conv_plan(batch, ho, wo, padded_channels(shape.cin), shape.cout,
                             *shape.kernel)
            case = {"shape": [batch, shape.cin, *shape.hw], "cout": shape.cout,
                    "kernel": list(shape.kernel), "stride": list(shape.stride),
                    "dilation": list(shape.dilation), "bn": plan.bn,
                    "vec": plan.vec}
            work = conv_work(shape, batch)
            case["bound_ms"], case["bound_by"] = roofline_ms(*work, INT8_OPS_S)
            qbytes = quantize_bytes(shape, batch)
            case["quantize_bound_ms"], _ = roofline_ms(0.0, qbytes)
            ops, nbytes, qbytes_all = ops + work[0], nbytes + work[1], qbytes_all + qbytes
            if time_it:
                wb = (torch.randn((shape.cout, shape.cin, *shape.kernel), generator=gen) * 0.05
                      ).to(dev, torch.bfloat16)
                bb = None if bias is None else bias.to(torch.bfloat16)
                case["kernel_ms"] = _device_ms(lambda: int8_conv(
                    xq, wq, act, w_scale, bias, *args, shape.relu, torch.bfloat16))
                case["quantize_ms"] = _device_ms(lambda: quantize_act(xb, act))
                mm_a, mm_b = int_mm_operands(xq, wq, *args)
                case["library_ms"] = _device_ms(lambda: torch._int_mm(mm_a, mm_b))
                del mm_a, mm_b
                case["plain_ms"] = time_cuda(lambda: dequant_torch(
                    int8_conv_torch(xq, wq, *args), act, w_scale, bias, shape.relu,
                    torch.bfloat16), 2, warmup=1)
                case["plain_quantize_ms"] = time_cuda(lambda: quantize_act_torch(xb, act), ITERS)
                case["cudnn_bf16_ms"] = _device_ms(lambda: F.conv2d(
                    xb, wb, bb, shape.stride, shape.padding, shape.dilation))
                case["share"] = case["bound_ms"] / case["kernel_ms"]
                case["quantize_share"] = case["quantize_bound_ms"] / case["quantize_ms"]
            for key in total:
                total[key] += case.get(key, 0.0)
            cases[f"{shape.name}/b{batch}"] = case
            del x, xb, xq, acc, want_acc, y, want_y
        # the whole set as one piece of work: its operations and its bytes
        total["bound_ms"], total["bound_by"] = roofline_ms(ops, nbytes, INT8_OPS_S)
        total["quantize_bound_ms"], _ = roofline_ms(0.0, qbytes_all)
        sums[f"b{batch}"] = total
        if time_it:
            total["share"] = total["bound_ms"] / total["kernel_ms"]
            total["quantize_share"] = total["quantize_bound_ms"] / total["quantize_ms"]
            log(f"int8 convs at batch {batch} ({len(shapes)} shapes): "
                f"int8_conv {total['kernel_ms']:.3f} ms ({100 * total['share']:.1f} % of its "
                f"bound {total['bound_ms']:.3f} ms) + quantize_act {total['quantize_ms']:.3f} ms "
                f"({100 * total['quantize_share']:.1f} % of {total['quantize_bound_ms']:.4f} ms); "
                f"plain {total['plain_ms']:.3f} ms; cuDNN bf16 conv {total['cudnn_bf16_ms']:.3f} "
                f"ms; torch._int_mm {total['library_ms']:.3f} ms")
    log(f"int8 kernels bit-identical to their plain versions: {len(shapes)} shapes x batches "
        f"{list(batches)} (quantize_act on bf16 and float32; accumulators and bf16 output)")
    return {"cases": cases, "sums": sums, "max_abs_err": 0.0}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", default="1,32")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="", help="write every case to this JSON file")
    args = parser.parse_args(argv)
    dev = need_cuda("int8_bench")
    torch.backends.cudnn.allow_tf32 = False

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.QUANT = "int8"
    det = ObjectDetector(cfg, device=dev)
    shapes = model_shapes(det.model, det.img_hw, dev) + list(EXTRA_SHAPES)
    print(f"{card_line()}; SSD300-VGG16 int8 convs {len(shapes) - len(EXTRA_SHAPES)} "
          f"+ {len(EXTRA_SHAPES)} extra shapes")
    out = run(shapes, tuple(int(b) for b in args.batches.split(",")), args.seed)
    for key, case in out["cases"].items():
        print(f"{key}: int8_conv {case['kernel_ms']:.4f} ms (wgmma N {case['bn']}, "
              f"{case['vec']}-byte copies; {100 * case['share']:.1f} % of its bound "
              f"{case['bound_ms']:.4f} ms, {case['bound_by']}), cuDNN bf16 "
              f"{case['cudnn_bf16_ms']:.4f} ms, torch._int_mm {case['library_ms']:.4f} ms, plain "
              f"{case['plain_ms']:.3f} ms; quantize_act {case['quantize_ms']:.4f} ms "
              f"({100 * case['quantize_share']:.1f} % of {case['quantize_bound_ms']:.4f} ms)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), **out}, f, indent=1)


if __name__ == "__main__":
    main()
