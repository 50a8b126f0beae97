"""The int8 serving kernels on the card: ``quantize_act`` and ``int8_conv``
(``csrc/int8_conv.cu``) held bit-identical to their plain versions
(:mod:`ssds_tpu_torch.ops.quant`) and timed beside their bounds, their plain
versions and cuDNN's bf16 convolution of the same shape.

    python -m ssds_tpu_torch.tools.int8_bench [--batches 1,32] [--seed 0] [--out PATH]

The shapes are every quantised conv of SSD300-VGG16 (``MODEL.QUANT: int8``
over the default config, found by running its quantised model once) plus a
3x3 stride-2 and a 1x1 conv of MobileNetV2-300 and of DarkNet-53-416
(:data:`EXTRA_SHAPES`). At each batch and shape: ``quantize_act`` on the
bf16 and the float32 input and ``int8_conv``'s int32 accumulators and its bf16
output must equal the plain versions bit for bit (the plain conv runs in
float64 on the card with cuDNN off, exact for integers). Times are CUDA
events over back-to-back launches. A conv's bound is the larger of its
int8 operations at the dense int8 tensor-core peak and its bytes (the int8
input read once, the weights, the bf16 output written once) at the HBM rate;
``quantize_act``'s is its bytes; a batch's sums count all the shapes'
operations and bytes as one piece of work.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ssds_tpu_torch.tools import card_line, need_cuda, roofline_ms, time_cuda

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


def quantize_bytes(shape: ConvShape, batch: int) -> int:
    """``quantize_act``'s bytes: the bf16 input read, the padded int8 written."""
    from ssds_tpu_torch.ops.quant import padded_channels

    return batch * shape.hw[0] * shape.hw[1] * (2 * shape.cin + padded_channels(shape.cin))


ITERS = 10  # timed launches a case (the plain conv: 2)


def run(shapes: Sequence[ConvShape], batches=(1, 32), seed: int = 0, log=print,
        time_it: bool = True) -> dict:
    """Check every shape at every batch and, with ``time_it``, time it.
    Returns ``{"cases": {"<name>/b<batch>": {...}}, "max_abs_err": 0.0,
    per-batch sums}``; raises on the first mismatch."""
    from ssds_tpu_torch.ops.cuda.int8_conv import int8_conv, quantize_act
    from ssds_tpu_torch.ops.quant import dequant_torch, int8_conv_torch, quantize_act_torch

    dev = need_cuda("int8_bench")
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    cases, sums = {}, {}
    for batch in batches:
        total = {"kernel_ms": 0.0, "quantize_ms": 0.0, "plain_ms": 0.0, "plain_quantize_ms": 0.0,
                 "cudnn_bf16_ms": 0.0}
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
            case = {"shape": [batch, shape.cin, *shape.hw], "cout": shape.cout,
                    "kernel": list(shape.kernel), "stride": list(shape.stride),
                    "dilation": list(shape.dilation)}
            work = conv_work(shape, batch)
            case["bound_ms"], case["bound_by"] = roofline_ms(*work, INT8_OPS_S)
            qbytes = quantize_bytes(shape, batch)
            case["quantize_bound_ms"], _ = roofline_ms(0.0, qbytes)
            ops, nbytes, qbytes_all = ops + work[0], nbytes + work[1], qbytes_all + qbytes
            if time_it:
                wb = (torch.randn((shape.cout, shape.cin, *shape.kernel), generator=gen) * 0.05
                      ).to(dev, torch.bfloat16)
                bb = None if bias is None else bias.to(torch.bfloat16)
                case["kernel_ms"] = time_cuda(lambda: int8_conv(
                    xq, wq, act, w_scale, bias, *args, shape.relu, torch.bfloat16), ITERS)
                case["quantize_ms"] = time_cuda(lambda: quantize_act(xb, act), ITERS)
                case["plain_ms"] = time_cuda(lambda: dequant_torch(
                    int8_conv_torch(xq, wq, *args), act, w_scale, bias, shape.relu,
                    torch.bfloat16), 2, warmup=1)
                case["plain_quantize_ms"] = time_cuda(lambda: quantize_act_torch(xb, act), ITERS)
                case["cudnn_bf16_ms"] = time_cuda(lambda: F.conv2d(
                    xb, wb, bb, shape.stride, shape.padding, shape.dilation), ITERS)
            for key in total:
                total[key] += case.get(key, 0.0)
            cases[f"{shape.name}/b{batch}"] = case
            del x, xb, xq, acc, want_acc, y, want_y
        # the whole set as one piece of work: its operations and its bytes
        total["bound_ms"], total["bound_by"] = roofline_ms(ops, nbytes, INT8_OPS_S)
        total["quantize_bound_ms"], _ = roofline_ms(0.0, qbytes_all)
        sums[f"b{batch}"] = total
        if time_it:
            log(f"int8 convs at batch {batch} ({len(shapes)} shapes): int8_conv "
                f"{total['kernel_ms']:.3f} ms + quantize_act {total['quantize_ms']:.3f} ms "
                f"(bounds {total['bound_ms']:.3f} / {total['quantize_bound_ms']:.4f} ms); plain "
                f"{total['plain_ms']:.3f} ms; cuDNN bf16 conv {total['cudnn_bf16_ms']:.3f} ms")
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
        print(f"{key}: int8_conv {case['kernel_ms']:.4f} ms, cuDNN bf16 {case['cudnn_bf16_ms']:.4f} "
              f"ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}), plain "
              f"{case['plain_ms']:.3f} ms; quantize_act {case['quantize_ms']:.4f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), **out}, f, indent=1)


if __name__ == "__main__":
    main()
