"""Time the hand-written 3x3 stem conv kernel against cuDNN on an NVIDIA GPU.

    python -m ssds_tpu_torch.tools.conv_bench [batch] [tile]

The counterpart of ``tools/pallas_conv_bench.py``: the VGG stem's 3x3 SAME
conv, x ``[batch, 300, 300, 64]`` bf16 NHWC and w ``[3, 3, 64, 64]`` HWIO,
drawn from ``numpy.random.default_rng(0)`` as that tool draws them. It times
cuDNN (``F.conv2d`` in bf16, channels-last: the counterpart of ``xla_conv``)
and the float32 plain version (TF32 off), then sweeps the kernel's
configurations (``tile`` = ``NxROWSxRINGxWGS``: strip width, rows per work
item, ring slots, consumer warpgroups; all of
``ssds_tpu_torch.ops.cuda.conv.TILES`` by default) in place of the TPU tool's
row-tile list. Each line gives the time (CUDA events), TFLOP/s and ``maxerr``
against the plain version. Any failure, including a kernel outside the
tolerance of ``ssds_tpu_torch.ops.conv``, exits non-zero.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ssds_tpu_torch.ops.conv import ATOL, RTOL, conv3x3_rows_torch
from ssds_tpu_torch.ops.cuda.conv import TILES, Tile, conv3x3_rows
from ssds_tpu_torch.tools import card_line, need_cuda, roofline_ms, time_cuda

H = W = 300
CIN = COUT = 64


def tile_name(tile) -> str:
    return "x".join(str(v) for v in tile)


def compare(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, differing elements); raises outside the tolerance."""
    diff = (got.float() - ref.float()).abs()
    torch.testing.assert_close(got.float(), ref.float(), rtol=RTOL, atol=ATOL)
    return diff.max().item(), int((diff > 0).sum().item())


def run(batch: int = 32, tiles=TILES, iters: int = 20, seed: int = 0, log=print) -> dict:
    """Check and time every tile; returns every number it printed."""
    dev = need_cuda("conv_bench")
    card = card_line()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (batch, H, W, CIN)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, (3, 3, CIN, COUT)).astype(np.float32))
    x, w = x.to(dev).to(torch.bfloat16), w.to(dev).to(torch.bfloat16)
    flop = 2 * batch * H * W * 9 * CIN * COUT
    bound_ms, bound_by = roofline_ms(flop, 2 * (x.numel() + w.numel() + batch * H * W * COUT))
    log(f"conv_bench: x {list(x.shape)} bf16 NHWC, w {list(w.shape)} HWIO, "
        f"{flop / 1e9:.1f} GFLOP per call ({card})")

    ref = conv3x3_rows_torch(x, w)  # float32 sums, rounded once
    xc = x.permute(0, 3, 1, 2)      # NCHW view of NHWC memory: channels-last
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def cudnn():
        return F.conv2d(xc, wc, padding=1)

    def plain():
        return conv3x3_rows_torch(x, w)

    cudnn_err = (cudnn().permute(0, 2, 3, 1).float() - ref.float()).abs().max().item()
    result = {"card": card, "shape": list(x.shape), "gflop": flop / 1e9, "tiles": {},
              "cudnn_max_abs_err": cudnn_err, "bound_ms": bound_ms, "bound_by": bound_by}
    for tile in tiles:
        err, ndiff = compare(conv3x3_rows(x, w, tile), ref)
        result["tiles"][tile_name(tile)] = {"max_abs_err": err, "n_diff": ndiff, "ms": []}

    # cuDNN, plain, every tile, every tile again in reverse, plain, cuDNN: a
    # drift of the card's clocks falls on all of them.
    result["cudnn_ms"] = [time_cuda(cudnn, iters)]
    result["plain_ms"] = [time_cuda(plain, max(iters // 4, 3))]
    for tile in (*tiles, *reversed(tiles)):
        result["tiles"][tile_name(tile)]["ms"].append(
            time_cuda(lambda: conv3x3_rows(x, w, tile), iters))
    result["plain_ms"].append(time_cuda(plain, max(iters // 4, 3)))
    result["cudnn_ms"].append(time_cuda(cudnn, iters))

    def line(name, times, err, extra=""):
        ms = min(times)
        log(f"{name:<34} fwd {ms:8.3f} ms {flop / ms / 1e9:7.1f} TFLOP/s   maxerr {err:.4f}{extra}"
            f"   (runs {' / '.join(f'{t:.3f}' for t in times)} ms)")

    line("cudnn bf16 channels-last", result["cudnn_ms"], cudnn_err)
    line("plain float32 (TF32 off)", result["plain_ms"], 0.0)
    for name, t in result["tiles"].items():
        line(f"cuda tile={name}", t["ms"], t["max_abs_err"], f"  differing {t['n_diff']}")
    log(f"bound {bound_ms:.4f} ms ({bound_by}: {flop / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, "
        f"x, w and the output once at 3.35 TB/s)")
    log(f"({card})")
    return result


def parse_tile(text: str) -> Tile:
    return Tile(*(int(v) for v in text.split("x")))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=32)
    parser.add_argument("tile", nargs="?", type=parse_tile, default=None,
                        help="NxROWSxRINGxWGS: one configuration instead of the sweep")
    args = parser.parse_args(argv)
    run(args.batch, TILES if args.tile is None else (args.tile,))


if __name__ == "__main__":
    main()
