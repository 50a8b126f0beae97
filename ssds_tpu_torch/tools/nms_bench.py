"""Time the NMS kernel beside its bound and its plain version.

    python -m ssds_tpu_torch.tools.nms_bench [--iters 200] [--seed 0]

At the shapes of the main paths (:data:`SHAPES`: SSD300's 21 class slots of
200 candidates at serving batch 1 and 32, and at the eval batch of 64 of
training) and IoU threshold 0.6, on seeded candidate
sets (:func:`nms_case`; "full" has every candidate valid, as serving fills
every slot, "random" has an invalid tail in each slot), it prints for the
kernel (:func:`ssds_tpu_torch.ops.cuda.nms.nms_mask`):

- its device time: launches queued behind a sleep kernel, so the CUDA events
  see the kernels back to back (``tools.time_cuda_queued``);
- the wrapper's time with the host in it: back-to-back calls, as a caller
  sees them (``tools.time_cuda``), and its host microseconds a call
  (``tools.host_us``);
- the plain version's time (``ops.nms.nms_mask_torch``);
- the bound (:func:`nms_bound`): the larger of the float32 operations this
  input needs at 67 TFLOP/s and its bytes at 3.35 TB/s.

``kernel_ms`` is device time alone; ``wrapper_ms`` is the number to set
beside ``conv_bench``'s and ``conv_probes``' kernel times, which are
back-to-back calls too. A kernel mask that differs from the plain version's
exits non-zero.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ssds_tpu_torch.ops.cuda.nms import nms_mask
from ssds_tpu_torch.ops.nms import NEG_INF, nms_mask_torch
from ssds_tpu_torch.tools import (F32_OPS_S, card_line, host_us, need_cuda, roofline_ms,
                                  time_cuda, time_cuda_queued)

# [21 x batch, top_k]: serving at batch 1 and 32, the eval of training at TEST.BATCH_SIZE 64
SHAPES = ((21, 200), (672, 200), (1344, 200))
SETS = ("full", "random")
THRESHOLD = 0.6
# float32 operations of one IoU test in jaccard's form: 2 min, 2 max, 2 sub,
# 2 clamps, the product, the area sum, the union, the division, the compare
OPS_PER_TEST = 13
OPS_PER_AREA = 5  # 2 sub, 2 clamps, the product


def nms_case(rng, m, n, kind):
    """``[m, n]`` score-descending slots with zero-area boxes. "full": every
    candidate valid; otherwise an invalid tail in each slot and one
    all-invalid slot (when m > 1); "dense_overlap" draws larger boxes and
    "tied_scores" quantises the scores."""
    cxcy = rng.uniform(0.2, 0.8, (m, n, 2))
    lo, hi = (0.3, 0.5) if kind == "dense_overlap" else (0.05, 0.4)
    wh = rng.uniform(lo, hi, (m, n, 2))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1).astype(np.float32)
    boxes[:, ::7, 2:] = boxes[:, ::7, :2]  # zero area
    raw = rng.uniform(0.01, 1.0, (m, n))
    if kind == "tied_scores":
        raw = np.round(raw * 6) / 6 + 0.01
    scores = -np.sort(-raw.astype(np.float32), axis=-1, kind="stable")
    if kind != "full":
        for i in range(m):
            scores[i, rng.integers(n // 2, n + 1):] = NEG_INF
        if m > 1:
            scores[1] = NEG_INF
    return torch.from_numpy(boxes), torch.from_numpy(np.ascontiguousarray(scores))


def nms_bound(scores: torch.Tensor) -> dict:
    """The least time the card could take for this input: every IoU test
    between two valid candidates of a slot (``v (v - 1) / 2``) and every area
    at the float32 peak, against each input byte read once and each keep byte
    written once at the HBM rate."""
    m, n = scores.shape
    v = (scores > NEG_INF / 2).sum(1).double()
    ops = float(OPS_PER_TEST * (v * (v - 1) / 2).sum().item() + OPS_PER_AREA * m * n)
    nbytes = m * n * (16 + 4 + 1)
    ms, by = roofline_ms(ops, nbytes, F32_OPS_S)
    return {"ops": ops, "bytes": nbytes, "ms": ms, "by": by}


def run(shapes=SHAPES, sets=SETS, iters: int = 200, seed: int = 0, log=print) -> dict:
    """Check and time the kernel at every shape and set; returns every number printed."""
    dev = need_cuda("nms_bench")
    card = card_line()
    result, failed = {"card": card, "threshold": THRESHOLD, "cases": {}}, []
    for m, n in shapes:
        for kind in sets:
            boxes, scores = nms_case(np.random.default_rng([seed, m, n]), m, n, kind)
            bc, sc = boxes.to(dev), scores.to(dev)
            want = nms_mask_torch(bc, sc, THRESHOLD)
            ok = torch.equal(nms_mask(bc, sc, THRESHOLD), want)
            bound = nms_bound(scores)
            kern = [time_cuda_queued(lambda: nms_mask(bc, sc, THRESHOLD), iters)]
            wrap = [time_cuda(lambda: nms_mask(bc, sc, THRESHOLD), iters)]
            plain = [time_cuda(lambda: nms_mask_torch(bc, sc, THRESHOLD), max(iters // 10, 3))]
            wrap.append(time_cuda(lambda: nms_mask(bc, sc, THRESHOLD), iters))
            kern.append(time_cuda_queued(lambda: nms_mask(bc, sc, THRESHOLD), iters))
            host = host_us(lambda: nms_mask(bc, sc, THRESHOLD))
            case = {"shape": [m, n], "set": kind, "bit_identical": ok, "kernel_ms": kern,
                    "wrapper_ms": wrap, "wrapper_host_us": host, "plain_ms": plain,
                    "bound": bound}
            log(f"nms [{m},{n}] {kind}: {'OK' if ok else 'FAIL'} (bit-identical to plain: {ok}); "
                f"kernel {min(kern):.4f} ms (device, {' / '.join(f'{t:.4f}' for t in kern)}), "
                f"wrapper {min(wrap):.4f} ms (host included; {host:.2f} host us a call), "
                f"plain {plain[0]:.4f} ms, bound "
                f"{bound['ms'] * 1e3:.3f} us ({bound['by']}: {bound['ops'] / 1e6:.2f} MFLOP, "
                f"{bound['bytes'] / 1e6:.3f} MB) ({card})")
            if not ok:
                failed.append(f"{m}x{n} {kind}")
            result["cases"][f"{m}x{n}/{kind}"] = case
    log(f"({card})")
    if failed:
        raise SystemExit(f"nms_bench: {len(failed)} case(s) not bit-identical: {failed}")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    run(iters=args.iters, seed=args.seed)


if __name__ == "__main__":
    main()
