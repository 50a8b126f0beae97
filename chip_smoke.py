#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and conv-prototype path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--report PATH]

Phases, each of which raises on failure (the script then exits non-zero):

1. inventory: torch, CUDA and the card (``nvidia-smi`` name and power limit);
   no GPU means no run;
2. build: ``ssds_tpu_torch/csrc/*.cu`` compiled with nvcc for sm_90a;
3. the NMS kernel against its plain PyTorch version, on the card and on the
   CPU, over the serving shapes and edge cases: masks must be bit-identical;
4. the slice: ``ObjectDetector`` on SSD300-VGG16 (VOC, 21 classes, 8732
   priors, bf16 as the default config says, seeded random weights) serves
   ``predict`` x3 and ``predict_batch`` at batch 4 and 32, with the kernel's
   launch count reset before and read after; then its detections are held
   against the same ``loc`` / ``conf`` through the plain NMS, and a float32
   forward on the card (TF32 off) against the CPU forward;
5. times: kernel and plain NMS at the serving shapes (CUDA events), batch-1
   ``predict`` latency and batch-32 ``predict_batch`` throughput;
6. the conv kernel (``conv3x3_rows``, every output tile of the sweep, and
   ``vconv3``) against its plain version on the card and on the CPU at small
   shapes with partial tiles in H, W and Cout and with Cin != Cout: within one
   bf16 ulp (rtol 2^-7, atol 1e-4);
7. the conv-prototype path, with the conv and stencil kernels' launch counts
   reset before and read after: ``ssds_tpu_torch.tools.conv_bench`` at
   ``[32, 300, 300, 64]`` (every tile held against the float32 plain version,
   then timed against cuDNN bf16 and the plain version in alternating turns)
   and ``ssds_tpu_torch.tools.conv_probes`` (the 17 stencil probes
   bit-identical to the plain version on the card and the CPU, the 2 dot
   probes within the conv tolerance, each timed against its plain version).

The line before the last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
NMS_SHAPES = [(21, 200), (84, 200), (672, 200), (5, 1), (3, 37), (9, 512)]  # M = 21 x batch
NMS_SETS = ["random", "dense_overlap", "tied_scores"]
THRESHOLDS = (0.45, 0.6)
SSD300_PRIORS = 8732
# float32 forward, card (cuDNN, TF32 off) against CPU: the same sums in other
# orders through the 15 VGG convs, the extras and the heads. Measured on an
# NVIDIA H100 80GB HBM3: 1.3e-5 on loc (max |loc| 4.5) and 5.1e-6 on conf.
F32_RTOL, F32_ATOL = 1e-4, 1e-4


# (B, H, W, Cin, Cout) for phase 6: partial tiles in H and W, Cin != Cout with
# a partial 64-channel output slice, and two output slices
CONV_SHAPES = [(2, 37, 45, 64, 64), (1, 19, 70, 32, 48), (1, 20, 40, 64, 128)]
VCONV_SHAPES = [(2, 39, 45, 64, 64), (1, 12, 20, 32, 48)]  # (B, H+2, W, C, Cout)


def log(*args):
    print(*args, flush=True)


def nms_case(rng, m, n, kind):
    """``[m, n]`` score-descending slots with an invalid tail, one all-invalid
    row (when m > 1) and zero-area boxes."""
    cxcy = rng.uniform(0.2, 0.8, (m, n, 2))
    lo, hi = (0.3, 0.5) if kind == "dense_overlap" else (0.05, 0.4)
    wh = rng.uniform(lo, hi, (m, n, 2))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1).astype(np.float32)
    boxes[:, ::7, 2:] = boxes[:, ::7, :2]  # zero area
    raw = rng.uniform(0.01, 1.0, (m, n))
    if kind == "tied_scores":
        raw = np.round(raw * 6) / 6 + 0.01
    scores = -np.sort(-raw.astype(np.float32), axis=-1, kind="stable")
    for i in range(m):
        scores[i, rng.integers(n // 2, n + 1):] = -1e30
    if m > 1:
        scores[1] = -1e30
    return torch.from_numpy(boxes), torch.from_numpy(np.ascontiguousarray(scores))


def check_nms_kernel(nms_mask, nms_mask_torch, seed):
    """Phase 3: kernel == plain on CUDA == plain on CPU, bit for bit."""
    cases, max_err = 0, 0.0
    for m, n in NMS_SHAPES:
        for kind in NMS_SETS:
            boxes, scores = nms_case(np.random.default_rng([seed, m, n, len(kind)]), m, n, kind)
            bc, sc = boxes.to(DEVICE), scores.to(DEVICE)
            for thr in THRESHOLDS:
                got = nms_mask(bc, sc, thr)
                torch.cuda.synchronize()
                plain_gpu = nms_mask_torch(bc, sc, thr).cpu()
                plain_cpu = nms_mask_torch(boxes, scores, thr)
                got = got.cpu()
                err = max((got.float() - plain_gpu.float()).abs().max().item(),
                          (got.float() - plain_cpu.float()).abs().max().item())
                max_err = max(max_err, err)
                if not (torch.equal(got, plain_gpu) and torch.equal(got, plain_cpu)):
                    bad = (got != plain_cpu).nonzero()[:5].tolist()
                    raise AssertionError(f"nms kernel != plain at [{m},{n}] {kind} thr={thr}: "
                                         f"first differing (slot, cand) {bad}")
                cases += 1
    log(f"nms kernel: {cases} cases bit-identical to the plain version on CUDA and CPU "
        f"(shapes {NMS_SHAPES}, sets {NMS_SETS}, thresholds {THRESHOLDS}, "
        "all-invalid rows and zero-area boxes in every set)")
    return max_err


def check_conv_kernel(seed):
    """Phase 6: conv kernel within one bf16 ulp of the plain version on CUDA and CPU."""
    from ssds_tpu_torch.ops.conv import ATOL, RTOL, conv3x3_rows_torch, vconv3_torch
    from ssds_tpu_torch.ops.cuda.conv import TILES, conv3x3_rows, vconv3

    def bf16(rng, shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(torch.bfloat16)

    def within(got, plain, what):
        err = max((got.float() - p.float()).abs().max().item() for p in plain)
        for p in plain:
            torch.testing.assert_close(got.float(), p.float(), rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{what}: {m}")
        return err

    max_err, cases = 0.0, 0
    for b, h, w, cin, cout in CONV_SHAPES:
        rng = np.random.default_rng([seed, h, w, cin, cout])
        x, wt = bf16(rng, (b, h, w, cin)), bf16(rng, (3, 3, cin, cout), 0.05)
        xc, wc = x.to(DEVICE), wt.to(DEVICE)
        plain = (conv3x3_rows_torch(xc, wc).cpu(), conv3x3_rows_torch(x, wt))
        for tile in TILES:
            got = conv3x3_rows(xc, wc, tile).cpu()
            max_err = max(max_err, within(got, plain, f"conv3x3_rows {[b, h, w, cin, cout]} "
                                                      f"tile {tile}"))
            cases += 1
    for b, h2, w, c, cout in VCONV_SHAPES:
        rng = np.random.default_rng([seed, h2, w, c, cout])
        xp, wd0 = bf16(rng, (b, h2, w, c)), bf16(rng, (3 * c, cout), 0.05)
        got = vconv3(xp.to(DEVICE), wd0.to(DEVICE)).cpu()
        plain = (vconv3_torch(xp.to(DEVICE), wd0.to(DEVICE)).cpu(), vconv3_torch(xp, wd0))
        max_err = max(max_err, within(got, plain, f"vconv3 {[b, h2, w, c, cout]}"))
        cases += 1
    log(f"conv kernel: {cases} cases within one bf16 ulp (rtol 2^-7, atol 1e-4) of the plain "
        f"version on CUDA and CPU, max |d| {max_err:.3e} (conv3x3_rows {CONV_SHAPES} x tiles "
        f"{list(TILES)}; vconv3 {VCONV_SHAPES})")
    return max_err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="weights, images and NMS sets")
    parser.add_argument("--report", default="",
                        help="also write every number of the run to this JSON file")
    args = parser.parse_args(argv)

    # -- 1. inventory ---------------------------------------------------------
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this script needs a GPU")
    from ssds_tpu_torch.tools import card_line, time_cuda

    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"device: {kind} x{count}; nvidia-smi name, power.limit: {card}")
    # Every float32 comparison below runs in full float32: cuDNN's TF32 default is off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN and matmul (float32 comparisons are in full float32)")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)

    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.detector import ObjectDetector
    from ssds_tpu_torch.ops import postprocess
    from ssds_tpu_torch.ops.cuda import _build
    from ssds_tpu_torch.ops.cuda.nms import nms_mask
    from ssds_tpu_torch.ops.nms import nms_mask_torch

    report = {"card": card, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {os.path.relpath(_build.build_info['path'], REPO)} in {report['build_s']:.2f} s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)")
    log(_build.build_info.get("ptxas", "(library was already built: no ptxas report)"))

    # -- 3. kernel against its plain version -----------------------------------
    nms_err = check_nms_kernel(nms_mask, nms_mask_torch, args.seed)

    # -- 4. the slice serving requests -----------------------------------------
    cfg = default_config()  # SSD300-VGG16, VOC, bf16 forward
    det = ObjectDetector(cfg, device=dev, seed=args.seed)
    assert det.priors.shape == (SSD300_PRIORS, 4) and det.dtype == torch.bfloat16
    hw = det.img_hw
    rng = np.random.default_rng(args.seed)
    singles = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(3)]
    batch4 = list(rng.integers(0, 256, (4, *hw, 3), dtype=np.uint8))
    batch32 = list(rng.integers(0, 256, (32, *hw, 3), dtype=np.uint8))

    nms_mask.launches = 0
    served = [det.predict(img, threshold=0.01) for img in singles]
    served4 = det.predict_batch(batch4, threshold=0.01)
    served32 = det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    launches = nms_mask.launches
    log(f"served: predict x3, predict_batch x4, predict_batch x32; nms kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the serving path never launched the NMS kernel")
    for boxes, labels, scores in served + served4 + served32:
        assert boxes.ndim == 2 and boxes.shape[1] == 4 and len(labels) == len(scores) == len(boxes)
        assert np.isfinite(boxes).all() and np.isfinite(scores).all()
        assert ((labels >= 0) & (labels < 20)).all()
    log(f"detections per image (threshold 0.01): batch 1 {[len(s[2]) for s in served]}, "
        f"batch 4 {[len(s[2]) for s in served4]}, batch 32 min/max "
        f"{min(len(s[2]) for s in served32)}/{max(len(s[2]) for s in served32)}")

    # the same loc / conf through detect with the kernel and with the plain NMS
    for name, imgs in (("batch 1", singles[:1]), ("batch 32", batch32)):
        x = torch.from_numpy(np.stack(imgs)).to(dev)
        with torch.no_grad():
            loc, conf = det.forward(x)
            rows = postprocess.detect(loc, conf, det.priors, det.post)
            with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                plain_rows = postprocess.detect(loc, conf, det.priors, det.post)
        assert rows.shape == (len(imgs), 21, 100, 5) and torch.isfinite(rows).all()
        if not torch.equal(rows, plain_rows):
            raise AssertionError(f"{name}: detect rows with the kernel != with the plain NMS")
        filled = (rows[..., 0] > 0).sum(-1)[:, 1:]
        log(f"{name}: detect rows identical with kernel and plain NMS; "
            f"kept per class slot min/max {filled.min().item()}/{filled.max().item()}")

    # float32 forward on the card against the CPU
    cfg32 = default_config()
    cfg32.MODEL.HALF_PRECISION = False
    x = torch.from_numpy(np.stack(singles[:2]))
    with torch.no_grad():
        det32 = ObjectDetector(cfg32, device=dev, seed=args.seed)
        gpu_loc, gpu_conf = (a.cpu() for a in det32.forward(x.to(dev)))
        del det32
        cpu_loc, cpu_conf = ObjectDetector(cfg32, device="cpu", seed=args.seed).forward(x)
    loc_err = (gpu_loc - cpu_loc).abs().max().item()
    conf_err = (gpu_conf - cpu_conf).abs().max().item()
    log(f"float32 forward, card vs CPU: loc max|d| {loc_err:.3e} (max|loc| "
        f"{cpu_loc.abs().max().item():.3e}), conf max|d| {conf_err:.3e}")
    torch.testing.assert_close(gpu_loc, cpu_loc, rtol=F32_RTOL, atol=F32_ATOL)
    torch.testing.assert_close(gpu_conf, cpu_conf, rtol=F32_RTOL, atol=F32_ATOL)
    report.update(f32_loc_max_abs_err=loc_err, f32_conf_max_abs_err=conf_err)

    # -- 5. times ---------------------------------------------------------------
    nms_times = {}
    for m, n in ((21, 200), (672, 200)):
        boxes, scores = nms_case(np.random.default_rng(m), m, n, "random")
        bc, sc = boxes.to(dev), scores.to(dev)
        # plain, kernel, kernel, plain: a drift of the card's clocks falls on both
        plain_a = time_cuda(lambda: nms_mask_torch(bc, sc, 0.6), 20)
        kern_a = time_cuda(lambda: nms_mask(bc, sc, 0.6), 200)
        kern_b = time_cuda(lambda: nms_mask(bc, sc, 0.6), 200)
        plain_b = time_cuda(lambda: nms_mask_torch(bc, sc, 0.6), 20)
        nms_times[(m, n)] = (min(kern_a, kern_b), min(plain_a, plain_b))
        log(f"nms [{m},{n}]: kernel {kern_a:.4f} / {kern_b:.4f} ms, plain "
            f"{plain_a:.4f} / {plain_b:.4f} ms ({card})")
        report[f"nms_{m}x{n}"] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b]}

    img = singles[0]
    for _ in range(10):
        det.predict(img, threshold=0.01)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        det.predict(img, threshold=0.01)  # synchronises before its device-to-host copy
        lat.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lat, 50)) * 1e3
    for _ in range(2):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        det.predict_batch(batch32, threshold=0.01)
    torch.cuda.synchronize()
    ips = reps * 32 / (time.perf_counter() - t0)
    log(f"serving SSD300-VGG16 bf16: batch-1 predict p50 {p50:.3f} ms "
        f"(p90 {float(np.percentile(lat, 90)) * 1e3:.3f} ms, 50 requests); batch-32 "
        f"predict_batch {ips:.1f} img/s ({reps} batches) ({card})")
    report.update(predict_b1_p50_ms=p50, predict_b1_lat_ms=[t * 1e3 for t in lat],
                  predict_batch32_img_s=ips, nms_launches_main_path=launches,
                  nms_max_abs_err=nms_err)

    # -- 6. the conv kernel against its plain version ------------------------
    conv_err = check_conv_kernel(args.seed)

    # -- 7. the conv-prototype path ------------------------------------------
    from ssds_tpu_torch.ops.cuda import conv as cuda_conv
    from ssds_tpu_torch.ops.cuda.stencil import row_stencil
    from ssds_tpu_torch.ops.stencil import PROBES
    from ssds_tpu_torch.tools import conv_bench, conv_probes

    cuda_conv.conv3x3_rows.launches = cuda_conv.vconv3.launches = row_stencil.launches = 0
    bench = conv_bench.run(batch=32, seed=args.seed, log=log)
    probes = conv_probes.run(seed=args.seed, log=log)
    torch.cuda.synchronize()
    conv_launches = {"conv3x3_rows": cuda_conv.conv3x3_rows.launches,
                     "vconv3": cuda_conv.vconv3.launches}
    stencil_launches = row_stencil.launches
    log(f"conv-prototype path: conv kernel launches {conv_launches}, stencil kernel launches "
        f"{stencil_launches}")
    if min(conv_launches.values()) <= 0 or stencil_launches <= 0:
        raise AssertionError("the conv-prototype path never launched one of its kernels")
    report.update(conv_kernel_max_abs_err=conv_err, conv_bench=bench, conv_probes=probes,
                  conv_launches_main_path=conv_launches,
                  stencil_launches_main_path=stencil_launches)
    if args.report:
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)

    kern_ms, plain_ms = nms_times[(672, 200)]
    default_tile = conv_bench.tile_name(cuda_conv.TILES[0])
    halo = probes["probes"]["elem_halo"]
    log(json.dumps({"kernels": [{
        "name": "nms_mask", "route": "cuda", "source": "ssds_tpu_torch/csrc/nms.cu",
        "replaces": "ssds_tpu/ops/pallas/nms.py:55", "launches": launches,
        "max_abs_err": nms_err, "ms": kern_ms, "plain_ms": plain_ms, "shape": [672, 200],
    }, {
        "name": "conv3x3_rows", "route": "cuda", "source": "ssds_tpu_torch/csrc/conv3x3.cu",
        "replaces": "tools/pallas_conv_bench.py:50; tools/pallas_conv_bisect.py:71; "
                    "tools/pallas_conv_bisect.py:80",
        "launches": sum(conv_launches.values()), "launches_by_wrapper": conv_launches,
        "max_abs_err": max([conv_err, *(t["max_abs_err"] for t in bench["tiles"].values()),
                            probes["probes"]["dot"]["max_abs_diff"],
                            probes["probes"]["dot3d"]["max_abs_diff"]]),
        "ms": min(bench["tiles"][default_tile]["ms"]), "plain_ms": min(bench["plain_ms"]),
        "cudnn_ms": min(bench["cudnn_ms"]), "tile": default_tile, "shape": bench["shape"],
    }, {
        "name": "row_stencil", "route": "cuda", "source": "ssds_tpu_torch/csrc/stencil.cu",
        "replaces": "; ".join(p.source for p in PROBES.values()), "launches": stencil_launches,
        "max_abs_err": max(probes["probes"][n]["max_abs_diff"] for n in PROBES),
        "ms": halo["kernel_ms"], "plain_ms": halo["plain_ms"], "shape": halo["shape"],
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
