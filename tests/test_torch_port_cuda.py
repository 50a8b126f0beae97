"""The port's CUDA kernels on the card (marker ``cuda``; they skip without a GPU).

This file imports torch, numpy and the port only, so it runs on a machine
without JAX; there, skip ``tests/conftest.py`` (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Keep masks are compared EXACTLY with the plain version: the kernel computes
each IoU with the same float32 operations in the same order, built with
``-fmad=false``, so there is no tolerance to state. So are the stencil
kernel's sums: the same bf16 adds in the same order. The conv kernel and its
plain version sum float32 products in different orders and round once to
bf16: within one bf16 ulp (``ssds_tpu_torch.ops.conv.RTOL, ATOL``).
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.ops import postprocess
from ssds_tpu_torch.ops.conv import ATOL, RTOL, conv3x3_rows_torch, vconv3_torch
from ssds_tpu_torch.ops.cuda import conv as cuda_conv
from ssds_tpu_torch.ops.cuda import nms as cuda_nms
from ssds_tpu_torch.ops.cuda import stencil as cuda_stencil
from ssds_tpu_torch.ops.nms import NEG_INF, nms_mask_torch
from ssds_tpu_torch.ops.stencil import PROBES, row_stencil_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: see this file's docstring)")
    torch.backends.cudnn.allow_tf32 = False  # float32 comparisons in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sorted_set(rng, m, n, lo=0.05, hi=0.4, levels=0):
    cxcy = rng.uniform(0.2, 0.8, (m, n, 2))
    wh = rng.uniform(lo, hi, (m, n, 2))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1).astype(np.float32)
    boxes[:, ::5, 2:] = boxes[:, ::5, :2]  # zero-area boxes
    raw = rng.uniform(0.01, 1.0, (m, n))
    if levels:
        raw = np.round(raw * levels) / levels + 0.01
    scores = -np.sort(-raw.astype(np.float32), axis=-1, kind="stable")
    for i in range(m):
        scores[i, rng.integers(n // 2, n + 1):] = NEG_INF
    scores[m // 2] = NEG_INF  # an all-invalid slot
    return torch.from_numpy(boxes), torch.from_numpy(np.ascontiguousarray(scores))


@pytest.mark.parametrize("kind", ["random", "dense_overlap", "tied_scores"])
@pytest.mark.parametrize("m,n", [(21, 200), (672, 200), (5, 1), (3, 37), (9, 512), (1, 200),
                                 (673, 200), (300, 512)])
def test_kernel_bit_identical_to_plain(cuda, m, n, kind):
    rng = np.random.default_rng(m * 1000 + n)
    boxes, scores = _sorted_set(rng, m, n, *((0.3, 0.5) if kind == "dense_overlap" else ()),
                                levels=6 if kind == "tied_scores" else 0)
    bc, sc = boxes.to(cuda), scores.to(cuda)
    for thr in (0.45, 0.6):
        before = cuda_nms.nms_mask.launches
        got = cuda_nms.nms_mask(bc, sc, thr)
        assert cuda_nms.nms_mask.launches == before + 1
        assert got.dtype == torch.bool and got.device.type == "cuda"
        got = got.cpu()
        assert torch.equal(got, nms_mask_torch(bc, sc, thr).cpu())
        assert torch.equal(got, nms_mask_torch(boxes, scores, thr))
        assert not got[m // 2].any()


# (M, N) in each regime of the launch plan: one slot, batch 1 and batch 4 (a
# cluster of 2 blocks a slot); a block a slot; several
# slots a block, two blocks an SM (batch 32); a ragged last block; N = 512
# in a cluster, with two slots a block (84 KB of dynamic shared memory) and
# five, one block an SM (211 KB)
PLAN_REGIMES = [(1, 200), (21, 200), (84, 200), (200, 200), (672, 200), (673, 200), (9, 512),
                (300, 512), (672, 512)]


@pytest.mark.parametrize("m,n", PLAN_REGIMES, ids=str)
def test_kernel_in_every_launch_plan_regime(cuda, m, n):
    """Every candidate valid, as in serving: the most work the kernel does."""
    rng = np.random.default_rng([m, n])
    boxes, scores = _sorted_set(rng, m, n)
    scores = torch.from_numpy(-np.sort(-rng.uniform(0.01, 1.0, (m, n)).astype(np.float32), -1))
    plan = cuda_nms.launch_plan(m, n, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.slots > 1 or m <= 264
    assert plan.cluster > 1 or m > 132
    bc, sc = boxes.to(cuda), scores.to(cuda)
    for thr in (0.45, 0.6):
        before = cuda_nms.nms_mask.launches
        got = cuda_nms.nms_mask(bc, sc, thr)
        torch.cuda.synchronize()
        assert cuda_nms.nms_mask.launches == before + 1
        assert torch.equal(got.cpu(), nms_mask_torch(boxes, scores, thr))


def test_launch_plan_mirror_equals_the_kernels(cuda):
    """ops/cuda/nms.py::launch_plan against csrc/nms.cu's plan."""
    import ctypes

    from ssds_tpu_torch.ops.cuda import _build

    lib, out = _build.load(), (ctypes.c_int * 5)()
    for sms in (132, 114, 1):
        for m in (1, 5, 21, 84, 132, 133, 264, 672, 673, 2000):
            for n in (1, 31, 32, 33, 64, 200, 300, 511, 512):
                lib.ssds_nms_plan(m, n, sms, out)
                assert tuple(out) == tuple(cuda_nms.launch_plan(m, n, sms)), (m, n, sms)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    boxes, scores = (t.to(cuda) for t in _sorted_set(np.random.default_rng(0), 4, 16))
    with pytest.raises(TypeError):
        cuda_nms.nms_mask(boxes.double(), scores.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nms.nms_mask(boxes.transpose(0, 1).contiguous().transpose(0, 1), scores, 0.5)
    with pytest.raises(ValueError, match="<= 512"):
        cuda_nms.nms_mask(torch.zeros((1, 513, 4), device=cuda),
                          torch.zeros((1, 513), device=cuda), 0.5)
    with pytest.raises(ValueError):
        cuda_nms.nms_mask(boxes, scores.cpu(), 0.5)
    assert cuda_nms.nms_mask(boxes[:0], scores[:0], 0.5).shape == (0, 16)


@pytest.mark.parametrize("batch", [1, 4])
def test_detect_on_the_card_launches_the_kernel_and_equals_plain(cuda, batch):
    """Same loc / conf through detect with the kernel and with the plain NMS."""
    rng = np.random.default_rng(batch)
    k, c = 2000, 21
    xy = rng.uniform(0.0, 0.7, (k, 2))
    priors = np.concatenate([xy + 0.1, rng.uniform(0.05, 0.3, (k, 2))], 1).astype(np.float32)
    loc = torch.from_numpy(rng.normal(0, 1, (batch, k, 4)).astype(np.float32)).to(cuda)
    conf = torch.softmax(torch.from_numpy(rng.normal(0, 2, (batch, k, c)).astype(np.float32)),
                         -1).to(cuda)
    cfg = postprocess.PostProcessConfig(pre_nms_top_n=1024)
    before = cuda_nms.nms_mask.launches
    rows = postprocess.detect(loc, conf, torch.from_numpy(priors).to(cuda), cfg)
    assert cuda_nms.nms_mask.launches == before + 1
    with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
        plain = postprocess.detect(loc, conf, torch.from_numpy(priors).to(cuda), cfg)
    assert rows.shape == (batch, c, 100, 5)
    assert torch.equal(rows, plain)


def test_detector_serves_on_the_card(cuda):
    """A small SSD-VGG16 (64x64, float32) on the card: the kernel runs, and
    the forward agrees with the CPU's (atol 1e-4: cuDNN and the CPU sum the
    same products in other orders, TF32 off)."""
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    cfg.MODEL.HALF_PRECISION = False
    gpu, cpu = ObjectDetector(cfg, device=cuda), ObjectDetector(cfg, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    before = cuda_nms.nms_mask.launches
    out = gpu.predict_batch(list(imgs), threshold=0.01)
    assert cuda_nms.nms_mask.launches == before + 1
    assert len(out) == 4 and all(np.isfinite(b).all() for b, _, _ in out)
    x = torch.from_numpy(imgs)
    for g, c in zip(gpu.forward(x.to(cuda)), cpu.forward(x)):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", range(8))
def test_kernel_bit_identical_over_seeds_and_thresholds(cuda, seed):
    """Random shapes, box sizes and thresholds (0.0: any overlap suppresses)."""
    rng = np.random.default_rng(100 + seed)
    m, n = int(rng.integers(1, 300)), int(rng.integers(1, 513))
    boxes, scores = _sorted_set(rng, m, n, lo=0.05, hi=float(rng.uniform(0.1, 0.6)))
    thr = float(rng.choice([0.0, 0.3, 0.45, 0.5, 0.6, 0.99]))
    got = cuda_nms.nms_mask(boxes.to(cuda), scores.to(cuda), thr).cpu()
    assert torch.equal(got, nms_mask_torch(boxes, scores, thr))


# (B, H, W, Cin, Cout): partial strips in W, partial row chunks in H, Cin !=
# Cout, a partial and a second 64-channel output slice; W not a multiple of
# any strip (161, 310), H not a multiple of any chunk (31, 95), the narrowest
# channels the kernel takes (Cin 16, Cout 8), and more work items than the
# card has resident blocks (12 x 4 x 3 = 144 at 152 x 30, more at 15 rows)
CONV_SHAPES = [(2, 37, 45, 64, 64), (1, 19, 70, 32, 48), (3, 8, 33, 16, 16), (1, 20, 40, 64, 128),
               (3, 31, 161, 16, 8), (12, 95, 310, 64, 64)]


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(torch.bfloat16)


def _within_ulp(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tile", cuda_conv.TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_kernel_matches_plain(cuda, shape, tile):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x, wt = _bf16(rng, (b, h, w, cin)), _bf16(rng, (3, 3, cin, cout), 0.05)
    before = cuda_conv.conv3x3_rows.launches
    got = cuda_conv.conv3x3_rows(x.to(cuda), wt.to(cuda), tile)
    torch.cuda.synchronize()
    assert cuda_conv.conv3x3_rows.launches == before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == torch.bfloat16
    _within_ulp(got.cpu(), conv3x3_rows_torch(x.to(cuda), wt.to(cuda)).cpu())
    _within_ulp(got.cpu(), conv3x3_rows_torch(x, wt))


@pytest.mark.parametrize("tile", [(152, 7, 3, 2), (152, 30, 3, 1), (104, 1, 3, 2)],
                         ids=lambda t: "x".join(map(str, t)))
def test_conv_kernel_smallest_ring(cuda, tile):
    """Three ring slots, the fewest a row's taps need: a warpgroup releases the
    slots it skips before it waits for later ones, so neither deadlocks."""
    rng = np.random.default_rng(11)
    x, wt = _bf16(rng, (3, 61, 200, 64)), _bf16(rng, (3, 3, 64, 64), 0.05)
    got = cuda_conv.conv3x3_rows(x.to(cuda), wt.to(cuda), tile)
    torch.cuda.synchronize()
    _within_ulp(got.cpu(), conv3x3_rows_torch(x, wt))


@pytest.mark.parametrize("form,cin", [("conv3x3", 96), ("conv3x3", 80), ("vconv3", 96)],
                         ids=str)
def test_conv_kernel_widest_cin_that_fits(cuda, form, cin):
    """Cin past 64 runs the K loop's guarded steps, up to the widest Cin whose
    weights and ring fit a block: 3x3 with a ring of 3 slots, and vconv3 (the
    default configuration)."""
    rng = np.random.default_rng(cin)
    x = _bf16(rng, (2, 13, 150, cin))
    if form == "conv3x3":
        tile, kw = cuda_conv.Tile(104, 5, 3, 2), 3
        wt = _bf16(rng, (3, 3, cin, 24), 0.05)
        got, want = cuda_conv.conv3x3_rows(x.to(cuda), wt.to(cuda), tile), conv3x3_rows_torch(x, wt)
    else:
        tile, kw = cuda_conv.TILES[0], 1
        wd0 = _bf16(rng, (3 * cin, 24), 0.05)
        got, want = cuda_conv.vconv3(x.to(cuda), wd0.to(cuda)), vconv3_torch(x, wd0)
    torch.cuda.synchronize()
    _within_ulp(got.cpu(), want)
    if cin == 96:
        assert cuda_conv.smem_bytes(cin + 16, kw, tile) > cuda_conv.MAX_SMEM


def test_conv_kernel_matches_plain_at_the_stem_shape(cuda):
    rng = np.random.default_rng(0)
    x, wt = _bf16(rng, (32, 300, 300, 64)).to(cuda), _bf16(rng, (3, 3, 64, 64), 0.05).to(cuda)
    _within_ulp(cuda_conv.conv3x3_rows(x, wt), conv3x3_rows_torch(x, wt))


@pytest.mark.parametrize("shape", [(2, 39, 45, 64, 64), (1, 12, 20, 32, 48), (4, 302, 300, 64, 64)],
                         ids=str)
def test_vconv3_kernel_matches_plain(cuda, shape):
    b, h2, w, c, cout = shape
    rng = np.random.default_rng(sum(shape))
    xp, wd0 = _bf16(rng, (b, h2, w, c)), _bf16(rng, (3 * c, cout), 0.05)
    before = cuda_conv.vconv3.launches
    got = cuda_conv.vconv3(xp.to(cuda), wd0.to(cuda))
    torch.cuda.synchronize()
    assert cuda_conv.vconv3.launches == before + 1
    assert got.shape == (b, h2 - 2, w, cout)
    _within_ulp(got.cpu(), vconv3_torch(xp.to(cuda), wd0.to(cuda)).cpu())
    if b * h2 * w < 10000:
        _within_ulp(got.cpu(), vconv3_torch(xp, wd0))


def test_conv_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=cuda)
    wt = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Cin % 16"):
        cuda_conv.conv3x3_rows(x[..., :8].contiguous(), wt[:, :, :8].contiguous())
    with pytest.raises(ValueError, match="Cout % 8"):
        cuda_conv.conv3x3_rows(x, wt[..., :12].contiguous())
    with pytest.raises(TypeError):
        cuda_conv.conv3x3_rows(x.float(), wt.float())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv3x3_rows(x.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_conv.conv3x3_rows(torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda),
                               torch.zeros((3, 3, 128, 64), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):
        cuda_conv.conv3x3_rows(x, wt.cpu())
    with pytest.raises(ValueError, match="ring"):
        cuda_conv.conv3x3_rows(x, wt, (152, 30, 2, 2))
    with pytest.raises(ValueError, match="wgs"):
        cuda_conv.conv3x3_rows(x, wt, (96, 30, 5, 2))
    with pytest.raises(ValueError):
        cuda_conv.vconv3(x, wt.reshape(576, 64))


@pytest.mark.parametrize("name", list(PROBES))
def test_stencil_kernel_bit_identical_to_plain(cuda, name):
    probe = PROBES[name]
    x = _bf16(np.random.default_rng(0), probe.shape)
    args = (probe.terms, probe.out_rows, probe.out_cols, probe.wmode)
    before = cuda_stencil.row_stencil.launches
    got = cuda_stencil.row_stencil(x.to(cuda), *args)
    torch.cuda.synchronize()
    assert cuda_stencil.row_stencil.launches == before + 1
    got = got.cpu()
    assert got.shape == (probe.shape[0], probe.out_rows, probe.out_cols, probe.shape[3])
    assert torch.equal(got, row_stencil_torch(x.to(cuda), *args).cpu())
    assert torch.equal(got, row_stencil_torch(x, *args))


@pytest.mark.parametrize("n_terms", range(1, 9))
@pytest.mark.parametrize("wmode", ["valid", "zero", "wrap"])
def test_stencil_kernel_every_term_count_and_column_mode(cuda, wmode, n_terms):
    """1-8 seeded terms, C = 24 (three channel vectors a pixel), bit for bit."""
    rng = np.random.default_rng([n_terms, len(wmode)])
    b, h, w, c = 2, 9, 37, 24
    lo, hi = {"valid": (0, 3), "zero": (-3, 3), "wrap": (-40, 40)}[wmode]
    terms = [(int(rng.integers(0, 3)), int(rng.integers(lo, hi + 1))) for _ in range(n_terms)]
    out_rows, out_cols = h - 2, w - 3 if wmode == "valid" else w
    x = _bf16(rng, (b, h, w, c))
    before = cuda_stencil.row_stencil.launches
    got = cuda_stencil.row_stencil(x.to(cuda), terms, out_rows, out_cols, wmode)
    torch.cuda.synchronize()
    assert cuda_stencil.row_stencil.launches == before + 1
    assert torch.equal(got.cpu(), row_stencil_torch(x, terms, out_rows, out_cols, wmode))


def test_stencil_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 4, 6, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="C % 8"):
        cuda_stencil.row_stencil(x[..., :4].contiguous(), ((0, 0),), 4, 6)
    with pytest.raises(TypeError):
        cuda_stencil.row_stencil(x.float(), ((0, 0),), 4, 6)
    with pytest.raises(ValueError, match="terms"):
        cuda_stencil.row_stencil(x, ((0, 0),) * 9, 4, 6)
    with pytest.raises(ValueError, match="rows"):
        cuda_stencil.row_stencil(x, ((0, 0), (1, 0)), 4, 6)


def test_cuda_tensors_never_take_the_plain_versions(cuda):
    """With the plain versions made to raise, the wrappers still run on CUDA
    tensors, and each launch moves its counter."""
    rng = np.random.default_rng(5)
    x, wt = _bf16(rng, (1, 10, 20, 16)).to(cuda), _bf16(rng, (3, 3, 16, 16), 0.05).to(cuda)
    boxes, scores = (t.to(cuda) for t in _sorted_set(rng, 3, 40))
    boom = mock.Mock(side_effect=AssertionError("plain version called on a CUDA tensor"))
    counts = (cuda_conv.conv3x3_rows.launches, cuda_conv.vconv3.launches,
              cuda_stencil.row_stencil.launches, cuda_nms.nms_mask.launches)
    with mock.patch.object(cuda_conv, "conv3x3_rows_torch", boom), \
            mock.patch.object(cuda_conv, "vconv3_torch", boom), \
            mock.patch.object(cuda_stencil, "row_stencil_torch", boom), \
            mock.patch.object(cuda_nms, "nms_mask_torch", boom):
        cuda_conv.conv3x3_rows(x, wt)
        cuda_conv.vconv3(x, wt[:, 0].reshape(48, 16))
        cuda_stencil.row_stencil(x, ((0, 0), (1, 0), (2, 0)), 8, 20)
        cuda_nms.nms_mask(boxes, scores, 0.5)
    torch.cuda.synchronize()
    assert boom.call_count == 0
    assert (cuda_conv.conv3x3_rows.launches, cuda_conv.vconv3.launches,
            cuda_stencil.row_stencil.launches,
            cuda_nms.nms_mask.launches) == tuple(c + 1 for c in counts)


# -- the training path's matching and hard-negative ranks on the card ---------

def _shared_prior_case(seed, b=8, g=12):
    """SSD300's priors and padded GT in which GTs repeat (exact duplicates and
    1-pixel shifts), so several share one best prior, plus an empty image."""
    from ssds_tpu_torch.models.builder import create_model, create_priors

    cfg = default_config()
    _, fmaps = create_model(cfg.MODEL)
    priors = create_priors(cfg.MODEL, fmaps)
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.05, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1::3] = boxes[:, 0::3][:, :boxes[:, 1::3].shape[1]]            # duplicates
    boxes[:, 2::3] = boxes[:, 0::3][:, :boxes[:, 2::3].shape[1]] + 1 / 300  # shifted a pixel
    labels = rng.integers(0, 20, (b, g)).astype(np.int32)
    valid = np.arange(g)[None, :] < rng.integers(1, g + 1, b)[:, None]
    valid[3] = False
    return [torch.from_numpy(a) for a in (boxes, labels, valid, priors)]


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_on_the_card_equals_cpu_and_repeats(cuda, seed):
    """The forced match (a scatter_reduce 'amax') and the argmaxes are
    deterministic on CUDA: the same targets as the CPU, run after run."""
    from ssds_tpu_torch.ops.matching import match_batch

    case = _shared_prior_case(seed)
    want_loc, want_conf = match_batch(*case)
    on_card = [t.to(cuda) for t in case]
    runs = [match_batch(*on_card) for _ in range(5)]
    torch.cuda.synchronize()
    for loc, conf in runs:
        assert torch.equal(conf, runs[0][1]) and torch.equal(loc, runs[0][0])
    assert torch.equal(runs[0][1].cpu(), want_conf)
    torch.testing.assert_close(runs[0][0].cpu(), want_loc, rtol=1e-6, atol=1e-6)
    assert (want_conf[3] == 0).all() and (want_conf > 0).sum() > 0


@pytest.mark.parametrize("levels", [0, 3, 1])
def test_hard_negative_ranks_on_the_card_equal_cpu_with_ties(cuda, levels):
    """Stable sorts on CUDA: tied losses rank index-ascending, as on the CPU."""
    from ssds_tpu_torch.ops.losses import hard_negative_ranks

    rng = np.random.default_rng(levels)
    x = rng.uniform(0, 5, (32, 8732)).astype(np.float32)
    if levels:
        x = np.floor(x * levels / 5).astype(np.float32)
    x[:, ::7] = 0.0
    want = hard_negative_ranks(torch.from_numpy(x))
    runs = [hard_negative_ranks(torch.from_numpy(x).to(cuda)) for _ in range(5)]
    for r in runs:
        assert torch.equal(r.cpu(), want)


def test_multibox_loss_on_the_card_equals_cpu(cuda):
    from ssds_tpu_torch.ops.losses import multibox_loss

    boxes, labels, valid, priors = _shared_prior_case(2)
    rng = np.random.default_rng(3)
    loc = torch.from_numpy(rng.normal(0, 1, (8, priors.shape[0], 4)).astype(np.float32))
    conf = torch.from_numpy(rng.normal(0, 2, (8, priors.shape[0], 21)).astype(np.float32))
    want = multibox_loss(loc, conf, boxes, labels, valid, priors)
    got = multibox_loss(*(t.to(cuda) for t in (loc, conf, boxes, labels, valid, priors)))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=0)


# -- SSDLite-MobileNetV2 with BatchNorm on the card ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_batchnorm_on_the_card_equals_cpu(cuda, dtype):
    """The port's flax-style BatchNorm (cuDNN or the native kernel on the
    card), train then eval mode: the outputs and the updated running
    statistics equal the CPU's within float32 rounding (rtol 1e-5; a bf16
    output within one bf16 ulp, 2^-7 of the value at the bottom of its
    binade, plus atol 1e-5: the two float32 results may round to neighbouring
    bf16 values)."""
    from ssds_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(1.0, 2.0, (8, 24, 19, 19)).astype(np.float32)).to(dtype)
    layers = []
    for device in ("cpu", cuda):
        bn = BatchNorm(24)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 24))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 24))
        layers.append(bn.to(device))
    outs = [[bn.train()(x.to(bn.weight.device)), bn.eval()(x.to(bn.weight.device))]
            for bn in layers]
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for want, got in zip(outs[0], outs[1]):
        assert got.dtype == dtype
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=rtol, atol=1e-5)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(layers[1], name).cpu(), getattr(layers[0], name),
                                   rtol=1e-5, atol=1e-7)


def test_ssd_lite_300_forward_on_the_card_equals_cpu(cuda):
    """SSDLite-MobileNetV2-300 at full width, float32 eval forward with random
    running statistics, card (TF32 off) against CPU: within rtol / atol 1e-4,
    the bound ``chip_smoke.py`` holds the VGG16 forward to."""
    from ssds_tpu_torch.models.builder import create_model, init_model
    from ssds_tpu_torch.config import ssd_lite_mobilenetv2_config

    cfg = default_config()
    cfg.MODEL.update(ssd_lite_mobilenetv2_config().MODEL)
    model = init_model(create_model(cfg.MODEL)[0], seed=3)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    x = np.random.default_rng(3).normal(0, 50, (2, 3, 300, 300)).astype(np.float32)
    x = torch.from_numpy(x)
    with torch.no_grad():
        want = model(x, phase="eval")
        got = model.to(cuda)(x.to(cuda), phase="eval")
    assert got[0].shape == (2, 3000, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_ssd_lite_train_step_on_the_card_equals_cpu(cuda):
    """One float32 SSDLite-MobileNetV2-300 step at batch 8, card against CPU
    (``tools.step_parity``): the bounds of ``chip_smoke.py`` phase 9."""
    import chip_smoke
    from ssds_tpu_torch.tools import step_parity

    r = step_parity.run("lite", chip_smoke.LITE_F32_BATCH, 0, cuda)
    assert max(r["loss_rel_err"].values()) <= chip_smoke.STEP_RTOL
    assert r["update_err_over_max_update"] <= chip_smoke.LITE_UPDATE_TOL
    assert r["stats_rel_err_max"] <= chip_smoke.LITE_STATS_RTOL


def _head_model(kind, seed=3):
    """FSSD-VGG16-300 or RFBNet-VGG16-300 at full width on the CPU, float32,
    with random running statistics."""
    from ssds_tpu_torch.config import MODELS
    from ssds_tpu_torch.models.builder import create_model, init_model

    model = init_model(create_model(MODELS[kind][1]().MODEL)[0], seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return model


@pytest.mark.parametrize("kind", ["fssd", "rfb"])
def test_fssd_and_rfb_300_forward_on_the_card_equals_cpu(cuda, kind):
    """The float32 eval forward at full width, card (TF32 off) against CPU:
    within rtol / atol 1e-4, the bound ``chip_smoke.py`` holds every forward to."""
    model = _head_model(kind)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 50, (2, 3, 300, 300))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x, phase="eval")
        got = model.to(cuda)(x.to(cuda), phase="eval")
    assert got[0].shape == (2, 8732, 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_fssd_runs_after_the_fusion_bn_in_float32_under_autocast(cuda):
    """Training's bf16 autocast on the card: the backbone's taps are bf16; the
    fusion BN's output, the pyramid sources and the raw (loc, conf) are
    float32, as the JAX package computes them."""
    from ssds_tpu_torch.models.heads.common import run_layers

    model = _head_model("fssd").to(cuda).train()
    x = torch.randn(2, 3, 300, 300, device=cuda) * 50
    with torch.autocast("cuda", dtype=torch.bfloat16):
        taps, _ = run_layers(model.base, model.taps, x)
        sources = model(x, phase="feature")
        loc, conf = model(x, phase="train")
    assert all(t.dtype == torch.bfloat16 for t in taps)
    assert [tuple(s.shape[2:]) for s in sources] == [(38, 38), (19, 19), (10, 10), (5, 5),
                                                     (3, 3), (1, 1)]
    assert all(s.dtype == torch.float32 for s in sources)
    assert loc.dtype == conf.dtype == torch.float32


@pytest.mark.parametrize("kind", ["fssd", "rfb"])
def test_fssd_and_rfb_detect_rows_identical_with_kernel_and_plain_nms(cuda, kind):
    """bf16 serving at full width: ``predict_batch`` launches the kernel once,
    and the same loc / conf through detect with the kernel and with the
    plain NMS give identical rows at batch 1 and 4."""
    from ssds_tpu_torch.config import MODELS
    from ssds_tpu_torch.detector import ObjectDetector

    det = ObjectDetector(MODELS[kind][1](), device=cuda, seed=1)
    imgs = np.random.default_rng(1).integers(0, 256, (4, 300, 300, 3), dtype=np.uint8)
    before = cuda_nms.nms_mask.launches
    out = det.predict_batch(list(imgs), threshold=0.01)
    assert cuda_nms.nms_mask.launches == before + 1 and len(out) == 4
    for batch in (1, 4):
        with torch.no_grad():
            loc, conf = det.forward(torch.from_numpy(imgs[:batch]).to(cuda))
            rows = postprocess.detect(loc, conf, det.priors, det.post)
            with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
                plain = postprocess.detect(loc, conf, det.priors, det.post)
        assert rows.shape == (batch, 21, 100, 5) and torch.equal(rows, plain)


@pytest.mark.parametrize("kind", ["random", "dense_overlap", "tied_scores"])
def test_kernel_bit_identical_at_the_coco_eval_shape(cuda, kind):
    """``[64 x 81, 200]``: COCO's eval at ``TEST.BATCH_SIZE`` 64."""
    m, n = 5184, 200
    rng = np.random.default_rng([m, n, len(kind)])
    boxes, scores = _sorted_set(rng, m, n, *((0.3, 0.5) if kind == "dense_overlap" else ()),
                                levels=6 if kind == "tied_scores" else 0)
    bc, sc = boxes.to(cuda), scores.to(cuda)
    for thr in (0.45, 0.6):
        got = cuda_nms.nms_mask(bc, sc, thr).cpu()
        assert torch.equal(got, nms_mask_torch(bc, sc, thr).cpu())
        assert torch.equal(got, nms_mask_torch(boxes, scores, thr))


def test_native_sampler_builds_and_samples():
    """The crop sampler's host library builds from ``csrc/ssd_augment.cpp``
    with this machine's g++ and samples crops that hold the recipe's
    constraints (it needs no card; it belongs to the card machine's checks)."""
    from ssds_tpu_torch.data import native

    boxes = np.array([[20, 30, 80, 90], [100, 10, 150, 110]], np.float32)
    hits = [r for r in (native.sample_crop(boxes, 160, 120, s) for s in range(200)) if r]
    assert len(hits) > 100
    for roi, mask in hits:
        assert 0 <= roi[0] < roi[2] <= 160 and 0 <= roi[1] < roi[3] <= 120 and mask.any()
        cropped = native.crop_boxes(boxes[mask], roi)
        assert (cropped >= 0).all() and (cropped[:, 2] <= roi[2] - roi[0]).all()


def test_detector_predicts_a_640x480_image_on_the_card(cuda):
    """``predict`` resizes a 640x480 image on the host (numpy) and serves it:
    its rows are ``detect`` on the resized image, rescaled to 640x480."""
    from ssds_tpu_torch.data.image_ops import resize_linear
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    det = ObjectDetector(cfg, device=cuda)
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    before = cuda_nms.nms_mask.launches
    boxes, labels, scores = det.predict(img, threshold=0.01)
    assert cuda_nms.nms_mask.launches == before + 1
    rows = det.detect_rows(resize_linear(img, (64, 64))[None])[0].cpu().numpy()
    cls, slot = np.nonzero(rows[..., 0] > 0.01)
    np.testing.assert_array_equal(labels, cls - 1)
    np.testing.assert_array_equal(scores, rows[cls, slot, 0])
    np.testing.assert_array_equal(boxes, rows[cls, slot, 1:5] * np.float32([640, 480, 640, 480]))
    assert len(scores) > 0


def _yolo_case(seed, grids, anchors, b=4, g=6, classes=20):
    """Raw outputs, anchors and padded GT for the YOLO ops, with two GTs on
    one cell-anchor and padding after a valid GT on cell 0."""
    rng = np.random.default_rng(seed)
    raw = [torch.from_numpy(rng.normal(0, 1, (b, h, w, len(a), 5 + classes)).astype(np.float32))
           for (h, w), a in zip(grids, anchors)]
    xy = rng.uniform(0.05, 0.95, (b, g, 2))
    wh = rng.uniform(0.02, 0.6, (b, g, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < rng.integers(2, g, (b, 1))
    boxes[0, 1] = boxes[0, 0] + 0.001  # the same cell and anchor as GT 0
    valid[0, :2] = True
    i = min(1, b - 1)  # cell 0, then padding on cell 0
    boxes[i] = 0.0
    boxes[i, 0] = [0.0, 0.0, 0.03, 0.03]
    valid[i] = False
    valid[i, 0] = True
    boxes[~valid] = 0.0
    labels = torch.from_numpy(rng.integers(0, classes, (b, g)).astype(np.int32))
    return (raw, [torch.tensor(a, dtype=torch.float32) for a in anchors], torch.from_numpy(boxes),
            labels, torch.from_numpy(valid))


YOLO_V3_GRIDS = [(52, 52), (26, 26), (13, 13)]
YOLO_V3_ANCHORS = [[[10, 13], [16, 30], [33, 23]], [[30, 61], [62, 45], [59, 119]],
                   [[116, 90], [156, 198], [373, 326]]]
YOLO_V2_ANCHORS = [[[27, 37], [87, 102], [173, 236], [339, 216], [382, 383]]]


@pytest.mark.parametrize("version", [3, 2])
def test_yolo_losses_and_decode_on_the_card_equal_the_cpu(cuda, version):
    """``decode_scale``, ``yolo_loss`` / ``yolo_v2_loss`` and their gradients
    at YOLO-416's grids, card against CPU: the decode within rtol / atol 1e-5
    (exp and sigmoid in other libraries), the losses within rtol 1e-5 and the
    gradients within 1e-5 of their largest element (float32 sums over 10,647
    cells in other orders)."""
    from ssds_tpu_torch.ops import yolo

    grids, anchors = ((YOLO_V3_GRIDS, YOLO_V3_ANCHORS) if version == 3
                      else ([(13, 13)], YOLO_V2_ANCHORS))
    raw, anc, boxes, labels, valid = _yolo_case(version, grids, anchors)
    fn = yolo.yolo_loss if version == 3 else yolo.yolo_v2_loss
    kw = {} if version == 3 else {"seen_images": 0.0}

    def run(dev):
        r = [t.to(dev).requires_grad_() for t in raw]
        a = [t.to(dev) for t in anc]
        ll, lc = fn(r, a, boxes.to(dev), labels.to(dev), valid.to(dev), (416, 416), **kw)
        (ll + lc).backward()
        dec = yolo.decode_scale(r[0].detach(), a[0], (416, 416))
        return [ll.item(), lc.item()], [t.grad.cpu() for t in r], [d.cpu() for d in dec]

    (gl, gg, gd), (cl, cg, cd) = run(cuda), run("cpu")
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in cg)
    assert max(float((a - b).abs().max()) for a, b in zip(gg, cg)) <= 1e-5 * scale
    for a, b in zip(gd, cd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_yolo_positive_mask_is_the_same_over_five_runs(cuda):
    """The OR-scatter on the card with many GTs on few cells, the on/off
    flags mixed: the same mask in five runs, equal to the CPU's."""
    from ssds_tpu_torch.ops.yolo import positive_mask

    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 4, (16, 64)))
    on = torch.from_numpy(rng.random((16, 64)) < 0.3)
    want = positive_mask(8, idx, on)
    for _ in range(5):
        assert torch.equal(positive_mask(8, idx.to(cuda), on.to(cuda)).cpu(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("batch", [1, 4])
def test_yolo_detect_decoded_rows_with_the_kernel_equal_plain(cuda, batch):
    """A YOLOv3-416-shaped decode (10,647 boxes, 21 score columns, column 0
    ``1 - obj``) through ``detect_decoded`` with the kernel and the plain NMS."""
    from ssds_tpu_torch.ops import yolo

    raw, anc, _, _, _ = _yolo_case(batch, YOLO_V3_GRIDS, YOLO_V3_ANCHORS, b=batch)
    boxes, scores = [], []
    for r, a in zip(raw, anc):
        b, obj, cls = yolo.decode_scale(r.to(cuda), a.to(cuda), (416, 416))
        boxes.append(b)
        scores.append(torch.cat([(1 - obj)[..., None], obj[..., None] * torch.sigmoid(cls)], -1))
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
    assert boxes.shape == (batch, 10647, 4) and scores.shape == (batch, 10647, 21)
    cfg = postprocess.PostProcessConfig(iou_threshold=0.45, pre_nms_top_n=1024)
    before = cuda_nms.nms_mask.launches
    rows = postprocess.detect_decoded(boxes, scores, cfg)
    assert cuda_nms.nms_mask.launches == before + 1
    with mock.patch.object(postprocess, "nms_mask", nms_mask_torch):
        plain = postprocess.detect_decoded(boxes, scores, cfg)
    assert rows.shape == (batch, 21, 100, 5) and torch.equal(rows, plain)
    assert (rows[:, 1:, :, 0] > 0).any()


def test_yolo_detector_serves_on_the_card(cuda):
    """A small YOLOv3 (MobileNetV1-0.25, 64x64, float32) on the card: the
    kernel runs, and the decoded boxes and scores agree with the CPU's (atol
    1e-4, TF32 off)."""
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.update(SSDS="yolo_v3", NETS="mobilenet_v1_025", IMAGE_SIZE=[64, 64],
                     FEATURE_LAYER=[[5, 11, 13], [64, 128, 256]], HALF_PRECISION=False,
                     ANCHORS=[[[16, 16]], [[24, 24]], [[32, 32]]])
    gpu, cpu = ObjectDetector(cfg, device=cuda), ObjectDetector(cfg, device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    before = cuda_nms.nms_mask.launches
    out = gpu.predict_batch(list(imgs), threshold=0.01)
    assert cuda_nms.nms_mask.launches == before + 1
    assert len(out) == 4 and all(np.isfinite(b).all() for b, _, _ in out)
    x = torch.from_numpy(imgs)
    for g, c in zip(gpu.forward(x.to(cuda)), cpu.forward(x)):
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n", [(21, 200), (672, 200), (1344, 200)])
def test_nms_op_cuda_implementation_is_the_kernel(cuda, m, n):
    """``torch.ops.ssds_tpu_torch.nms_mask`` on CUDA tensors launches the
    kernel (its count rises) and equals the plain version bit for bit."""
    for kind in ("random", "dense_overlap", "tied_scores"):
        rng = np.random.default_rng([m, n, len(kind)])
        lo, hi, levels = {"random": (0.05, 0.4, 0), "dense_overlap": (0.3, 0.6, 0),
                          "tied_scores": (0.05, 0.4, 4)}[kind]
        boxes, scores = _sorted_set(rng, m, n, lo, hi, levels)
        before = cuda_nms.nms_mask.launches
        got = torch.ops.ssds_tpu_torch.nms_mask(boxes.to(cuda), scores.to(cuda), 0.45)
        assert cuda_nms.nms_mask.launches == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.bool
        assert torch.equal(got.cpu(), nms_mask_torch(boxes, scores, 0.45)), kind


def test_export_round_trip_on_the_card(cuda, tmp_path):
    """A small SSD-VGG16 (64x64, bf16, 376 priors) exported on the card with
    a symbolic batch: the reloaded program launches the NMS kernel and its
    rows at batches 1, 3 and 8 are the in-process detector's unpruned rows."""
    import dataclasses

    from ssds_tpu_torch.detector import ObjectDetector, Predict
    from ssds_tpu_torch.export import export_detector, load_exported

    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    cfg.POST_PROCESS.PRE_NMS_TOP_N = 64  # so that eager serving prunes at batch 8
    det = ObjectDetector(cfg, device=cuda)
    predict, meta = load_exported(export_detector(det, str(tmp_path / "served")))
    assert meta["device"].startswith("cuda") and meta["batch"] == "symbolic"
    unpruned = Predict(det.model, det.means, det.priors,
                       dataclasses.replace(det.post, pre_nms_top_n=0), det.dtype)
    for b in (1, 3, 8):
        x = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 64, 64, 3), dtype=np.uint8)).to(cuda)
        before = cuda_nms.nms_mask.launches
        served = predict(x)
        torch.cuda.synchronize()
        assert cuda_nms.nms_mask.launches == before + 1
        with torch.no_grad():
            assert torch.equal(served, unpruned(x)), b


# -- int8 serving: csrc/int8_conv.cu ------------------------------------------
# The int32 accumulators are exact, so int8_conv and quantize_act are held
# bit-identical to their plain versions (ssds_tpu_torch/ops/quant.py; the
# plain conv runs in float64 on the card with cuDNN off, exact for integers).

# odd shapes: Cin 3 (padded to 4), dilation 6, stride 2 with a 7x7 kernel,
# a 1x3 kernel with per-axis padding, Cout not a multiple of the 64-wide tile
# the kernels' edges, each run at batches 1 and 3 (M = 3 * Ho * Wo, not a
# multiple of the 128-pixel M tile): Cp 4 / 20 / 12 / 36 / 44 (4-byte
# copies) and 24 / 40 (8-byte), Cout filling no N tile (65, 70, 72, SSD's
# conf 84 and 126 and loc 16 and 24), a 1x1 map, K = 396 (not a multiple of
# 32), dilation 6, stride 2, a 7x7 and a 1x3 kernel
INT8_ODD_SHAPES = [("cin3", 3, 64, (3, 3), (1, 1), (1, 1), (1, 1), (19, 23), True, True),
                   ("fc6", 40, 72, (3, 3), (1, 1), (6, 6), (6, 6), (19, 19), True, False),
                   ("s2", 20, 8, (3, 3), (2, 2), (1, 1), (1, 1), (10, 10), False, False),
                   ("k7s2", 12, 65, (7, 7), (2, 2), (3, 3), (1, 1), (33, 31), False, True),
                   ("k1x3", 33, 70, (1, 3), (1, 1), (0, 1), (1, 1), (9, 17), False, False),
                   ("conf84", 64, 84, (3, 3), (1, 1), (1, 1), (1, 1), (5, 5), True, False),
                   ("conf126", 48, 126, (3, 3), (1, 1), (1, 1), (1, 1), (3, 3), True, False),
                   ("loc16", 128, 16, (3, 3), (1, 1), (1, 1), (1, 1), (10, 10), True, False),
                   ("loc24_cp24", 24, 24, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True,
                    False),
                   ("map1x1", 64, 40, (3, 3), (1, 1), (1, 1), (1, 1), (1, 1), True, True),
                   ("k396", 44, 40, (3, 3), (1, 1), (1, 1), (1, 1), (13, 11), False, True)]


@pytest.mark.parametrize("shape", INT8_ODD_SHAPES, ids=lambda s: s[0])
def test_int8_kernels_bit_identical_to_plain_at_odd_shapes(cuda, shape):
    from ssds_tpu_torch.tools import int8_bench

    out = int8_bench.run([int8_bench.ConvShape(*shape)], (1, 3), time_it=False, log=lambda *a: 0)
    assert out["max_abs_err"] == 0.0 and len(out["cases"]) == 2


def test_int8_conv_refuses_int8_tensors_off_16_byte_alignment(cuda):
    """The kernel's 16-byte copies need 16-byte aligned operands: a view four
    bytes in raises, and nothing is launched."""
    from ssds_tpu_torch.ops.cuda import int8_conv as cuda_int8

    xq = torch.zeros(1 * 5 * 5 * 16 + 4, dtype=torch.int8, device=cuda)[4:].view(1, 5, 5, 16)
    wq = torch.zeros((8, 3, 3, 16), dtype=torch.int8, device=cuda)
    one = torch.ones((), device=cuda)
    before = cuda_int8.int8_conv.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_int8.int8_conv(xq, wq, one, torch.ones(8, device=cuda), None, (1, 1), (1, 1),
                            (1, 1), False, torch.float32)
    assert cuda_int8.int8_conv.launches == before


@pytest.fixture(scope="module")
def int8_ssd300():
    """SSD300-VGG16 with ``MODEL.QUANT: int8`` on the card (built once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine: see this file's docstring)")
    from ssds_tpu_torch.detector import ObjectDetector

    cfg = default_config()
    cfg.MODEL.QUANT = "int8"
    return ObjectDetector(cfg, device="cuda")


def test_int8_kernels_bit_identical_to_plain_at_every_ssd300_shape(cuda, int8_ssd300):
    """Phase 14's shape set: every int8 conv of SSD300-VGG16 and the
    MobileNetV2 / DarkNet-53 shapes, at batches 1 and 32."""
    from ssds_tpu_torch.tools import int8_bench

    det = int8_ssd300
    shapes = int8_bench.model_shapes(det.model, det.img_hw, cuda)
    assert len(shapes) == 35
    out = int8_bench.run(shapes + list(int8_bench.EXTRA_SHAPES), (1, 32), time_it=False,
                         log=lambda *a: 0)
    assert len(out["cases"]) == 2 * (35 + len(int8_bench.EXTRA_SHAPES))


def test_int8_serving_launches_the_kernels(cuda, int8_ssd300):
    from ssds_tpu_torch import quant
    from ssds_tpu_torch.ops.cuda import int8_conv as cuda_int8

    det = int8_ssd300
    n = quant.num_quantized(det.model)
    before = (cuda_int8.quantize_act.launches, cuda_int8.int8_conv.launches)
    img = np.random.default_rng(0).integers(0, 256, (300, 300, 3), dtype=np.uint8)
    boxes, labels, scores = det.predict(img, threshold=0.01)
    torch.cuda.synchronize()
    assert (cuda_int8.quantize_act.launches - before[0],
            cuda_int8.int8_conv.launches - before[1]) == (n, n)
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()


def test_exported_int8_program_calls_the_registered_operators(cuda, tmp_path):
    import dataclasses

    from ssds_tpu_torch import quant
    from ssds_tpu_torch.detector import ObjectDetector, Predict
    from ssds_tpu_torch.export import export_detector, load_exported
    from ssds_tpu_torch.ops.cuda import int8_conv as cuda_int8

    cfg = default_config()
    cfg.MODEL.update(IMAGE_SIZE=[64, 64], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                     ASPECT_RATIOS=[[2], [2, 3], [2, 3]], QUANT="int8")
    det = ObjectDetector(cfg, device=cuda)
    n = quant.num_quantized(det.model)
    out = export_detector(det, str(tmp_path / "served"))
    program = torch.export.load(os.path.join(out, "predict.pt2"))
    targets = {str(node.target) for node in program.graph.nodes if node.op == "call_function"}
    assert {"ssds_tpu_torch.quantize_act.default", "ssds_tpu_torch.int8_conv.default"} <= targets
    predict, _ = load_exported(out)
    unpruned = Predict(det.model, det.means, det.priors,
                       dataclasses.replace(det.post, pre_nms_top_n=0), det.dtype)
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 64, 64, 3), dtype=np.uint8)).to(cuda)
        before = cuda_int8.int8_conv.launches
        served = predict(x)
        torch.cuda.synchronize()
        assert cuda_int8.int8_conv.launches == before + n
        with torch.no_grad():
            assert torch.equal(served, unpruned(x)), b


def test_augment_batch_on_the_card_equals_cpu(cuda):
    """The applier on the card against the CPU under the same draws: within
    1e-3 (float32 contractions summed in other orders)."""
    from ssds_tpu_torch.ops import augment_device as ad

    rng = np.random.default_rng(0)
    b = 16
    imgs = torch.from_numpy(rng.uniform(-120, 130, (b, 96, 96, 3)).astype(np.float32))
    xy, wh = rng.uniform(0, 0.6, (b, 6, 2)), rng.uniform(0.1, 0.4, (b, 6, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, 6)) < 0.7)
    p = ad.sample_params(torch.Generator().manual_seed(3), boxes, valid, 0.9)
    want = ad.apply_params(imgs, boxes, valid, p, (104, 117, 123))
    got = ad.apply_params(imgs.to(cuda), boxes.to(cuda), valid.to(cuda),
                          ad.AugParams(*(t.to(cuda) for t in p)), (104, 117, 123))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-6)
    assert torch.equal(got[2].cpu(), want[2])
    gen = torch.Generator(device=cuda).manual_seed(5)
    out = ad.augment_batch(gen, imgs.to(cuda), boxes.to(cuda), valid.to(cuda), 0.6)
    assert all(t.device.type == "cuda" for t in out) and torch.isfinite(out[0]).all()


# -- data parallelism and the moved export ------------------------------------


def test_two_gloo_ranks_on_card_zero_equal_one_rank(cuda, tmp_path):
    """Two SSDLite-MobileNetV2 float64 steps (64 px, the narrow model of
    ``tests/test_torch_port_lite_train.py``, seeded random weights) at a
    global batch of 4: two gloo ranks sharing card 0
    (``tests/torch_port_ddp_worker.py``) against one rank on the same card,
    within ``tests/test_torch_port_ddp.py``'s bounds; the running statistics
    as ``running_stats_err`` measures them (the seeded init's running means
    are 0, and a BatchNorm fed by another moves its mean by rounding only)."""
    from ssds_tpu_torch.config import ssd_lite_mobilenetv2_config
    from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
    from torch_port_ddp_worker import collect, errors, launch, running_stats_err

    cfg = ssd_lite_mobilenetv2_config()
    cfg.MODEL.update(NETS="mobilenet_v2_025", IMAGE_SIZE=[64, 64],
                     FEATURE_LAYER=[[13, 18, "S"], [96, 1280, 256]],
                     ASPECT_RATIOS=[[2, 3]] * 3, SIZES=[0.2, 0.4, 0.6, 0.8])
    model, fmaps = create_model(cfg.MODEL)
    model = init_model(model, seed=11)
    tc = cfg.TRAIN
    tc.OPTIMIZER.update(LEARNING_RATE=1e-3, WEIGHT_DECAY=4e-5)
    tc.LR_SCHEDULER.update(SCHEDULER="step", STEPS=[1], GAMMA=0.5, WARM_UP_EPOCHS=0)
    rng = np.random.default_rng(0)
    xy, wh = rng.uniform(0, 0.6, (4, 4, 2)), rng.uniform(0.15, 0.4, (4, 4, 2))
    valid = np.arange(4)[None, :] < np.array([[3], [1], [4], [2]])
    boxes = np.where(valid[..., None], np.concatenate([xy, xy + wh], -1), 0).astype(np.float32)
    batch = {"images": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8), "boxes": boxes,
             "labels": rng.integers(0, 20, (4, 4)).astype(np.int32), "valid": valid}
    run = {"lite": dict(model=cfg.MODEL, train_cfg=tc, state_dict=model.state_dict(),
                        priors=create_priors(cfg.MODEL, fmaps), batch=batch, steps=2,
                        means=(104, 117, 123))}
    started = [launch(str(tmp_path), "two", run, 2, device="cuda:0", backend="gloo"),
               launch(str(tmp_path), "one", run, 1, device="cuda:0", backend="gloo")]
    two, one = (collect(*s) for s in started)
    got = [row[:2] + (running_stats_err(g[2], w[2]),) for row, g, w in zip(
        errors(two[0]["lite"]["steps"], one[0]["lite"]["steps"]),
        two[0]["lite"]["steps"][1:], one[0]["lite"]["steps"][1:])]
    print(f"2 gloo ranks on card 0 against 1 rank: {got}")
    assert all(e < lim for row in got for e, lim in zip(row, (1e-6, 2e-5, 1e-6))), got
    a, b = (r["lite"]["steps"][-1][2] for r in two)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_export_moved_from_the_card_to_the_cpu(cuda, tmp_path):
    """A small SSD-VGG16 (64 px, bf16) exported on the card for ``("cuda",
    "cpu")`` and loaded with ``device="cpu"``: nothing of it left on the
    card, and its rows those of an in-process CPU detector on the same
    weights (unpruned: a symbolic batch takes no prune)."""
    import dataclasses

    from ssds_tpu_torch.detector import ObjectDetector, Predict
    from ssds_tpu_torch.export import _devices_in, export_detector, load_exported

    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    out = export_detector(ObjectDetector(cfg, device=cuda), str(tmp_path / "served"),
                          platforms=("cuda", "cpu"))
    predict, meta = load_exported(out, device="cpu")
    assert meta["device"] == "cpu" and meta["platforms"] == ["cuda", "cpu"]
    cpu = ObjectDetector(cfg, device="cpu")
    unpruned = Predict(cpu.model, cpu.means, cpu.priors,
                       dataclasses.replace(cpu.post, pre_nms_top_n=0), cpu.dtype)
    for b in (1, 5):
        x = torch.from_numpy(np.random.default_rng(b).integers(0, 256, (b, 64, 64, 3),
                                                               dtype=np.uint8))
        with torch.no_grad():
            assert torch.equal(predict(x), unpruned(x)), b
    program = torch.export.load(os.path.join(out, "predict.pt2"))
    from ssds_tpu_torch.export import move_program

    assert _devices_in(move_program(program, "cpu")) == {torch.device("cpu")}
