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
@pytest.mark.parametrize("m,n", [(21, 200), (672, 200), (5, 1), (3, 37), (9, 512)])
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


# (B, H, W, Cin, Cout): partial tiles in H and W, Cin != Cout, a partial and a
# second 64-channel output slice
CONV_SHAPES = [(2, 37, 45, 64, 64), (1, 19, 70, 32, 48), (3, 8, 33, 16, 16), (1, 20, 40, 64, 128)]


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(torch.bfloat16)


def _within_ulp(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tile", cuda_conv.TILES, ids=lambda t: f"{t[0]}x{t[1]}")
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
    with pytest.raises(ValueError, match="warps"):
        cuda_conv.conv3x3_rows(x, wt, (17, 1))
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
    boom = mock.Mock(side_effect=AssertionError("plain version called on a CUDA tensor"))
    counts = (cuda_conv.conv3x3_rows.launches, cuda_conv.vconv3.launches,
              cuda_stencil.row_stencil.launches)
    with mock.patch.object(cuda_conv, "conv3x3_rows_torch", boom), \
            mock.patch.object(cuda_conv, "vconv3_torch", boom), \
            mock.patch.object(cuda_stencil, "row_stencil_torch", boom):
        cuda_conv.conv3x3_rows(x, wt)
        cuda_conv.vconv3(x, wt[:, 0].reshape(48, 16))
        cuda_stencil.row_stencil(x, ((0, 0), (1, 0), (2, 0)), 8, 20)
    torch.cuda.synchronize()
    assert boom.call_count == 0
    assert (cuda_conv.conv3x3_rows.launches, cuda_conv.vconv3.launches,
            cuda_stencil.row_stencil.launches) == tuple(c + 1 for c in counts)
