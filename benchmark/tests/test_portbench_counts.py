"""The yardstick's arithmetic: the device trace's idle share and the FLOPs."""

from __future__ import annotations

import pytest

from benchmark import devtrace, harness
from benchmark.reference import load


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_busy_is_the_union_of_device_intervals_not_their_sum():
    events = [
        _event("user_annotation", devtrace.SPAN, 0, 1000),
        _event("kernel", "a", 100, 200),         # 100-300
        _event("kernel", "b", 200, 200),         # 200-400, overlaps a
        _event("gpu_memcpy", "Memcpy HtoD", 500, 100),
        _event("kernel", "c", 950, 200),         # runs past the window's end
        _event("kernel", "before", -300, 100),   # before the window
        _event("cpu_op", "aten::copy_", 420, 60),
        _event("cpu_op", "aten::stack", 600, 300),
    ]
    s = devtrace.summarise(events)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((300 + 100 + 50) * 1e-6)  # 100-400, 500-600, 950-1000
    idle = 100.0 * (1 - s["busy_s"] / s["window_s"])
    assert idle == pytest.approx(55.0)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::stack"] == pytest.approx(350e-6)   # 600-950
    assert gaps["aten::copy_"] == pytest.approx(100e-6)   # 400-500
    assert gaps["host code"] == pytest.approx(100e-6)     # 0-100
    assert dict(s["device_ops"])["a"] == pytest.approx(200e-6)
    assert devtrace.merged([(0, 10), (5, 20), (30, 40)], 0, 35) == [(0, 20), (30, 35)]


def test_kernel_kinds():
    assert devtrace.kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv_gemm"
    assert devtrace.kind_of("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batchnorm"
    assert devtrace.kind_of("nchwToNhwcKernel") == "layout"
    assert devtrace.kind_of("nms_mask_kernel") == "other"


@pytest.mark.parametrize("name,gflops", [("ssd300_vgg16_voc.train_b32", 62.747075584),
                                         ("yolo_v3_darknet53_coco.train_b64", 65.864075264)])
def test_flops_counted_on_meta(name, gflops):
    cell = harness.load_cell(name)
    ref = load(cell["config_file"]["reference"])
    assert ref.flops_per_image(cell["config_file"]["cfg"]) == pytest.approx(gflops * 1e9, rel=1e-12)
