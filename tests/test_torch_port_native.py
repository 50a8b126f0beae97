"""The port's native crop sampler against the JAX package's.

Both packages build the same C++ (``ssds_tpu_torch/csrc/ssd_augment.cpp`` is
a byte-identical copy of ``native/ssd_augment.cpp``) with the same flags, so
on the same boxes and seeds the port's ``sample_crop`` / ``crop_boxes`` equal
``ssds_tpu.data.native``'s bit for bit (tolerance 0). The constraints of
``tests/test_native.py`` hold for the port's too, and a failed build raises
rather than falling back.
"""

import os
from unittest import mock

import numpy as np
import pytest

from ssds_tpu.data import native as jax_native
from ssds_tpu_torch.data import augment, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_source_is_byte_identical_to_the_jax_package():
    with open(os.path.join(REPO, "native", "ssd_augment.cpp"), "rb") as f:
        want = f.read()
    with open(native.SOURCE, "rb") as f:
        assert f.read() == want


def test_library_built_in_the_package_keyed_by_digest():
    native.load()
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "ssds_tpu_torch", "_build")
    assert native.available()


def _cases():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(60):
        w, h = (int(v) for v in rng.integers(40, 700, 2))
        n = int(rng.integers(1, 4))
        xy = rng.uniform(0, 0.7, (n, 2)) * (w, h)
        wh = rng.uniform(0.02, 0.5, (n, 2)) * (w, h)
        boxes = np.hstack([xy, np.minimum(xy + wh, (w, h))]).astype(np.float32)
        cases.append((boxes, w, h))
    return cases


@pytest.mark.skipif(not jax_native.available(), reason="the JAX package's library did not build")
def test_sample_crop_and_crop_boxes_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    crops = nones = 0
    for boxes, w, h in _cases():
        for seed in rng.integers(0, 2**63, 20, dtype=np.uint64).tolist():
            got = native.sample_crop(boxes, w, h, seed)
            want = jax_native.sample_crop(boxes, w, h, seed)
            assert (got is None) == (want is None)
            if want is None:
                nones += 1
                continue
            crops += 1
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(native.crop_boxes(boxes[got[1]], got[0]),
                                          jax_native.crop_boxes(boxes[want[1]], want[0]))
    assert crops > 100 and nones > 100  # both outcomes held against the JAX package's


def test_sample_crop_constraints_hold():
    """``tests/test_native.py``'s checks on the port's sampler."""
    boxes = np.array([[20, 30, 80, 90], [100, 10, 150, 110]], np.float32)
    crops = 0
    for seed in range(300):
        r = native.sample_crop(boxes, 160, 120, seed)
        if r is None:
            continue
        crops += 1
        roi, mask = r
        assert 0 <= roi[0] < roi[2] <= 160
        assert 0 <= roi[1] < roi[3] <= 120
        centers = (boxes[:, :2] + boxes[:, 2:]) / 2
        inside = np.logical_and(roi[:2] < centers, centers < roi[2:]).all(axis=1)
        np.testing.assert_array_equal(mask, inside)
        assert mask.any()
        w, h = roi[2] - roi[0], roi[3] - roi[1]
        assert w >= 0.3 * 0.5 * 160 * 0.99 and h >= 0.3 * 0.5 * 120 * 0.99
    assert crops > 150
    nones = sum(native.sample_crop(boxes[:1], 160, 120, s) is None for s in range(300))
    assert 20 < nones < 90  # ~1/6 of 300


def test_min_iou_constraint_met():
    """Every crop meets one of the recipe's min-IoU modes (0.1, 0.3, 0.5,
    0.7, 0.9) for every box, and the strict modes occur."""
    boxes = np.array([[30, 20, 170, 130], [60, 40, 140, 110]], np.float32)
    seen = []
    for seed in range(400):
        r = native.sample_crop(boxes, 200, 150, seed)
        if r is not None:
            seen.append(float(augment._matrix_iou(boxes, r[0][None]).min()))
    seen = np.array(seen)
    assert len(seen) > 100 and (seen >= 0.1).all() and (seen >= 0.5).any()


def test_crop_boxes_matches_numpy():
    boxes = np.array([[20, 30, 80, 90], [100, 10, 150, 110]], np.float32)
    roi = np.array([10, 20, 120, 100], np.float32)
    want = boxes.copy()
    want[:, :2] = np.maximum(want[:, :2], roi[:2]) - roi[:2]
    want[:, 2:] = np.minimum(want[:, 2:], roi[2:]) - roi[:2]
    np.testing.assert_array_equal(native.crop_boxes(boxes, roi), want)


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    with pytest.raises(RuntimeError):
        native.available()


def test_crop_uses_the_native_sampler_and_the_python_loop_when_switched_off():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[20, 30, 80, 90], [100, 10, 150, 110]], np.float32)
    labels = np.array([3, 7], np.float32)
    before = native.launches
    for _ in range(20):
        augment._crop(img, boxes, labels)
    assert native.launches == before + 20
    with mock.patch.object(native, "available", lambda: False):
        for _ in range(20):
            augment._crop(img, boxes, labels)
    assert native.launches == before + 20


def test_wrong_shapes_are_refused_before_the_call():
    with pytest.raises(ValueError, match=r"\[n, 4\]"):
        native.sample_crop(np.zeros((3, 5), np.float32), 100, 100, 1)
    with pytest.raises(ValueError, match=r"\[4\]"):
        native.crop_boxes(np.zeros((2, 4), np.float32), np.zeros(5, np.float32))
