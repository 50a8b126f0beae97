"""The port's numpy image operations against the OpenCV calls they replace.

``ssds_tpu_torch/data/image_ops.py`` stands in for the JAX package's cv2
calls on the card's machine, which has no OpenCV. Every function must be
bit-exact (tolerance 0) against cv2 on this machine's OpenCV: resize over
down- and upscales, the exact 2x downscale (which cv2 routes to INTER_AREA),
1-pixel sides and grayscale; BGR->HSV and HSV->BGR over every 8-bit input
and every row width's split between cv2's vector body and its tail;
``convertScaleAbs``, ``add`` with half-integer scalars, and the constant
border.
"""

import cv2
import numpy as np
import pytest

from ssds_tpu_torch.data import image_ops


def _cv2_resize(img, hw):
    return cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (300, 300)), ((333, 500), (300, 300)), ((300, 299), (300, 300)),
    ((200, 120), (64, 64)), ((97, 131), (300, 300)),        # upscale
    ((600, 600), (300, 300)), ((192, 192), (96, 96)),       # exact 2x: INTER_AREA in cv2
    ((1, 1), (5, 7)), ((1, 9), (4, 1)), ((17, 1), (3, 300)),  # 1-pixel sides
    ((3, 5), (300, 300)), ((301, 299), (150, 149)), ((240, 640), (96, 96)),
    ((300, 300), (77, 123)), ((50, 70), (200, 333)), ((480, 240), (2, 2)),
], ids=str)
def test_resize_linear_bit_exact(src, dst):
    rng = np.random.default_rng([*src, *dst])
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    got = image_ops.resize_linear(img, dst)
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_resize(img, dst))


def test_resize_linear_random_shapes_grayscale_and_views():
    rng = np.random.default_rng(7)
    for _ in range(150):
        sh, sw = (int(v) for v in rng.integers(1, 700, 2))
        dh, dw = (int(v) for v in rng.integers(1, 400, 2))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(image_ops.resize_linear(img, (dh, dw)),
                                      _cv2_resize(img, (dh, dw)), err_msg=f"{sh, sw, dh, dw}")
    gray = rng.integers(0, 256, (123, 77), dtype=np.uint8)
    np.testing.assert_array_equal(image_ops.resize_linear(gray, (50, 90)),
                                  _cv2_resize(gray, (50, 90)))
    view = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)[10:150, ::-1][:, 5:260]
    np.testing.assert_array_equal(image_ops.resize_linear(view, (96, 96)),
                                  _cv2_resize(view, (96, 96)))
    same = image_ops.resize_linear(view, view.shape[:2])
    np.testing.assert_array_equal(same, view)


def _all_bgr():
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    return np.stack([b, g, r], -1).astype(np.uint8).reshape(4096, 4096, 3)


def _all_hsv(width):
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    pad = (-len(px)) % width
    return np.concatenate([px, px[:pad]]).reshape(-1, width, 3)


def test_bgr_to_hsv_every_input():
    img = _all_bgr()
    np.testing.assert_array_equal(image_ops.bgr_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [256, 31], ids=["vector_body", "tail"])
def test_hsv_to_bgr_every_input(width):
    """Every (H < 180, S, V): in rows of 256 pixels cv2 converts all of them
    in its vector body (truncating), in rows of 31 all in its tail (rounding)."""
    img = _all_hsv(width)
    np.testing.assert_array_equal(image_ops.hsv_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_color_conversions_every_row_width():
    rng = np.random.default_rng(3)
    for width in list(range(1, 100)) + [255, 256, 257, 299, 300, 333, 480, 511, 640]:
        hsv = rng.integers(0, 256, (4, width, 3), dtype=np.uint8)
        hsv[..., 0] %= 180
        np.testing.assert_array_equal(image_ops.hsv_to_bgr(hsv),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR), err_msg=str(width))
        bgr = rng.integers(0, 256, (4, width, 3), dtype=np.uint8)
        np.testing.assert_array_equal(image_ops.bgr_to_hsv(bgr),
                                      cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV), err_msg=str(width))


def test_convert_scale_abs_bit_exact():
    rng = np.random.default_rng(4)
    img = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, 2)
    alphas = [0.5, 0.75, 1.0, 1.5, 1.0 / 3.0] + rng.uniform(0.5, 1.5, 40).tolist()
    for alpha in alphas:
        np.testing.assert_array_equal(image_ops.convert_scale_abs(img, alpha=alpha),
                                      cv2.convertScaleAbs(img, alpha=alpha, beta=0.0))
        plane = np.ascontiguousarray(img[..., 1])
        np.testing.assert_array_equal(image_ops.convert_scale_abs(plane, alpha=alpha),
                                      cv2.convertScaleAbs(plane, alpha=alpha))


@pytest.mark.parametrize("beta", [10.5, 11.5, 10.6, -10.5, -11.5, 0.5, -0.5, 1.5, -1.5, -31.7,
                                  31.99, -32.0, 2.5000001, -2.4999, 0.0])
def test_add_scalar_bit_exact(beta):
    img = np.random.default_rng(5).integers(0, 256, (40, 33, 3), dtype=np.uint8)
    img[0, :3] = [[0, 255, 128]] * 3
    np.testing.assert_array_equal(image_ops.add_scalar(img, beta),
                                  cv2.add(img, (beta, beta, beta, 0)))


@pytest.mark.parametrize("value", [(104, 117, 123), (104.5, 117.5, -3.0), (255.6, 0.4, 2.5)])
def test_pad_constant_bit_exact(value):
    img = np.random.default_rng(6).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    for pads in ((1, 2, 3, 4), (0, 0, 0, 9), (6, 0, 0, 0)):
        got = image_ops.pad_constant(img, *pads, value)
        want = cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT,
                                  value=tuple(float(c) for c in value))
        np.testing.assert_array_equal(got, want)
