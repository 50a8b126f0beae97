"""numpy versions of the host's OpenCV image calls, on uint8 HWC BGR images.

The card's machine has no OpenCV, so the port resizes and augments with
these. Each function reproduces the integer or float32 arithmetic of OpenCV
5.0.0's x86-64 build on a CPU with AVX2 (the code path it dispatches to
there, with or without AVX-512; on SSE4 alone its HSV->BGR splits a row
differently), which the JAX package calls, so that the port's images equal
the JAX package's bit for bit
(``tests/test_torch_port_image_ops.py`` holds each against its cv2 call):

============================  ==============================================
function                      cv2 call
============================  ==============================================
:func:`resize_linear`         ``cv2.resize(img, (w, h), INTER_LINEAR)``
:func:`bgr_to_hsv`            ``cv2.cvtColor(img, COLOR_BGR2HSV)`` (H in [0, 180))
:func:`hsv_to_bgr`            ``cv2.cvtColor(img, COLOR_HSV2BGR)``
:func:`convert_scale_abs`     ``cv2.convertScaleAbs(img, alpha=a, beta=b)``
:func:`add_scalar`            ``cv2.add(img, (beta, beta, beta, 0))``
:func:`pad_constant`          ``cv2.copyMakeBorder(..., BORDER_CONSTANT, value)``
============================  ==============================================

``cv2.LUT`` is numpy indexing and needs no function here.
"""

from __future__ import annotations

import functools

import numpy as np

# cv2's fixed-point bilinear taps: weights quantised to 11 bits
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_F32 = np.float32


def _linear_taps(src: int, dst: int, clamp: bool):
    """Source indices and 11-bit weights of each output position along one
    axis: ``(i0, i1, w0, w1)``, int32.

    The position ``(d + 0.5) * scale - 0.5`` is computed in double and
    rounded to float32, its fraction in float32, and ``1 - f`` and ``f``
    quantised by round-half-to-even. Along x (``clamp``) a position left of
    the first pixel or right of the last takes that pixel with weight 2048;
    along y the fraction is kept and both taps read the edge row, as cv2's
    row clamp does, so ``w0 + w1`` may be 2047 or 2049 there.
    """
    scale = 1.0 / (dst / src)  # cv2: scale = 1 / inv_scale, inv_scale = dst / src
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(_F32)
    i = np.floor(f)
    f = (f - i).astype(_F32)
    i = i.astype(np.int64)
    if clamp:
        lo = i < 0
        f[lo], i[lo] = 0, 0
        hi = i >= src - 1
        f[hi], i[hi] = 0, src - 1
    w0 = np.rint((_F32(1) - f) * _F32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * _F32(_COEF_SCALE)).astype(np.int32)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, hw) -> np.ndarray:
    """Bilinear resize of a uint8 ``[H, W, C]`` (or ``[H, W]``) image to
    ``hw = (h, w)``, bit-equal to ``cv2.resize(img, (w, h), INTER_LINEAR)``.

    The horizontal pass sums two taps in int; the vertical pass rounds as
    cv2's vector code does, ``(((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16)
    + 2) >> 2``. cv2 routes an exact 2x downscale to INTER_AREA, whose
    ``(a + b + c + d + 2) >> 2`` this formula equals at weights 1024. The
    work is proportional to the output: only the source rows and columns
    that the taps read are gathered.
    """
    dh, dw = int(hw[0]), int(hw[1])
    sh, sw = img.shape[:2]
    if (sh, sw) == (dh, dw):
        return img.copy()
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, got {img.dtype}")
    x0, x1, a0, a1 = _linear_taps(sw, dw, clamp=True)
    y0, y1, b0, b1 = _linear_taps(sh, dh, clamp=False)
    extra = (None,) * (img.ndim - 2)
    a0, a1 = a0[(slice(None),) + extra], a1[(slice(None),) + extra]
    b0, b1 = (b[(slice(None), None) + extra] for b in (b0, b1))
    # the horizontal pass over the source rows the taps read, then the vertical
    rows = np.unique(np.concatenate([y0, y1]))
    src = np.take(img, rows, axis=0)
    hor = (np.take(src, x0, axis=1).astype(np.int32) * a0
           + np.take(src, x1, axis=1).astype(np.int32) * a1) >> 4
    out = ((np.take(hor, np.searchsorted(rows, y0), axis=0) * b0) >> 16) \
        + ((np.take(hor, np.searchsorted(rows, y1), axis=0) * b1) >> 16)
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


# cv2's 8-bit HSV division tables: round((255 << 12) / i), round((180 << 12) / (6 i))
_HSV_SHIFT = 12


@functools.lru_cache(maxsize=None)
def _bgr_to_hsv_tables():
    """``(hue[(num + 255) * 256 + diff], sat[v * 256 + diff])``: cv2's
    ``(num * hdiv[diff] + 2048) >> 12`` (wrapped into [0, 180)) and
    ``(diff * sdiv[v] + 2048) >> 12`` for every 8-bit input."""
    i = np.arange(1, 256)
    sdiv, hdiv = np.zeros(256, np.int64), np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    half = 1 << (_HSV_SHIFT - 1)
    diff = np.arange(256)[None, :]
    num = np.arange(-255, 5 * 255 + 1)[:, None]  # g - b, b - r + 2 diff, r - g + 4 diff
    hue = (num * hdiv[diff] + half) >> _HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    sat = (diff * sdiv[np.arange(256)[:, None]] + half) >> _HSV_SHIFT
    return (np.clip(hue, 0, 255).astype(np.uint8).ravel(), sat.astype(np.uint8).ravel())


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR -> uint8 HSV with H in [0, 180), cv2's integer arithmetic:
    ``v = max``, ``diff = v - min``, the hue's numerator by which channel is
    the max (R first, then G), and both divisions through cv2's tables."""
    hue_tab, sat_tab = _bgr_to_hsv_tables()
    b8, g8, r8 = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(b8, g8), r8)
    diff = v - np.minimum(np.minimum(b8, g8), r8)
    b, g, r, d = (a.astype(np.int16) for a in (b8, g8, r8, diff))
    num = np.where(v == r8, g - b, np.where(v == g8, b - r + 2 * d, r - g + 4 * d))
    out = np.empty(img.shape, np.uint8)
    out[..., 0] = hue_tab[(num.astype(np.int32) + 255) * 256 + d]
    out[..., 1] = sat_tab[v.astype(np.int32) * 256 + d]
    out[..., 2] = v
    return out


# which of (v, v(1-s), v(1-s f), v(1-s(1-f))) each hue sector gives B, G, R
_SECTOR_TAB = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# cv2 converts each row's whole 32-pixel blocks with vectors (the result
# truncated to uint8) and the rest of the row one pixel at a time (rounded)
_HSV2BGR_BLOCK = 32


def _fnma(a, b, c):
    """float32 ``c - a * b`` with one rounding (a fused multiply-add): the
    float32 product is exact in float64, so one float64 add and the cast
    round as the fused instruction does over cv2's 8-bit inputs (the test
    covers every one of them)."""
    return (c.astype(np.float64) - a.astype(np.float64) * b.astype(np.float64)).astype(_F32)


@functools.lru_cache(maxsize=None)
def _hsv_to_bgr_table():
    """``[h * 256 + s, 3]`` float32: what ``v / 255`` is multiplied by for
    B, G and R. With ``s`` scaled by ``1/255`` and ``f`` the hue's fraction
    within its 60-degree sector, a sector's four values are ``1``,
    ``1 - s``, ``fma(-s, f, 1)`` and ``fma(-s, 1 - f, 1)``."""
    h = np.arange(180, dtype=_F32)[:, None] * (_F32(6) / _F32(180))
    sector = np.floor(h)
    f = np.broadcast_to((h - sector).astype(_F32), (180, 256))
    s = np.broadcast_to(np.arange(256, dtype=_F32) * (_F32(1) / _F32(255)), (180, 256))
    one = np.ones((180, 256), _F32)
    tab = np.stack([one, one - s, _fnma(s, f, one), _fnma(s, one - f, one)], -1)
    pick = _SECTOR_TAB[np.broadcast_to(sector.astype(np.int64) % 6, (180, 256))]
    return np.take_along_axis(tab, pick, axis=-1).reshape(-1, 3)


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) -> uint8 BGR, bit-equal to cv2 5.0.0: in
    float32, ``(v / 255 * t) * 255`` for ``t`` from :func:`_hsv_to_bgr_table`,
    truncated in the vector body of each row and rounded half to even in its
    tail (``_HSV2BGR_BLOCK``)."""
    idx = img[..., 0].astype(np.int32) * 256 + img[..., 1]
    out = np.take(_hsv_to_bgr_table(), idx, axis=0)
    out *= (img[..., 2].astype(_F32) * (_F32(1) / _F32(255)))[..., None]
    out *= _F32(255)
    width = img.shape[-2]
    body = width - width % _HSV2BGR_BLOCK
    res = np.empty(out.shape, np.uint8)
    res[..., :body, :] = out[..., :body, :]  # the cast truncates (values in [0, 255])
    res[..., body:, :] = np.rint(out[..., body:, :])
    return res


def convert_scale_abs(img: np.ndarray, alpha: float = 1.0, beta: float = 0.0) -> np.ndarray:
    """``saturate(round(|x * alpha + beta|))`` in float32, as cv2's (a
    function of the 8-bit value alone, so applied as a 256-entry table)."""
    out = np.abs(np.arange(256, dtype=_F32) * _F32(alpha) + _F32(beta))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)[img]


def _saturate_u8(value: float) -> int:
    """cv2's ``saturate_cast<uchar>(double)``: round half to even, clip."""
    return int(np.clip(np.rint(value), 0, 255))


def add_scalar(img: np.ndarray, beta: float) -> np.ndarray:
    """``cv2.add(img, (beta, beta, beta, 0))``: cv2 rounds the scalar half to
    even (in double), then adds with saturation at 0 and 255."""
    b = int(np.rint(beta))
    return np.clip(img.astype(np.int16) + b, 0, 255).astype(np.uint8)


def pad_constant(img: np.ndarray, top: int, bottom: int, left: int, right: int,
                 value) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right, BORDER_CONSTANT,
    value=value)`` on an ``[H, W, C]`` image; each channel's fill is
    saturated to uint8 as cv2 does."""
    h, w, c = img.shape
    out = np.empty((h + top + bottom, w + left + right, c), np.uint8)
    out[:] = np.array([_saturate_u8(value[k]) for k in range(c)], np.uint8)
    out[top:top + h, left:left + w] = img
    return out
