"""The SSD train-time augmentation recipe (host-side numpy).

A copy of :mod:`ssds_tpu.data.augment` (reference
``lib/utils/data_augment.py``): ``preproc.__call__`` chains

1. ``_crop``    — random IoU-constrained sample crop: a min-IoU from
   ``{None, 0.1, 0.3, 0.5, 0.7, 0.9}``, up to 50 tries for a crop of scale
   [0.3, 1] and aspect [0.5, 2] meeting it; only boxes whose centres fall
   inside are kept, translated and clipped;
2. ``_distort`` — random brightness/contrast and saturation/hue;
3. ``_mirror``  — horizontal flip;
4. ``_expand``  — with probability ``prob``, the image on a 1-4x mean-filled
   canvas, fused here with the final resize;
5. the resize to IMAGE_SIZE, skipped when the image is already that size
   (a resize to the same size is the identity).

Images leave as uint8 HWC BGR; the mean subtraction runs on the device.
Empty-target guard: if augmentation leaves no box, the unaugmented image
and targets pass through; an image with no GT returns one all-zero row.

Every image operation is :mod:`ssds_tpu_torch.data.image_ops`, numpy that
equals the JAX package's OpenCV calls bit for bit, so the recipe runs on a
machine without OpenCV. ``_crop`` samples with the native C++ sampler
(:mod:`ssds_tpu_torch.data.native`, built from the port's copy of the JAX
package's ``native/ssd_augment.cpp``) exactly where the JAX package does; its
Python retry loop is the plain version, run when ``native.available()`` is
false.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

from ssds_tpu_torch.data import image_ops, native


def _matrix_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for corner-form pixel boxes: [A,4] x [B,4] -> [A,B]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def _crop(image, boxes, labels):
    """Random IoU-constrained sample crop (reference ``_crop``): the native
    sampler, seeded from ``random`` as the JAX package seeds it, or the
    Python loop when the sampler is switched off."""
    height, width = image.shape[:2]
    if len(boxes) == 0:
        return image, boxes, labels

    if native.available():
        res = native.sample_crop(boxes, width, height, seed=random.getrandbits(63))
        if res is None:
            return image, boxes, labels
        roi, mask = res
        image_t = image[int(roi[1]):int(roi[3]), int(roi[0]):int(roi[2])]
        return image_t, native.crop_boxes(boxes[mask], roi), labels[mask].copy()

    while True:
        mode = random.choice((None, (0.1, None), (0.3, None), (0.5, None), (0.7, None), (0.9, None)))
        if mode is None:
            return image, boxes, labels
        min_iou, max_iou = mode
        min_iou = -float("inf") if min_iou is None else min_iou
        max_iou = float("inf") if max_iou is None else max_iou

        for _ in range(50):
            scale = random.uniform(0.3, 1.0)
            min_ratio = max(0.5, scale * scale)
            max_ratio = min(2.0, 1.0 / scale / scale)
            ratio = np.sqrt(random.uniform(min_ratio, max_ratio))
            w = int(scale * ratio * width)
            h = int(scale / ratio * height)
            left = random.randrange(width - w + 1)
            top = random.randrange(height - h + 1)
            roi = np.array([left, top, left + w, top + h], dtype=np.float32)

            iou = _matrix_iou(boxes, roi[None])
            if not (min_iou <= iou.min() and iou.max() <= max_iou):
                continue

            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            mask = np.logical_and(roi[:2] < centers, centers < roi[2:]).all(axis=1)
            if not mask.any():
                continue

            image_t = image[roi[1].astype(int):roi[3].astype(int),
                            roi[0].astype(int):roi[2].astype(int)]
            boxes_t = boxes[mask].copy()
            labels_t = labels[mask].copy()
            boxes_t[:, :2] = np.maximum(boxes_t[:, :2], roi[:2]) - roi[:2]
            boxes_t[:, 2:] = np.minimum(boxes_t[:, 2:], roi[2:]) - roi[:2]
            return image_t, boxes_t, labels_t


def _distort(image):
    """Random photometric distortion (reference ``_distort``), on uint8 with
    saturating arithmetic."""
    do_bright, do_contrast = random.randrange(2), random.randrange(2)
    alpha = random.uniform(0.5, 1.5) if do_contrast else 1.0
    beta = random.uniform(-32, 32) if do_bright else 0.0
    if do_bright or do_contrast:
        if do_bright:
            # saturates at both ends, as the reference's np.clip
            image = image_ops.add_scalar(image, beta)
        if do_contrast:
            image = image_ops.convert_scale_abs(image, alpha=alpha, beta=0.0)
    else:
        image = image.copy()
    hsv = image_ops.bgr_to_hsv(image)
    if random.randrange(2):  # saturation scale
        s_alpha = random.uniform(0.5, 1.5)
        hsv[:, :, 1] = image_ops.convert_scale_abs(hsv[:, :, 1], alpha=s_alpha)
    if random.randrange(2):  # hue rotation (uint8 H is 0..179)
        shift = random.randint(-18, 18)
        lut = ((np.arange(256) + shift) % 180).astype(np.uint8)
        hsv[:, :, 0] = lut[hsv[:, :, 0]]
    return image_ops.hsv_to_bgr(hsv)


def _expand(image, boxes, fill, prob):
    """Random zoom-out onto a mean-filled canvas (reference ``_expand``);
    :class:`preproc` samples the same geometry with :func:`_expand_params`."""
    if random.random() > prob or len(boxes) == 0:
        return image, boxes
    height, width, _ = image.shape
    for _ in range(50):
        scale = random.uniform(1.0, 4.0)
        min_ratio = max(0.5, 1.0 / scale / scale)
        max_ratio = min(2.0, scale * scale)
        ratio = np.sqrt(random.uniform(min_ratio, max_ratio))
        ws = scale * ratio
        hs = scale / ratio
        if ws < 1 or hs < 1:
            continue
        w = int(ws * width)
        h = int(hs * height)
        left = random.randint(0, w - width)
        top = random.randint(0, h - height)
        boxes_t = boxes.copy()
        boxes_t[:, :2] += (left, top)
        boxes_t[:, 2:] += (left, top)
        expand_image = image_ops.pad_constant(
            image, top, h - height - top, left, w - width - left, fill)
        return expand_image, boxes_t
    return image, boxes


def _expand_params(width, height, prob):
    """Sample the zoom-out canvas (reference ``_expand``'s distribution)
    without building it: ``(canvas_w, canvas_h, left, top)`` or None."""
    if random.random() > prob:
        return None
    for _ in range(50):
        scale = random.uniform(1.0, 4.0)
        min_ratio = max(0.5, 1.0 / scale / scale)
        max_ratio = min(2.0, scale * scale)
        ratio = np.sqrt(random.uniform(min_ratio, max_ratio))
        ws = scale * ratio
        hs = scale / ratio
        if ws < 1 or hs < 1:
            continue
        w = int(ws * width)
        h = int(hs * height)
        left = random.randint(0, w - width)
        top = random.randint(0, h - height)
        return w, h, left, top
    return None


def _mirror(image, boxes):
    """Random horizontal flip (reference ``_mirror``)."""
    if random.randrange(2):
        _, width, _ = image.shape
        image = image[:, ::-1]
        boxes = boxes.copy()
        boxes[:, 0::2] = width - boxes[:, 2::-2]
    return image, boxes


def _resize(image: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to ``(h, w)``; the image itself when already that size."""
    if image.shape[:2] == tuple(hw):
        return image
    return image_ops.resize_linear(image, hw)


def preproc_for_test(image: np.ndarray, insize: Tuple[int, int], mean) -> np.ndarray:
    """Resize + BGR mean subtraction, HWC float32 (reference, minus the CHW
    transpose)."""
    return _resize(image, insize).astype(np.float32) - np.asarray(mean, np.float32)


class preproc:
    """Train/eval preprocessing callable (reference ``class preproc``).

    ``p`` (cfg.DATASET.PROB) is the augmentation probability; ``p = -1``
    selects the eval path (resize only). Images leave as resized uint8; the
    mean subtraction runs on the device. ``rgb_means`` fills the expand
    canvas, as the reference's mean-filled canvas.
    """

    def __init__(self, resize, rgb_means, p):
        self.resize = (int(resize[0]), int(resize[1]))
        self.means = rgb_means
        self.p = p

    def __call__(self, image: np.ndarray, targets: np.ndarray):
        """image: HWC BGR uint8; targets: [N, 5] pixel (x1,y1,x2,y2,label).

        Returns (image HWC uint8 at model size, targets [M, 5]) with box
        coords normalized to [0, 1].
        """
        targets = np.asarray(targets, np.float32).reshape(-1, 5)
        boxes = targets[:, :4].copy()
        labels = targets[:, 4].copy()

        if self.p == -1 or len(boxes) == 0 or random.random() > self.p:
            return self._passthrough(image, boxes, labels)

        image_o, boxes_o, labels_o = image, boxes.copy(), labels.copy()
        image_t, boxes_t, labels_t = _crop(image, boxes, labels)
        image_t = _distort(image_t)
        # mirror before expand, so expand fuses with the final resize: equal
        # in distribution to the reference's expand-then-mirror (the flip
        # maps the canvas offset `left` to `w - width - left`, which has the
        # same uniform law); ssds_tpu/data/augment.py gives the argument
        image_t, boxes_t = _mirror(image_t, boxes_t)

        height, width = image_t.shape[:2]
        out_h, out_w = self.resize
        # the reference's _expand gates on self.p (cfg.DATASET.PROB), not 0.5
        exp = _expand_params(width, height, self.p) if len(boxes_t) else None
        boxes_t = boxes_t.copy()
        if exp is None:
            image_t = _resize(image_t, self.resize)
            boxes_t[:, 0::2] /= width
            boxes_t[:, 1::2] /= height
        else:
            # the image, resized straight to its sub-rectangle, on an
            # output-sized mean canvas: the same pixels as resizing the
            # whole canvas (bilinear over a uniform fill is uniform)
            cw, ch, left, top = exp
            x1 = int(round(left / cw * out_w))
            y1 = int(round(top / ch * out_h))
            x2 = max(x1 + 1, int(round((left + width) / cw * out_w)))
            y2 = max(y1 + 1, int(round((top + height) / ch * out_h)))
            canvas = np.empty((out_h, out_w, 3), image_t.dtype)
            canvas[:] = np.asarray(self.means, image_t.dtype)
            canvas[y1:y2, x1:x2] = image_ops.resize_linear(image_t, (y2 - y1, x2 - x1))
            image_t = canvas
            boxes_t[:, 0::2] = (boxes_t[:, 0::2] + left) / cw
            boxes_t[:, 1::2] = (boxes_t[:, 1::2] + top) / ch
        # drop degenerate boxes; with none left, the unaugmented image
        wh = boxes_t[:, 2:4] - boxes_t[:, 0:2]
        mask = np.minimum(wh[:, 0], wh[:, 1]) > 0.005
        if not mask.any():
            return self._passthrough(image_o, boxes_o, labels_o)
        boxes_t = boxes_t[mask]
        labels_t = labels_t[mask]
        return image_t, np.hstack([boxes_t, labels_t[:, None]])

    def _passthrough(self, image, boxes, labels):
        height, width = image.shape[:2]
        image = _resize(image, self.resize)
        if len(boxes) == 0:
            return image, np.zeros((1, 5), np.float32)
        boxes = boxes.copy()
        boxes[:, 0::2] /= width
        boxes[:, 1::2] /= height
        return image, np.hstack([boxes, labels[:, None]])
