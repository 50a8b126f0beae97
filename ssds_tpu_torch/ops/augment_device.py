"""Batched augmentation on the device (counterpart of
:mod:`ssds_tpu.ops.augment_device`, ``DATASET.DEVICE_AUG``).

The host recipe's distribution (``data/augment.py::preproc``), run on a
whole batch inside the train step, so that the host loader only resizes.
The JAX module's docstring (``ssds_tpu/ops/augment_device.py:1-48``) is the
spec; in short, per image:

- one coin ``U < prob`` selects the augmented branch; outside it the image
  and its boxes pass through untouched;
- inside it: photometric distortion on RAW ``[0, 255]`` values (brightness
  +-32, contrast x[0.5, 1.5], saturation as a mix with the per-pixel channel
  mean x[0.5, 1.5], hue as a rotation about the gray axis by U[-36, 36]
  degrees; each with its own coin and a clip after every op), then an
  IoU-constrained crop (min-IoU mode from ``(None, .1, .3, .5, .7, .9)``,
  the first of 16 candidates whose IoU with every GT box clears it and that
  holds a GT centre) composed with an expand (its own ``U < prob`` gate,
  canvas scale U[1, 4]) into one per-axis affine, resampled once on the
  mean-subtracted pixels (so the fill is the host's mean fill), the boxes
  through the same affine (a centre outside the canvas drops a box, then a
  clip, then the host's 0.005 degenerate-side rule), the empty-target guard
  (an image that had boxes and would keep none takes its original back),
  and a horizontal flip (its own coin, gated by the branch and the guard).

The module has two halves so that a test can feed JAX's own draws:

- :func:`sample_params` draws every random quantity for the batch from a
  ``torch.Generator`` on the device, vectorised over the batch and the 16
  crop candidates: :class:`AugParams`;
- :func:`apply_params` is deterministic: candidate selection, the composed
  affine, the resample, the boxes, the guard and the flip.

:func:`augment_batch` is the two in turn. The resample is
``jax.image.scale_and_translate(..., method="linear")`` with its default
antialiasing: a triangle kernel widened by ``1 / scale`` where the affine
shrinks (an expand), each output's weights renormalised to sum to 1, zero
weight for samples outside ``[-0.5, n_in - 0.5]``, computed per image in
float32 with ``compute_weight_mat``'s operations (the per-image form of
:func:`ssds_tpu_torch.models.layers._resize_weights`) and applied as two
batched contractions. Neither ``F.grid_sample`` nor ``F.interpolate``
antialiases this way.

One fault of the reference is kept (``ssds_tpu/ops/augment_device.py:250``,
ROADMAP.md §3): an image with no GT box is still augmented (its crop is the
identity, but its expand, photometric and flip apply), where the host
passes it through.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

N_CROP_CANDIDATES = 16
CROP_MIN_IOUS = (-1.0, 0.1, 0.3, 0.5, 0.7, 0.9)  # -1: mode None (no crop)
_F32_EPS = 1.1920928955078125e-07  # np.finfo(np.float32).eps


class AugParams(NamedTuple):
    """Every random draw for a batch of ``B`` images (float32 unless named).

    ``do_aug [B]`` bool: the branch coin. Crop: ``crop_min_iou [B]`` (-1 for
    mode None) and the ``K`` candidates ``crop_x``, ``crop_y`` (top-left),
    ``crop_w``, ``crop_h`` ``[B, K]``, normalised. Expand: ``expand [B]``
    bool, the canvas ``expand_w``, ``expand_h`` (in image widths and heights,
    >= 1) and the image's offset in it ``expand_left``, ``expand_top`` (in
    image units) ``[B]``. Photometric: ``photo [B, 4]`` bool coins
    (brightness, contrast, saturation, hue) and the magnitudes
    ``brightness``, ``contrast``, ``saturation``, ``hue_deg`` ``[B]``.
    ``flip [B]`` bool."""

    do_aug: torch.Tensor
    crop_min_iou: torch.Tensor
    crop_x: torch.Tensor
    crop_y: torch.Tensor
    crop_w: torch.Tensor
    crop_h: torch.Tensor
    expand: torch.Tensor
    expand_w: torch.Tensor
    expand_h: torch.Tensor
    expand_left: torch.Tensor
    expand_top: torch.Tensor
    photo: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue_deg: torch.Tensor
    flip: torch.Tensor


def sample_params(generator: torch.Generator, boxes: torch.Tensor, valid: torch.Tensor,
                  prob: float) -> AugParams:
    """Draw :class:`AugParams` for a batch (``boxes [B, G, 4]`` and ``valid``
    give the batch size and the device) from ``generator``, with the JAX
    module's laws: ``U[lo, hi)`` is ``max(lo, u * (hi - lo) + lo)`` as
    ``jax.random.uniform`` computes it, a coin is ``u < 0.5``."""
    b, k, dev = boxes.shape[0], N_CROP_CANDIDATES, boxes.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def uniform(shape, lo, hi):
        x = u(*shape) * (hi - lo) + lo
        return torch.maximum(x, lo) if torch.is_tensor(lo) else torch.clamp_min(x, lo)

    do_aug = u(b) < prob
    # the menu by index, from scalars: a table copied to the card would
    # synchronise the host with the device at every step
    mode = torch.randint(0, len(CROP_MIN_IOUS), (b,), generator=generator, device=dev)
    crop_min_iou = torch.full((b,), CROP_MIN_IOUS[0], device=dev)
    for i, v in enumerate(CROP_MIN_IOUS[1:], 1):
        crop_min_iou = torch.where(mode == i, v, crop_min_iou)
    scale = uniform((b, k), 0.3, 1.0)
    s2 = scale * scale
    lo, hi = torch.clamp_min(s2, 0.5), torch.clamp_max(1.0 / s2, 2.0)
    ratio = torch.sqrt(uniform((b, k), lo, hi))
    crop_w, crop_h = scale * ratio, scale / ratio
    crop_x, crop_y = u(b, k) * (1.0 - crop_w), u(b, k) * (1.0 - crop_h)

    expand = u(b) < prob
    escale = uniform((b,), 1.0, 4.0)
    s2 = escale * escale
    lo, hi = torch.clamp_min(1.0 / s2, 0.5), torch.clamp_max(s2, 2.0)
    eratio = torch.sqrt(uniform((b,), lo, hi))
    expand_w, expand_h = escale * eratio, escale / eratio
    expand_left, expand_top = u(b) * (expand_w - 1.0), u(b) * (expand_h - 1.0)

    photo = u(b, 4) < 0.5
    return AugParams(
        do_aug=do_aug, crop_min_iou=crop_min_iou, crop_x=crop_x, crop_y=crop_y, crop_w=crop_w,
        crop_h=crop_h, expand=expand, expand_w=expand_w, expand_h=expand_h,
        expand_left=expand_left, expand_top=expand_top, photo=photo,
        brightness=uniform((b,), -32.0, 32.0), contrast=uniform((b,), 0.5, 1.5),
        saturation=uniform((b,), 0.5, 1.5), hue_deg=uniform((b,), -36.0, 36.0),
        flip=u(b) < 0.5)


def crop_affine(boxes: torch.Tensor, valid: torch.Tensor, p: AugParams):
    """The crop's per-axis affine ``(ax, ay, bx, by)``, ``[B]`` each
    (``n_out = a * n_in + b``): the first passing candidate, or the identity
    for mode None or when none passes (``_sample_crop`` after its draws)."""
    rx, ry, rw, rh = p.crop_x, p.crop_y, p.crop_w, p.crop_h  # [B, K]
    roi = torch.stack([rx, ry, rx + rw, ry + rh], dim=-1)   # [B, K, 4]
    lt = torch.maximum(boxes[:, :, None, :2], roi[:, None, :, :2])  # [B, G, K, 2]
    rb = torch.minimum(boxes[:, :, None, 2:], roi[:, None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    side = torch.clamp_min(boxes[..., 2:] - boxes[..., :2], 0.0)
    area_b = side[..., 0] * side[..., 1]                    # [B, G]
    area_r = rw * rh                                        # [B, K]
    iou = inter / torch.clamp_min(area_b[:, :, None] + area_r[:, None, :] - inter, 1e-12)
    iou_min = torch.where(valid[:, :, None], iou, torch.inf).amin(dim=1)  # [B, K]

    centers = (boxes[..., :2] + boxes[..., 2:]) / 2        # [B, G, 2]
    cx, cy = centers[:, :, None, 0], centers[:, :, None, 1]
    inside = ((roi[:, None, :, 0] < cx) & (cx < roi[:, None, :, 2])
              & (roi[:, None, :, 1] < cy) & (cy < roi[:, None, :, 3]))  # [B, G, K]
    any_center = (inside & valid[:, :, None]).any(dim=1)                  # [B, K]

    passing = (iou_min >= p.crop_min_iou[:, None]) & any_center & valid.any(dim=1)[:, None]
    k = passing.shape[1]
    index = torch.arange(k, device=boxes.device)
    chosen = torch.where(passing, index, k).amin(dim=1).clamp_max(k - 1)[:, None]  # first
    do_crop = passing.any(dim=1) & (p.crop_min_iou >= 0.0)
    rwc, rhc = rw.gather(1, chosen)[:, 0], rh.gather(1, chosen)[:, 0]
    rxc, ryc = rx.gather(1, chosen)[:, 0], ry.gather(1, chosen)[:, 0]
    one, zero = torch.ones_like(rwc), torch.zeros_like(rwc)
    return (torch.where(do_crop, 1.0 / rwc, one), torch.where(do_crop, 1.0 / rhc, one),
            torch.where(do_crop, -rxc / rwc, zero), torch.where(do_crop, -ryc / rhc, zero))


def expand_affine(p: AugParams):
    """The expand's per-axis affine ``(ax, ay, bx, by)``, ``[B]`` each
    (``_sample_expand`` after its draws)."""
    one, zero = torch.ones_like(p.expand_w), torch.zeros_like(p.expand_w)
    return (torch.where(p.expand, 1.0 / p.expand_w, one),
            torch.where(p.expand, 1.0 / p.expand_h, one),
            torch.where(p.expand, p.expand_left / p.expand_w, zero),
            torch.where(p.expand, p.expand_top / p.expand_h, zero))


def photometric(img_raw: torch.Tensor, p: AugParams) -> torch.Tensor:
    """The host's distortion on RAW ``[B, H, W, 3]`` values in ``[0, 255]``,
    clipped after every op (``_photometric`` after its draws)."""

    def each(v):
        return v[:, None, None, None]

    gate = p.photo
    img = img_raw
    img = torch.where(each(gate[:, 0]), torch.clamp(img + each(p.brightness), 0.0, 255.0), img)
    img = torch.where(each(gate[:, 1]), torch.clamp(img * each(p.contrast), 0.0, 255.0), img)
    luma = img.mean(dim=-1, keepdim=True)
    img = torch.where(each(gate[:, 2]),
                      torch.clamp(luma + (img - luma) * each(p.saturation), 0.0, 255.0), img)
    # hue: a rotation about the gray axis; each column of the matrix sums to 1
    theta = p.hue_deg * torch.tensor(math.pi / 180.0, dtype=torch.float32)
    c, s = torch.cos(theta), torch.sin(theta)
    k = (1.0 - c) / 3.0
    sq = s / torch.sqrt(torch.tensor(3.0, dtype=torch.float32))
    rot = torch.stack([torch.stack([c + k, k - sq, k + sq], -1),
                       torch.stack([k + sq, c + k, k - sq], -1),
                       torch.stack([k - sq, k + sq, c + k], -1)], -2)  # [B, 3, 3]
    b, h, w, _ = img.shape
    hue = torch.bmm(img.reshape(b, h * w, 3), rot.transpose(1, 2)).reshape(b, h, w, 3)
    hue = torch.clamp(hue, 0.0, 255.0)
    return torch.where(each(gate[:, 3]), hue, img)


def resample_weights(n: int, scale: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """``[B, n_out, n_in]`` (``n_out == n_in == n``) float32 weights of
    ``jax.image.scale_and_translate``'s linear kernel with antialiasing, for
    per-image ``scale`` and ``translation`` (in pixels) ``[B]``, in
    ``compute_weight_mat``'s operation order."""
    dev = scale.device
    inv = 1.0 / scale
    kernel_scale = torch.clamp_min(inv, 1.0)
    grid = torch.arange(n, dtype=torch.float32, device=dev)
    sample = (grid + 0.5)[None, :] * inv[:, None] - (translation * inv)[:, None] - 0.5
    x = torch.abs(sample[:, :, None] - grid[None, None, :]) / kernel_scale[:, None, None]
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def resample(img: torch.Tensor, ax, ay, bx, by) -> torch.Tensor:
    """``[B, H, W, C]`` through the per-axis affine (normalised ``a``, ``b``),
    zero outside: ``_apply_affine_image``."""
    b, h, w, c = img.shape
    wy = resample_weights(h, ay, by * h)  # [B, H_out, H_in]
    wx = resample_weights(w, ax, bx * w)  # [B, W_out, W_in]
    rows = torch.bmm(wy, img.reshape(b, h, w * c))  # [B, H, W * C]
    # W to the middle, so that the second contraction is one batched product too
    cols = torch.bmm(wx, rows.reshape(b, h, w, c).transpose(1, 2).reshape(b, w, h * c))
    return cols.reshape(b, w, h, c).transpose(1, 2).contiguous()


def affine_boxes(boxes: torch.Tensor, valid: torch.Tensor, ax, ay, bx, by):
    """Corner boxes ``[B, G, 4]`` through the affine: a centre outside the
    canvas drops a box, survivors are clipped, a side <= 0.005 drops one."""
    ax, ay, bx, by = (v[:, None] for v in (ax, ay, bx, by))
    out = torch.stack([boxes[..., 0] * ax + bx, boxes[..., 1] * ay + by,
                       boxes[..., 2] * ax + bx, boxes[..., 3] * ay + by], dim=-1)
    cx = (out[..., 0] + out[..., 2]) / 2
    cy = (out[..., 1] + out[..., 3]) / 2
    inside = (cx > 0) & (cx < 1) & (cy > 0) & (cy < 1)
    out = torch.clamp(out, 0.0, 1.0)
    min_side = torch.minimum(out[..., 2] - out[..., 0], out[..., 3] - out[..., 1])
    return out, valid & inside & (min_side > 0.005)


def apply_params(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                 params: AugParams, means):
    """Apply drawn ``params`` to ``images [B, H, W, 3]`` (float32, already
    mean-subtracted with ``means``: three values, or a float32 tensor on
    ``images``' device, which spares a copy to the card), ``boxes [B, G, 4]``
    (normalised corners) and ``valid [B, G]``; returns the three transformed
    (``augment_batch``'s body)."""
    p = params
    images = images.float()
    means_v = torch.as_tensor(means, dtype=torch.float32, device=images.device)

    def each(v):
        return v[:, None, None, None]

    img_out = torch.where(each(p.do_aug), photometric(images + means_v, p) - means_v, images)
    cax, cay, cbx, cby = crop_affine(boxes, valid, p)
    eax, eay, ebx, eby = expand_affine(p)
    ax, ay = cax * eax, cay * eay
    abx, aby = cbx * eax + ebx, cby * eay + eby
    ident = ~p.do_aug
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    ax, ay = torch.where(ident, one, ax), torch.where(ident, one, ay)
    abx, aby = torch.where(ident, zero, abx), torch.where(ident, zero, aby)

    new_img = resample(img_out, ax, ay, abx, aby)
    new_bx, new_vd = affine_boxes(boxes, valid, ax, ay, abx, aby)
    keep = ~(valid.any(dim=1) & ~new_vd.any(dim=1))  # the empty-target guard
    img_out = torch.where(each(keep), new_img, images)
    bx_out = torch.where(keep[:, None, None], new_bx, boxes)
    vd_out = torch.where(keep[:, None], new_vd, valid)

    do_flip = p.flip & p.do_aug & keep
    img_out = torch.where(each(do_flip), img_out.flip(2), img_out)
    flipped = torch.stack([1.0 - bx_out[..., 2], bx_out[..., 1], 1.0 - bx_out[..., 0],
                           bx_out[..., 3]], dim=-1)
    bx_out = torch.where(do_flip[:, None, None], flipped, bx_out)
    return img_out, bx_out, vd_out


@torch.no_grad()
def augment_batch(generator: torch.Generator, images: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, prob: float = 0.6, means=(104.0, 117.0, 123.0),
                  shard=(0, 1)):
    """The host recipe on a whole batch on the device: :func:`sample_params`
    from ``generator`` (on ``images``' device), then :func:`apply_params`.
    ``images``: ``[B, H, W, 3]`` float32, mean-subtracted with ``means``
    (``DATASET.PIXEL_MEANS``, as :func:`apply_params` takes them); ``prob``:
    ``DATASET.PROB``. Nothing here waits for the device.

    ``shard = (rank, world)``: the batch is rows ``[rank * B, (rank + 1) *
    B)`` of a global batch of ``world * B`` (data parallelism). The draws
    are the global batch's, from the same generator state on every rank, and
    this rank applies its rows, so the ranks together augment as one process
    does the global batch. :func:`sample_params` reads the batch's size
    alone, so no rank needs another's boxes."""
    rank, world = shard
    if world == 1:
        return apply_params(images, boxes, valid, sample_params(generator, boxes, valid, prob),
                            means)
    b = boxes.shape[0]
    params = sample_params(generator, boxes.new_zeros((world * b,) + boxes.shape[1:]),
                           valid.new_zeros((world * b,) + valid.shape[1:]), prob)
    mine = AugParams(*(t[rank * b:(rank + 1) * b] for t in params))
    return apply_params(images, boxes, valid, mine, means)
