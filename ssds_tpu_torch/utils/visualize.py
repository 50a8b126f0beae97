"""Summary images and histograms (counterpart of :mod:`ssds_tpu.utils.visualize`).

Reference ``lib/utils/visualize_utils.py``: prior-box overlays (one per
feature-map level: the anchor shapes of the centre cell and the lattice of
cell centres), training samples with their ground truth, per-channel
feature-map grids and gradient histograms, written through a summary
writer's ``add_image`` / ``add_histogram``. The same functions on the same
inputs give the JAX package's images, tags and histograms bit for bit.

The JAX package draws with OpenCV; the card's machine has none, so the two
shapes it uses are drawn here in numpy, pixel for pixel as OpenCV draws them
(``tests/test_torch_port_visualize.py`` holds them to ``cv2``):
:func:`rectangle` is ``cv2.rectangle`` with thickness 1 and :func:`dot` is
``cv2.circle`` of radius 1, filled, both clipped to the image.
"""

from __future__ import annotations

import numpy as np


def rectangle(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.rectangle(img, p1, p2, color, 1)`` in place: the four 1-pixel
    edges of the box with corners ``p1``, ``p2`` (integer ``(x, y)``, either
    order, anywhere), the parts inside the image."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(p1[0]), int(p2[0])))
    y0, y1 = sorted((int(p1[1]), int(p2[1])))
    cx0, cx1 = max(x0, 0), min(x1, w - 1)
    cy0, cy1 = max(y0, 0), min(y1, h - 1)
    color = np.asarray(color, img.dtype)
    if cx0 <= cx1:
        for y in (y0, y1):
            if 0 <= y < h:
                img[y, cx0:cx1 + 1] = color
    if cy0 <= cy1:
        for x in (x0, x1):
            if 0 <= x < w:
                img[cy0:cy1 + 1, x] = color


def dot(img: np.ndarray, center, color) -> None:
    """``cv2.circle(img, center, 1, color, -1)`` in place: the centre pixel
    and its four neighbours, the parts inside the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    color = np.asarray(color, img.dtype)
    for x, y in ((cx, cy - 1), (cx - 1, cy), (cx, cy), (cx + 1, cy), (cx, cy + 1)):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def _to_chw_uint8(img_hwc_bgr: np.ndarray) -> np.ndarray:
    """float BGR HWC (mean-subtracted) -> uint8 RGB CHW for the writer."""
    img = img_hwc_bgr.astype(np.float32)
    img = img - img.min()
    if img.max() > 0:
        img = img / img.max()
    img = (img * 255).astype(np.uint8)
    return img[:, :, ::-1].transpose(2, 0, 1)


def draw_boxes(image_hwc: np.ndarray, boxes_norm: np.ndarray, color=(0, 255, 0)) -> np.ndarray:
    """A copy of an HWC image with normalised corner boxes drawn on it."""
    img = np.ascontiguousarray(image_hwc.copy())
    h, w = img.shape[:2]
    for b in np.asarray(boxes_norm).reshape(-1, 4):
        rectangle(img, (int(b[0] * w), int(b[1] * h)), (int(b[2] * w), int(b[3] * h)), color)
    return img


def _center_to_corner(priors: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [priors[:, :2] - priors[:, 2:] / 2, priors[:, :2] + priors[:, 2:] / 2], axis=1)


def level_slices(feature_maps, anchors_per_cell):
    """``[start, end)`` row ranges of each level inside the flat prior array.

    ``feature_maps``: ``[(H_k, W_k), ...]``; ``anchors_per_cell``: ``[A_k, ...]``
    (:func:`ssds_tpu_torch.ops.anchors.num_anchors_per_cell`). The flat array
    is the level-major concatenation ``generate_anchors`` produces.
    """
    out = []
    start = 0
    for (fh, fw), a in zip(feature_maps, anchors_per_cell):
        n = int(fh) * int(fw) * int(a)
        out.append((start, start + n))
        start += n
    return out


def viz_prior_box(writer, priors: np.ndarray, image_size, epoch: int = 0,
                  max_cells=3, feature_maps=None, anchors_per_cell=None):
    """Prior-box renders (reference ``viz_prior_box``).

    Always ``priors/center_cells``: the anchors of a few centre-most cells
    on one canvas. With ``feature_maps`` and ``anchors_per_cell``, one
    overlay a level, ``priors/level{k}``: every anchor shape of the level's
    centre cell (red) and the lattice of cell centres (blue dots).
    """
    h, w = int(image_size[0]), int(image_size[1])
    priors = np.asarray(priors)
    canvas = np.full((h, w, 3), 255, np.uint8)
    centers = priors[:, :2]
    mid = np.array([0.5, 0.5])
    order = np.argsort(np.sum((centers - mid) ** 2, axis=1))[: max_cells * 8]
    img = draw_boxes(canvas, _center_to_corner(priors[order]), color=(255, 0, 0))
    writer.add_image("priors/center_cells", _to_chw_uint8(img.astype(np.float32)), epoch)

    if feature_maps is None or anchors_per_cell is None:
        return
    for k, (start, end) in enumerate(level_slices(feature_maps, anchors_per_cell)):
        level = priors[start:end]
        fh, fw = (int(v) for v in feature_maps[k])
        a = int(anchors_per_cell[k])
        canvas = np.full((h, w, 3), 255, np.uint8)
        cell_centers = level.reshape(fh * fw, a, 4)[:, 0, :2]
        for cx, cy in cell_centers:
            dot(canvas, (int(cx * w), int(cy * h)), (255, 160, 0))
        ci = (fh // 2) * fw + (fw // 2)
        cell = level.reshape(fh * fw, a, 4)[ci]
        img = draw_boxes(canvas, _center_to_corner(cell), color=(0, 0, 255))
        writer.add_image(f"priors/level{k}", _to_chw_uint8(img.astype(np.float32)), epoch)


def viz_samples(writer, loader, epoch: int = 0, max_images: int = 8):
    """The first batch's images (up to ``max_images``) with their GT boxes."""
    for batch in loader:
        n = min(max_images, batch["images"].shape[0])
        for i in range(n):
            img = batch["images"][i]
            boxes = batch["boxes"][i][batch["valid"][i]]
            img = draw_boxes(img, boxes)
            writer.add_image(f"samples/{i}", _to_chw_uint8(img), epoch)
        break


def _channel_grid(fm_hwc: np.ndarray, max_channels: int = 64, pad: int = 1) -> np.ndarray:
    """Up to ``max_channels`` channels of one ``[H, W, C]`` feature map tiled
    into a near-square ``[1, gh*(H+pad)-pad, gw*(W+pad)-pad]`` grid, each
    channel min-max normalised."""
    h, w, c = fm_hwc.shape
    c = min(c, max_channels)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad), np.uint8)
    for i in range(c):
        ch = fm_hwc[:, :, i].astype(np.float32)
        ch = ch - ch.min()
        if ch.max() > 0:
            ch = ch / ch.max()
        r, col = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = (ch * 255).astype(np.uint8)
    return grid[None]


def viz_feature_maps(writer, feature_maps, epoch: int = 0, tag: str = "features",
                     max_channels: int = 64):
    """Per-level renders of the first image's ``[B, H, W, C]`` feature maps
    (reference ``viz_module_feature_maps``): a per-channel grid and the
    mean-activation heatmap."""
    for k, fm in enumerate(feature_maps):
        fm0 = np.asarray(fm[0], np.float32)
        writer.add_image(f"{tag}/level{k}/channels", _channel_grid(fm0, max_channels), epoch)
        m = fm0.mean(axis=-1)
        m = m - m.min()
        if m.max() > 0:
            m = m / m.max()
        writer.add_image(f"{tag}/level{k}", (m[None] * 255).astype(np.uint8), epoch)


def viz_grads(writer, grads_flat: dict, epoch: int = 0):
    """One histogram per parameter's gradient, ``grads/<path>`` (reference
    ``viz_module_grads``); ``grads_flat`` maps a path tuple to an array."""
    for path, g in grads_flat.items():
        writer.add_histogram("grads/" + "/".join(map(str, path)), np.asarray(g), epoch)
