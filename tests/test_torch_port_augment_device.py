"""The port's device augmentation (``ssds_tpu_torch/ops/augment_device.py``)
against the JAX package's (``ssds_tpu/ops/augment_device.py``), and its
wiring into the loader and the Solver (``DATASET.DEVICE_AUG``).

Parity: the two packages draw different random numbers, so the tests feed
JAX's own draws to the port. :func:`_jax_params` re-derives every draw of
JAX's ``augment_batch`` from its key tree (``split(rng, B)``, then
``split(key, 5)`` per image, then the crop, expand and photometric splits)
as the port's :class:`AugParams`, and the port's applier must then give
JAX's result: images within atol 2e-3 on mean-subtracted pixels (the two
resample contractions and the hue's 3x3 product sum in other orders; measured
4.6e-5), boxes within 1e-6 (the same float32 operations; measured 0) and
``valid`` equal. The port's own sampler is held to JAX's distribution on
``tests/test_augment_drift.py``'s corpus.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.data.augment import preproc as jax_preproc
from ssds_tpu.ops import augment_device as jad
from ssds_tpu_torch.ops import augment_device as tad
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

MEANS = (104.0, 117.0, 123.0)


def _stack(values, dtype=None):
    return torch.from_numpy(np.array(np.stack([np.asarray(v) for v in values]), dtype=dtype))


def _crop_draws(kc, k=tad.N_CROP_CANDIDATES):
    km, ks, kr, kx, ky = jax.random.split(kc, 5)
    min_iou = jnp.asarray(jad._CROP_MIN_IOUS)[
        jax.random.randint(km, (), 0, len(jad._CROP_MIN_IOUS))]
    scale = jax.random.uniform(ks, (k,), minval=0.3, maxval=1.0)
    lo, hi = jad._ratio_bounds(scale)
    ratio = jnp.sqrt(jax.random.uniform(kr, (k,), minval=lo, maxval=hi))
    rw, rh = scale * ratio, scale / ratio
    return {"crop_min_iou": min_iou, "crop_w": rw, "crop_h": rh,
            "crop_x": jax.random.uniform(kx, (k,)) * (1.0 - rw),
            "crop_y": jax.random.uniform(ky, (k,)) * (1.0 - rh)}


def _expand_draws(ke, prob):
    kg, ks, kr, kx, ky = jax.random.split(ke, 5)
    scale = jax.random.uniform(ks, minval=1.0, maxval=4.0)
    lo, hi = jnp.maximum(0.5, 1.0 / (scale * scale)), jnp.minimum(2.0, scale * scale)
    ratio = jnp.sqrt(jax.random.uniform(kr, minval=lo, maxval=hi))
    ws, hs = scale * ratio, scale / ratio
    return {"expand": jax.random.uniform(kg) < prob, "expand_w": ws, "expand_h": hs,
            "expand_left": jax.random.uniform(kx) * (ws - 1.0),
            "expand_top": jax.random.uniform(ky) * (hs - 1.0)}


def _photo_draws(kp):
    kb, kbm, kc, kcm, ks, ksm, kh, khm = jax.random.split(kp, 8)
    return {"photo": jnp.stack([jax.random.bernoulli(k) for k in (kb, kc, ks, kh)]),
            "brightness": jax.random.uniform(kbm, minval=-32.0, maxval=32.0),
            "contrast": jax.random.uniform(kcm, minval=0.5, maxval=1.5),
            "saturation": jax.random.uniform(ksm, minval=0.5, maxval=1.5),
            "hue_deg": jax.random.uniform(khm, minval=-36.0, maxval=36.0)}


def _params(rows):
    return tad.AugParams(**{f: _stack([r[f] for r in rows]) for f in tad.AugParams._fields})


def _jax_params(rng, b, prob):
    """JAX's ``augment_batch(rng, ...)`` draws as the port's AugParams."""
    rows = []
    for key in jax.random.split(rng, b):
        kg, kc, ke, kf, kp = jax.random.split(key, 5)
        rows.append({"do_aug": jax.random.uniform(kg) < prob, **_crop_draws(kc),
                     **_expand_draws(ke, prob), **_photo_draws(kp),
                     "flip": jax.random.bernoulli(kf)})
    return _params(rows)


def _batch(rng, b=4, hw=64, g=5):
    imgs = rng.uniform(-123, 150, (b, hw, hw, 3)).astype(np.float32)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.1, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(size=(b, g)) < 0.7
    valid[:, 0] = True
    valid[-1] = False  # an image with no GT (the reference's fault, pinned below)
    boxes[~valid] *= 0.5
    return imgs, boxes, valid


def _port(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_applier_under_jax_draws_equals_augment_batch(seed):
    imgs, boxes, valid = _batch(np.random.default_rng(seed))
    key = jax.random.PRNGKey(seed)
    prob = 0.9  # most images take the branch; the crop modes, gates and flips vary
    want = [np.asarray(a) for a in jad.augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(valid), prob=prob, means=MEANS)]
    got = [a.numpy() for a in tad.apply_params(*_port(imgs, boxes, valid),
                                               _jax_params(key, 4, prob), MEANS)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert np.abs(got[0] - imgs).max() > 1.0  # something was augmented


@pytest.mark.parametrize("seed", range(6))
def test_crop_expand_and_box_affine_under_jax_draws(seed):
    rng = np.random.default_rng(100 + seed)
    _, boxes, valid = _batch(rng, b=1, g=6)
    if seed % 3 == 0:
        boxes[0, :2] = [[0.0, 0.0, 1.0, 1.0], [0.1, 0.2, 0.9, 0.7]]  # large GT: hard crops
        valid[0, :2] = True
    key = jax.random.PRNGKey(seed)
    kc, ke = jax.random.split(key)
    want_crop = jad._sample_crop(kc, jnp.asarray(boxes[0]), jnp.asarray(valid[0]))
    want_expand = jad._sample_expand(ke, 0.6)
    p = _params([{**_crop_draws(kc), **_expand_draws(ke, 0.6), **_photo_draws(key),
                  "do_aug": True, "flip": False}])
    got_crop = tad.crop_affine(*_port(boxes, valid), p)
    got_expand = tad.expand_affine(p)
    for g, w in zip(got_crop + got_expand, tuple(want_crop) + tuple(want_expand)):
        assert g.shape == (1,) and g.dtype == torch.float32
        assert g.item() == float(w)
    a = [np.float32(v) for v in rng.uniform([0.5, 0.5, -0.3, -0.3], [2.0, 2.0, 0.3, 0.3])]
    want = jad._apply_affine_boxes(jnp.asarray(boxes[0]), jnp.asarray(valid[0]), *a)
    got = tad.affine_boxes(*_port(boxes, valid),
                           *(torch.tensor([v], dtype=torch.float32) for v in a))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed,all_gates", [(0, True), (1, True), (2, False), (3, False)])
def test_photometric_under_jax_draws(seed, all_gates):
    img = np.random.default_rng(seed).uniform(0, 255, (16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    p = _params([{**_photo_draws(key), **_crop_draws(key), **_expand_draws(key, 0.6),
                  "do_aug": True, "flip": False}])
    if all_gates:  # every op once, JAX's magnitudes: its coins forced on
        p = p._replace(photo=torch.ones_like(p.photo))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "bernoulli", lambda k, p=0.5, shape=None: jnp.bool_(True))
            want = np.asarray(jad._photometric(key, jnp.asarray(img)))
    else:
        want = np.asarray(jad._photometric(key, jnp.asarray(img)))
    got = tad.photometric(torch.from_numpy(img)[None], p)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    if all_gates:
        assert np.abs(got - img).max() > 1.0


# -- the port's counterparts of tests/test_augment_device.py ----------------


def planted_batch(b=6, h=96, w=96):
    """Gray images with one bright square each, box exactly around it."""
    rng = np.random.default_rng(0)
    images = np.zeros((b, h, w, 3), np.float32)
    boxes = np.zeros((b, 4, 4), np.float32)
    valid = np.zeros((b, 4), bool)
    for i in range(b):
        x1, y1 = rng.uniform(0.1, 0.4, 2)
        bw, bh = rng.uniform(0.25, 0.4, 2)
        x2, y2 = min(x1 + bw, 0.95), min(y1 + bh, 0.95)
        px = (np.array([x1, y1, x2, y2]) * [w, h, w, h]).astype(int)
        images[i, px[1]:px[3], px[0]:px[2], :] = 100.0
        boxes[i, 0] = [x1, y1, x2, y2]
        valid[i, 0] = True
    return _port(images, boxes, valid)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_prob_zero_is_exact_identity():
    images, boxes, valid = planted_batch()
    out_img, out_box, out_valid = tad.augment_batch(_gen(0), images, boxes, valid, prob=0.0)
    assert torch.equal(out_img, images) and torch.equal(out_box, boxes)
    assert torch.equal(out_valid, valid)


def test_boxes_track_bright_region():
    """For every augmented image with a surviving box, the planted square's
    centroid lies inside the (slightly padded) box. The square is found as
    the difference from the same draws applied to the images without it
    (every op is per pixel or linear), not by a brightness threshold: the
    contrast can darken the square below the expand's mean fill."""
    images, boxes, valid = planted_batch()
    h, w = images.shape[1:3]
    hits = 0
    for seed in range(10):
        p = tad.sample_params(_gen(seed), boxes, valid, 1.0)
        out_img, out_box, out_valid = (a.numpy() for a in tad.apply_params(
            images, boxes, valid, p, MEANS))
        blank = tad.apply_params(torch.zeros_like(images), boxes, valid, p, MEANS)[0].numpy()
        for i in range(images.shape[0]):
            if not out_valid[i, 0]:
                continue
            mass = np.abs(out_img[i] - blank[i]).sum(-1)
            total = mass.sum()
            if total < 1e3:  # the square zoomed out of view
                continue
            ys, xs = np.mgrid[0:h, 0:w]
            cx = float((xs * mass).sum() / total) / w
            cy = float((ys * mass).sum() / total) / h
            bx = out_box[i, 0]
            assert bx[0] - 0.06 <= cx <= bx[2] + 0.06, (seed, i, bx, cx, cy)
            assert bx[1] - 0.06 <= cy <= bx[3] + 0.06, (seed, i, bx, cx, cy)
            hits += 1
    assert hits > 20


def test_boxes_stay_normalized_and_wellformed():
    images, boxes, valid = planted_batch()
    for seed in range(6):
        _, out_box, out_valid = tad.augment_batch(_gen(seed), images, boxes, valid, prob=1.0)
        ob = out_box.numpy()
        assert (ob >= -1e-5).all() and (ob <= 1 + 1e-5).all()
        kept = ob[out_valid.numpy()]
        assert (kept[:, 2] >= kept[:, 0]).all() and (kept[:, 3] >= kept[:, 1]).all()


def _photo_params(seed, b):
    dummy = torch.zeros((b, 1, 4))
    return tad.sample_params(_gen(seed), dummy, torch.ones((b, 1), dtype=torch.bool), 1.0)


def test_photometric_brightness_is_two_sided():
    """Each gate and magnitude has its own draw: brightness shifts of both
    signs, in about equal numbers (a mid-gray image keeps both observable)."""
    img = torch.full((200, 4, 4, 3), 128.0)
    out = tad.photometric(img, _photo_params(0, 200))
    shifts = [m for m in (out.mean(dim=(1, 2, 3)) - 128.0).tolist() if abs(m) > 1e-4]
    pos = sum(1 for s in shifts if s > 0)
    assert len(shifts) > 60
    assert 0.3 < pos / len(shifts) < 0.7, f"{pos}/{len(shifts)} positive"


def test_photometric_stays_in_gamut_and_hue_preserves_channel_sum():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (50, 8, 8, 3)).astype(np.float32))
    out = tad.photometric(img, _photo_params(1, 50))
    assert out.min() >= -1e-3 and out.max() <= 255 + 1e-3
    # hue alone, well inside the gamut: the rotation keeps each pixel's channel sum
    p = _photo_params(2, 50)
    p = p._replace(photo=torch.tensor([[False, False, False, True]] * 50))
    mid = torch.from_numpy(rng.uniform(100, 150, (50, 8, 8, 3)).astype(np.float32))
    hue = tad.photometric(mid, p)
    np.testing.assert_allclose(hue.sum(-1).numpy(), mid.sum(-1).numpy(), rtol=1e-5)
    assert (hue - mid).abs().max() > 1.0


def test_crop_candidates_respect_min_iou():
    """With a full-image GT box, an accepted crop keeps IoU(GT, ROI) = ROI
    area >= 0.1 (the smallest mode), inside the image."""
    boxes = torch.tensor([[[0.0, 0.0, 1.0, 1.0]]] * 40)
    valid = torch.ones((40, 1), dtype=torch.bool)
    p = tad.sample_params(_gen(3), boxes, valid, 1.0)
    ax, ay, bx, by = tad.crop_affine(boxes, valid, p)
    cropped = (ax != 1.0) | (ay != 1.0)
    assert cropped.sum() > 10
    rw, rh = 1.0 / ax[cropped], 1.0 / ay[cropped]
    rx, ry = -bx[cropped] * rw, -by[cropped] * rh
    area = rw * rh
    assert (area >= p.crop_min_iou[cropped] - 1e-6).all() and (area >= 0.1 - 1e-6).all()
    assert (rx >= -1e-6).all() and (rx <= 1 - rw + 1e-6).all()
    assert (ry >= -1e-6).all() and (ry <= 1 - rh + 1e-6).all()


def test_no_gradient_through_the_augmentation():
    images, boxes, valid = planted_batch(b=2)
    x = images.clone().requires_grad_(True)
    img, bx, _ = tad.augment_batch(_gen(3), x, boxes, valid, 0.6)
    assert not img.requires_grad and not bx.requires_grad
    assert torch.isfinite(img).all()


def test_empty_gt_image_is_still_augmented_as_in_jax():
    """The reference's fault (``ssds_tpu/ops/augment_device.py:250``; the host
    passes such an image through): with no GT the crop is the identity, but
    the expand and the photometric still apply, in both packages."""
    img = np.random.default_rng(5).uniform(-100, 100, (1, 32, 32, 3)).astype(np.float32)
    boxes, valid = np.zeros((1, 2, 4), np.float32), np.zeros((1, 2), bool)
    changed = 0
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jad.augment_batch(key, jnp.asarray(img), jnp.asarray(boxes),
                                            jnp.asarray(valid), prob=1.0)[0])
        got, _, vd = tad.apply_params(*_port(img, boxes, valid), _jax_params(key, 1, 1.0), MEANS)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
        assert not vd.any()
        changed += int(np.abs(want - img).max() > 1.0)
    assert changed == 8  # every one augmented, where the host would pass it through


# -- the distribution: the port's sampler against JAX's and the host's ------

SIZE, PROB, N_IMG, G = 96, 0.6, 48, 4


def _corpus():
    """``tests/test_augment_drift.py``'s corpus (the same seed and draws)."""
    rng = np.random.default_rng(42)
    imgs, boxes = [], []
    for _ in range(N_IMG):
        img = rng.integers(40, 216, (SIZE, SIZE, 3), dtype=np.uint8)
        bx = []
        for _ in range(G):
            x1, y1 = rng.integers(4, SIZE // 2, 2)
            w, h = rng.integers(12, SIZE // 2, 2)
            x2, y2 = min(x1 + w, SIZE - 2), min(y1 + h, SIZE - 2)
            img[y1:y2, x1:x2] = rng.integers(0, 255, 3)
            bx.append([x1, y1, x2, y2])
        imgs.append(img)
        boxes.append(np.asarray(bx, np.float32))
    return imgs, boxes


def _stats(img, bx, vd):
    centers = ((bx[:, :, 0:2] + bx[:, :, 2:4]) / 2)[vd]
    return vd.mean(), centers.std(), img.mean(), img.std()


def test_sampler_distribution_matches_jax_and_the_host():
    """Box survival, the spread of surviving centres and the pixel moments of
    the port's sampler against JAX's device augmentation and the host recipe
    (the JAX package's ``preproc``) on the drift corpus. Bounds against the
    host are ``tests/test_augment_drift.py``'s; against JAX's device path
    (the same law, other random numbers; each side's statistics averaged
    over four seeds) half of them. Measured (port / JAX / host): survival
    1.000 / 1.000 / 0.964, centre spread 0.159 / 0.166 / 0.168, pixel mean
    7.9 / 7.5 / 9.4, pixel std 51.4 / 49.8 / 50.9."""
    imgs, boxes = _corpus()
    images = np.stack(imgs).astype(np.float32) - np.asarray(MEANS, np.float32)
    bx = np.stack(boxes) / SIZE
    valid = np.ones((N_IMG, G), bool)
    seeds = range(4)
    port = np.mean([_stats(*(a.numpy() for a in tad.augment_batch(
        _gen(s), *_port(images, bx, valid), prob=PROB))) for s in seeds], axis=0)
    jitted = jax.jit(jad.augment_batch, static_argnames="prob")
    dev = np.mean([_stats(*(np.asarray(a) for a in jitted(
        jax.random.PRNGKey(s), jnp.asarray(images), jnp.asarray(bx), jnp.asarray(valid),
        prob=PROB))) for s in seeds], axis=0)
    np.random.seed(7)
    import random
    random.seed(7)
    p = jax_preproc((SIZE, SIZE), MEANS, PROB)
    survived, centers, pix = 0, [], []
    for img, b in zip(imgs, boxes):
        out_img, out_t = p(img, np.hstack([b, np.ones((len(b), 1), np.float32)]))
        survived += len(out_t)
        centers.append((out_t[:, 0:2] + out_t[:, 2:4]) / 2)
        pix.append(out_img.astype(np.float32) - np.asarray(MEANS, np.float32))
    pix = np.stack(pix)
    host = (survived / (N_IMG * G), np.concatenate(centers).std(), pix.mean(), pix.std())
    print("survival / spread / mean / std: port", port, "jax", dev, "host", host)
    for other, k in ((host, 1.0), (dev, 0.5)):
        assert abs(port[0] - other[0]) < 0.2 * k and port[0] > 0.5
        assert abs(port[1] - other[1]) / max(port[1], other[1]) < 0.35 * k
        assert abs(port[2] - other[2]) < 25.0 * k
        assert abs(port[3] - other[3]) / max(port[3], other[3]) < 0.25 * k
