"""The port's YOLO ops against the JAX package's: ``decode_scale``,
``_bce_logits``, ``yolo_loss``, ``yolo_v2_loss``, ``space_to_depth`` and the
leaky ReLU.

Inputs are made with numpy from a seed. Tolerances, with what was measured:

- ``decode_scale`` (float32): boxes, objectness and logits within rtol 1e-6 /
  atol 1e-6 (the sigmoid and exp of the two libraries differ in the last
  bit; measured 4.8e-7 at most, on boxes up to 7);
- the losses (float32 inside both, whatever the input's dtype): values within
  rtol 2e-6 (sums over every cell in other orders; measured 1.9e-7), the
  gradients with respect to the raw outputs within 1e-6 of the largest
  gradient element (per-element expressions; measured 9.4e-8);
- ``space_to_depth``, the leaky ReLU and its gradient in float32 and bf16:
  equal, bit for bit.

The GT cases each pin one rule: two GTs on one cell-anchor (a loss row a GT,
so both count); padded GTs after a valid GT on cell 0, anchor 0 (the dense
positive mask is an OR: a last-write scatter clears that positive, and the
test that patches one in sees the loss move); a GT centre at 1.0 (the cell is
clipped to the last); wh-IoU ties between anchors (the first wins); and
YOLOv2's warm-up below and above 12,800 seen images.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssds_tpu.models import layers as jl
from ssds_tpu.models.heads import yolo as jyolo_head
from ssds_tpu.ops import yolo as jyolo
from ssds_tpu_torch.models import layers as tl
from ssds_tpu_torch.models.heads.yolo import space_to_depth
from ssds_tpu_torch.ops import yolo as tyolo

IMG = (64, 64)
# per-scale grids and pixel anchors: three scales (v3) and one (v2); the
# second v3 scale holds the tie (a 24 x 24 GT against 16 x 36 and 36 x 16)
GRIDS = [(8, 8), (4, 4), (2, 2)]
ANCHORS = [[[8, 10], [16, 12], [12, 20]], [[16, 36], [36, 16], [24, 24]],
           [[40, 40], [56, 30], [60, 60]]]
V2_GRID, V2_ANCHORS = (4, 4), [[10, 10], [16, 36], [36, 16], [40, 40], [60, 50]]
CLASSES = 3
VALUE_RTOL, GRAD_TOL = 2e-6, 1e-6


def _box(cx, cy, w, h):
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def _gt(case, rng, b=3, g=6):
    """``(boxes, labels, valid)`` for one of the named GT cases."""
    boxes = np.zeros((b, g, 4), np.float32)
    labels = rng.integers(0, CLASSES, (b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    n = rng.integers(2, g, b)
    for i in range(b):
        xy = rng.uniform(0.05, 0.95, (n[i], 2))
        wh = rng.uniform(0.05, 0.6, (n[i], 2))
        boxes[i, :n[i]] = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
        valid[i, :n[i]] = True
    if case == "collide":  # two GTs on one cell and anchor, different labels
        boxes[0, 0] = _box(0.31, 0.31, 0.2, 0.2)
        boxes[0, 1] = _box(0.32, 0.33, 0.21, 0.19)
        labels[0, :2] = [0, 2]
    elif case == "padded_cell0":  # a valid GT on cell 0, anchor 0 of scale 0; then padding
        boxes[1, :] = 0.0
        boxes[1, 0] = _box(0.05, 0.05, 0.1, 0.1)
        valid[1, :] = False
        valid[1, 0] = True
    elif case == "centre_1":  # centres on the far edges: clipped to the last cell
        boxes[0, 0] = _box(1.0, 1.0, 0.3, 0.3)
        boxes[2, 0] = _box(1.0, 0.5, 0.5, 0.2)
        valid[0, 0] = valid[2, 0] = True
    elif case == "wh_tie":  # 24 x 24 px against 16 x 36 and 36 x 16 px: equal IoU
        boxes[2, 1] = _box(0.5, 0.5, 24 / 64, 24 / 64)
        boxes[2, 2] = _box(0.2, 0.7, 24 / 64, 24 / 64)
        valid[2, :3] = True
    return boxes, labels, valid


def _raw(rng, grids, anchors, b=3):
    return [rng.normal(0, 1.0, (b, h, w, len(a), 5 + CLASSES)).astype(np.float32)
            for (h, w), a in zip(grids, anchors)]


CASES = ["random", "collide", "padded_cell0", "centre_1", "wh_tie"]
DTYPES = ["float32", "float64"]


def _jax_loss(fn, raw, anchors, gt, dtype, **kw):
    """``(loss_l, loss_c, grads of their sum)`` of the JAX loss."""
    boxes, labels, valid = gt
    with jax.enable_x64(dtype == "float64"):
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        raw_j = [jnp.asarray(r, jdt) for r in raw]
        anchors_j = [jnp.asarray(a, jnp.float32) for a in anchors]

        (ll, lc), grads = _jax_value_and_grad(fn, tuple(sorted(kw.items())))(
            raw_j, anchors_j, jnp.asarray(boxes, jdt), jnp.asarray(labels), jnp.asarray(valid))
        return float(ll), float(lc), [np.asarray(g, np.float64) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(fn, kw):
    def total(rs, anchors, boxes, labels, valid):
        ll, lc = fn(rs, anchors, boxes, labels, valid, IMG, **dict(kw))
        return ll + lc, (ll, lc)

    def run(*args):
        (_, losses), grads = jax.value_and_grad(total, has_aux=True)(*args)
        return losses, grads

    return jax.jit(run)


def _port_loss(fn, raw, anchors, gt, dtype, **kw):
    boxes, labels, valid = gt
    tdt = torch.float64 if dtype == "float64" else torch.float32
    raw_t = [torch.tensor(r, dtype=tdt, requires_grad=True) for r in raw]
    ll, lc = fn(raw_t, [torch.tensor(a, dtype=torch.float32) for a in anchors],
                torch.tensor(boxes, dtype=tdt), torch.from_numpy(labels), torch.from_numpy(valid),
                IMG, **kw)
    (ll + lc).backward()
    return ll.item(), lc.item(), [r.grad.double().numpy() for r in raw_t]


def _assert_close(got, want):
    gl, gc, gg = got
    wl, wc, wg = want
    np.testing.assert_allclose([gl, gc], [wl, wc], rtol=VALUE_RTOL)
    scale = max(float(np.abs(g).max()) for g in wg)
    err = max(float(np.abs(a - b).max()) for a, b in zip(gg, wg)) / scale
    assert err <= GRAD_TOL, err
    return err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_yolo_loss_equals_jax(case, dtype):
    rng = np.random.default_rng([1, CASES.index(case)])
    raw, gt = _raw(rng, GRIDS, ANCHORS), _gt(case, rng)
    want = _jax_loss(jyolo.yolo_loss, raw, ANCHORS, gt, dtype)
    err = _assert_close(_port_loss(tyolo.yolo_loss, raw, ANCHORS, gt, dtype), want)
    print(f"{case} {dtype}: loss {want[:2]}, gradient error {err:.2e}")


@pytest.mark.parametrize("seen", [0.0, np.inf], ids=["warm", "seen_inf"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_yolo_v2_loss_equals_jax(case, dtype, seen):
    rng = np.random.default_rng([2, CASES.index(case)])
    raw, gt = _raw(rng, [V2_GRID], [V2_ANCHORS]), _gt(case, rng)
    want = _jax_loss(jyolo.yolo_v2_loss, raw, [V2_ANCHORS], gt, dtype, seen_images=seen)
    got = _port_loss(tyolo.yolo_v2_loss, raw, [V2_ANCHORS], gt, dtype, seen_images=seen)
    _assert_close(got, want)


def test_v2_warm_up_switches_at_12800_seen_images():
    """Just below 12,800 seen images the warm-up term is on, from 12,800 off,
    in both packages."""
    rng = np.random.default_rng(3)
    raw, gt = _raw(rng, [V2_GRID], [V2_ANCHORS]), _gt("random", rng)
    loc = []
    for seen in (12799.0, 12800.0):
        want = _jax_loss(jyolo.yolo_v2_loss, raw, [V2_ANCHORS], gt, "float32", seen_images=seen)
        got = _port_loss(tyolo.yolo_v2_loss, raw, [V2_ANCHORS], gt, "float32", seen_images=seen)
        _assert_close(got, want)
        loc.append(got[0])
    assert loc[0] > loc[1] > 0


def _last_write_mask(k, flat_idx, on):
    """A plain indexed write: the last GT naming a cell decides it."""
    mask = torch.zeros(flat_idx.shape[0], k, dtype=torch.bool)
    mask[torch.arange(flat_idx.shape[0])[:, None], flat_idx] = on
    return mask


@pytest.mark.parametrize("fn,grids,anchors", [
    ("yolo_loss", GRIDS, ANCHORS), ("yolo_v2_loss", [V2_GRID], [V2_ANCHORS])],
    ids=["v3", "v2"])
def test_padded_gts_on_cell0_fail_a_last_write_mask(fn, grids, anchors, monkeypatch):
    """The ``padded_cell0`` case tells the OR-scatter from a last-write one:
    with the latter the positive on cell 0 is cleared, it joins the
    negatives, and the loss leaves JAX's."""
    rng = np.random.default_rng([1 if fn == "yolo_loss" else 2, CASES.index("padded_cell0")])
    raw, gt = _raw(rng, grids, anchors), _gt("padded_cell0", rng)
    want = _jax_loss(getattr(jyolo, fn), raw, anchors, gt, "float32")
    _assert_close(_port_loss(getattr(tyolo, fn), raw, anchors, gt, "float32"), want)
    monkeypatch.setattr(tyolo, "positive_mask", _last_write_mask)
    got = _port_loss(getattr(tyolo, fn), raw, anchors, gt, "float32")
    assert abs(got[1] - want[1]) > 1e-3 * abs(want[1]), (got[1], want[1])


def test_positive_mask_is_an_or_over_colliding_indices():
    idx = torch.tensor([[0, 0, 0, 5], [3, 3, 7, 7]])
    on = torch.tensor([[True, False, False, False], [False, True, False, False]])
    mask = tyolo.positive_mask(8, idx, on)
    assert mask.nonzero().tolist() == [[0, 0], [1, 3]]


@pytest.mark.parametrize("grid,anchors", [((5, 7), V2_ANCHORS), ((8, 8), ANCHORS[0]),
                                          ((1, 3), [[100, 20]])])
def test_decode_scale_equals_jax(grid, anchors):
    rng = np.random.default_rng(list(grid))
    raw = rng.normal(0, 1.5, (2, *grid, len(anchors), 5 + CLASSES)).astype(np.float32)
    img = (96, 128)
    want = jyolo.decode_scale(jnp.asarray(raw), jnp.asarray(anchors, jnp.float32), img)
    got = tyolo.decode_scale(torch.from_numpy(raw), torch.tensor(anchors, dtype=torch.float32),
                             img)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # gx is the column, gy the row; sizes divide by the model input's size
    boxes = got[0].reshape(2, *grid, len(anchors), 4)
    np.testing.assert_allclose((boxes[0, 0, -1, 0, 0] + boxes[0, 0, -1, 0, 2]).item() / 2,
                               (grid[1] - 1 + torch.sigmoid(torch.tensor(raw[0, 0, -1, 0, 0]))
                                ).item() / grid[1], rtol=1e-6)


def test_bce_logits_gradient_at_zero():
    x = torch.zeros(3, requires_grad=True)
    t = torch.tensor([0.0, 1.0, 0.5])
    tyolo._bce_logits(x, t).sum().backward()
    want = jax.grad(lambda x: jyolo._bce_logits(x, jnp.asarray(t.numpy())).sum())(jnp.zeros(3))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), [0.5, -0.5, 0.0])


def test_space_to_depth_equals_jax_and_pixel_unshuffle_does_not():
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 5)).astype(np.float32)  # NHWC
    want = np.asarray(jyolo_head.space_to_depth(jnp.asarray(x), 2))
    nchw = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = space_to_depth(nchw, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    unshuffled = F.pixel_unshuffle(nchw, 2).permute(0, 2, 3, 1).numpy()
    assert unshuffled.shape == want.shape and not np.array_equal(unshuffled, want)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_leaky_relu_equals_jax_bit_for_bit(dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 4, 4096).astype(np.float32)
    x[:3] = [0.0, -0.0, 1e-3]
    g = rng.normal(0, 1, 4096).astype(np.float32)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    yj, pull = jax.vjp(lambda v: jl.leaky_relu(v, 0.1), xj)
    xt = torch.tensor(x).to(tdt).requires_grad_()
    yt = tl.LeakyReLU()(xt)
    yt.backward(torch.tensor(g).to(tdt))
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(yj, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(pull(gj)[0], np.float32))
