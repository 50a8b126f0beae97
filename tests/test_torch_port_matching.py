"""The port's matching against the JAX package's and the sequential oracle.

The same seeded numpy GT (padded, with a validity mask) goes through
``ssds_tpu.ops.matching.match`` (vmapped over the batch) and
``ssds_tpu_torch.ops.matching.match_batch``. Class targets must be equal;
loc targets within rtol 1e-6 and atol 1e-6: both sides run ``jaccard`` and
``encode`` with the same float32 operations in the same order and pick the
matched row by a selection (a gather here, an exact one-hot product there),
so only ``log`` differs. XLA's CPU ``log`` is a polynomial with about 1e-7
absolute error where its argument is near 1, which ``/ 0.2`` takes to up to
4e-7 in ``g_wh`` (measured, 320 ulps of a value near 0): hence the atol.
The oracle is the reference's sequential loop in float64 (``tests/oracle.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ssds_tpu.ops.matching import match as jax_match
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.models.builder import create_model, create_priors
from ssds_tpu_torch.ops.boxes import center_size
from ssds_tpu_torch.ops.matching import match, match_batch

LOC_ATOL = 1e-6


def _small_priors():
    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    _, fmaps = create_model(cfg.MODEL)
    return create_priors(cfg.MODEL, fmaps)


def _random_gt(rng, b, g):
    n = rng.integers(0, g + 1, b)
    n[0] = g  # one image full
    xy = rng.uniform(0, 0.7, (b, g, 2))
    wh = rng.uniform(0.02, 0.3, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, 20, (b, g)).astype(np.int32)
    valid = np.arange(g)[None, :] < n[:, None]
    boxes[~valid] = 0.0
    labels[~valid] = 0
    return boxes, labels, valid


def _jax(boxes, labels, valid, priors, threshold=0.5):
    f = jax.jit(jax.vmap(lambda t, l, v: jax_match(t, l, v, jnp.asarray(priors), threshold)))
    loc, conf = f(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid))
    return np.asarray(loc), np.asarray(conf)


def _port(boxes, labels, valid, priors, threshold=0.5):
    loc, conf = match_batch(torch.from_numpy(boxes), torch.from_numpy(labels),
                            torch.from_numpy(valid), torch.from_numpy(priors), threshold)
    return loc.numpy(), conf.numpy()


@pytest.mark.parametrize("seed,g", [(0, 1), (1, 5), (2, 16)])
def test_match_equals_jax_and_oracle(seed, g):
    priors = _small_priors()
    rng = np.random.default_rng(seed)
    boxes, labels, valid = _random_gt(rng, 4, g)
    want_loc, want_conf = _jax(boxes, labels, valid, priors)
    got_loc, got_conf = _port(boxes, labels, valid, priors)
    assert got_conf.dtype == np.int64 and got_loc.dtype == np.float32
    np.testing.assert_array_equal(got_conf, want_conf)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-6, atol=LOC_ATOL)
    for i in range(4):
        if valid[i].any():
            _, conf_o = oracle.match(boxes[i][valid[i]], labels[i][valid[i]].astype(np.int64),
                                     priors)
            np.testing.assert_array_equal(got_conf[i], conf_o)
    # the one-image form is the batch form over a batch of one
    loc1, conf1 = match(*(torch.from_numpy(a[1]) for a in (boxes, labels, valid)),
                        torch.from_numpy(priors))
    np.testing.assert_array_equal(conf1.numpy(), got_conf[1])
    np.testing.assert_array_equal(loc1.numpy(), got_loc[1])


def test_shared_best_prior_later_gt_wins():
    """Three GTs with one best prior: the last valid one takes it, as the
    reference's loop leaves it; a padded row after them never does."""
    priors = center_size(torch.tensor([[0.4, 0.4, 0.6, 0.6], [0.0, 0.0, 0.1, 0.1],
                                       [0.7, 0.7, 0.9, 0.9]])).numpy()
    boxes = np.zeros((1, 5, 4), np.float32)
    boxes[0, :3] = [[0.4, 0.4, 0.6, 0.6], [0.41, 0.41, 0.61, 0.61], [0.39, 0.4, 0.6, 0.61]]
    boxes[0, 3] = [0.4, 0.4, 0.6, 0.6]  # padding that would win if it counted
    labels = np.array([[1, 2, 7, 9, 0]], np.int32)
    valid = np.array([[True, True, True, False, False]])
    want_loc, want_conf = _jax(boxes, labels, valid, priors)
    got_loc, got_conf = _port(boxes, labels, valid, priors)
    assert got_conf[0, 0] == 8  # label 7 + 1: the last valid GT won
    np.testing.assert_array_equal(got_conf, want_conf)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-6, atol=LOC_ATOL)
    _, conf_o = oracle.match(boxes[0, :3], labels[0, :3].astype(np.int64), priors)
    np.testing.assert_array_equal(got_conf[0], conf_o)


def test_empty_image_is_all_background():
    priors = _small_priors()
    boxes, labels, valid = _random_gt(np.random.default_rng(7), 3, 4)
    valid[1] = False  # image 1: no GT at all (its rows still hold boxes)
    want_loc, want_conf = _jax(boxes, labels, valid, priors)
    got_loc, got_conf = _port(boxes, labels, valid, priors)
    assert (got_conf[1] == 0).all() and (got_conf[0] > 0).any()
    assert np.isfinite(got_loc).all()
    np.testing.assert_array_equal(got_conf, want_conf)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-6, atol=LOC_ATOL)


@pytest.mark.parametrize("threshold", [0.1, 0.35, 0.5, 0.7, 0.99])
def test_threshold_equals_jax(threshold):
    priors = _small_priors()
    boxes, labels, valid = _random_gt(np.random.default_rng(11), 2, 6)
    want_loc, want_conf = _jax(boxes, labels, valid, priors, threshold)
    got_loc, got_conf = _port(boxes, labels, valid, priors, threshold)
    np.testing.assert_array_equal(got_conf, want_conf)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-6, atol=LOC_ATOL)
    # every valid GT keeps its forced prior at any threshold
    assert (got_conf[0] > 0).sum() >= 1
