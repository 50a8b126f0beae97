"""The port's ``detect`` against the JAX package's, on the same ``loc`` / ``conf``.

Inputs are made with numpy from a seed and handed to both sides.

Tolerance: the kept ``(class, slot)`` sets are compared EXACTLY; the rows
with ``atol = 2e-6``. Scores are copied, not computed, so they agree to the
bit; the boxes go through ``decode``, whose ``exp`` and multiply-adds XLA may
round differently from PyTorch by an ulp or two (coordinates are O(1), one
float32 ulp there is ~1.2e-7, and ``exp(0.2 * loc)`` for ``|loc| <= 4`` is
below 2.3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.ops import postprocess as jpost
from ssds_tpu.ops.boxes import center_size, encode
from ssds_tpu_torch.ops import postprocess as tpost

ATOL = 2e-6


def _priors(rng, k):
    xy = rng.uniform(0.0, 0.7, (k, 2))
    wh = rng.uniform(0.05, 0.3, (k, 2))
    return np.array(center_size(jnp.asarray(
        np.concatenate([xy, xy + wh], 1).astype(np.float32))))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _case(name, b):
    """(loc [B,K,4], conf [B,K,C], priors [K,4], PostProcessConfig kwargs)."""
    rng = np.random.default_rng(sum(map(ord, name)) + b)
    k, c = 300, 6
    priors = _priors(rng, k)
    loc = rng.normal(0.0, 1.0, (b, k, 4)).clip(-4, 4).astype(np.float32)
    kw = dict(num_classes=c, score_threshold=0.01, iou_threshold=0.45,
              max_detections=30, top_k=50, pre_nms_top_n=64)
    if name == "random_logits":
        conf = _softmax(rng.normal(0.0, 2.0, (b, k, c)))
    elif name == "tied_scores":
        # few distinct score levels: many exact ties, ranked index-ascending
        conf = np.round(_softmax(rng.normal(0.0, 2.0, (b, k, c))) * 8) / 8
        conf = conf.astype(np.float32)
    elif name == "planted":
        # a few confident boxes planted over low background noise
        conf = np.full((b, k, c), 0.002, np.float32)
        conf[..., 0] = 0.99
        for bi in range(b):
            for p in rng.choice(k, 12, replace=False):
                gt = np.sort(rng.uniform(0.05, 0.95, (2, 2)), axis=0).T.reshape(-1)[[0, 2, 1, 3]]
                loc[bi, p] = np.asarray(encode(jnp.asarray(gt[None].astype(np.float32)),
                                               jnp.asarray(priors[p:p + 1])))[0]
                conf[bi, p, :] = 0.01
                conf[bi, p, rng.integers(1, c)] = rng.uniform(0.5, 0.97)
    else:
        raise KeyError(name)
    return loc, conf, priors, kw


@pytest.mark.parametrize("batch", [1, 4])  # batch 4 takes the class-agnostic prune
@pytest.mark.parametrize("name", ["random_logits", "tied_scores", "planted"])
def test_detect_equals_jax(name, batch):
    loc, conf, priors, kw = _case(name, batch)
    want = np.asarray(jpost.detect(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                                   jpost.PostProcessConfig(**kw)))
    got = tpost.detect(torch.from_numpy(loc), torch.from_numpy(conf), torch.from_numpy(priors),
                       tpost.PostProcessConfig(**kw)).numpy()
    assert got.shape == want.shape == (batch, kw["num_classes"], kw["max_detections"], 5)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.argwhere(got[..., 0] > 0), np.argwhere(want[..., 0] > 0))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got[:, 0] == 0).all()  # background row


def test_prune_changes_the_batch4_pool():
    """The batch-4 prune is really taken (and really a different pool) here:
    without it the random-logit case gives other rows."""
    loc, conf, priors, kw = _case("random_logits", 4)
    args = (torch.from_numpy(loc), torch.from_numpy(conf), torch.from_numpy(priors))
    pruned = tpost.detect(*args, tpost.PostProcessConfig(**kw)).numpy()
    full = tpost.detect(*args, tpost.PostProcessConfig(**dict(kw, pre_nms_top_n=0))).numpy()
    assert not np.array_equal(pruned, full)


def test_detect_decoded_equals_jax():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0.0, 0.7, (2, 120, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (2, 120, 2))], -1).astype(np.float32)
    conf = _softmax(rng.normal(0.0, 2.0, (2, 120, 5)))
    kw = dict(num_classes=5, max_detections=20, top_k=40)
    want = np.asarray(jpost.detect_decoded(jnp.asarray(boxes), jnp.asarray(conf),
                                           jpost.PostProcessConfig(**kw)))
    got = tpost.detect_decoded(torch.from_numpy(boxes), torch.from_numpy(conf),
                               tpost.PostProcessConfig(**kw)).numpy()
    np.testing.assert_array_equal(got, want)  # no decode: copied values only
