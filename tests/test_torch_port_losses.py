"""The port's MultiBox loss against the JAX package's, values and gradients.

Seeded numpy predictions and padded GT go through
``ssds_tpu.ops.losses.multibox_loss`` (and ``jax.grad`` of it) and
``ssds_tpu_torch.ops.losses.multibox_loss`` (and autograd). Tolerances:
the losses are float32 sums over B x K priors in other orders: rtol 1e-5;
the gradients are per-element expressions (softmax, the smooth-L1 slope)
divided by the positive count: rtol 1e-5, atol 1e-7. The hard-negative
ranks are integers from stable sorts on both sides: equal, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ssds_tpu.ops.losses import hard_negative_ranks as jax_ranks
from ssds_tpu.ops.losses import multibox_loss as jax_loss
from ssds_tpu_torch.ops.losses import hard_negative_ranks, multibox_loss, smooth_l1

K_PRIORS, CLASSES = 300, 6


def _priors(rng, k=K_PRIORS):
    xy = rng.uniform(0.05, 0.95, (k, 2))
    wh = rng.uniform(0.05, 0.4, (k, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


def _case(seed, b=3, g=5, empty=(1,)):
    rng = np.random.default_rng(seed)
    priors = _priors(rng)
    loc = rng.normal(0, 1.5, (b, K_PRIORS, 4)).astype(np.float32)
    conf = rng.normal(0, 3, (b, K_PRIORS, CLASSES)).astype(np.float32)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.05, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.integers(0, CLASSES - 1, (b, g)).astype(np.int32)
    valid = np.arange(g)[None, :] < rng.integers(1, g + 1, b)[:, None]
    for i in empty:
        valid[i] = False
    boxes[~valid] = 0.0
    return loc, conf, boxes, labels, valid, priors


def _jax_value_and_grads(loc, conf, boxes, labels, valid, priors, dtype=jnp.float32):
    def total(lp, cp, which):
        ll, lc = jax_loss(lp, cp, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid),
                          jnp.asarray(priors))
        return (ll, lc)[which]

    lp, cp = jnp.asarray(loc, dtype), jnp.asarray(conf, dtype)
    ll, lc = jax.jit(jax_loss)(lp, cp, jnp.asarray(boxes), jnp.asarray(labels),
                               jnp.asarray(valid), jnp.asarray(priors))
    g_loc = jax.jit(jax.grad(lambda lp: total(lp, cp, 0)))(lp)
    g_conf = jax.jit(jax.grad(lambda cp: total(lp, cp, 1)))(cp)
    return float(ll), float(lc), np.asarray(g_loc, np.float32), np.asarray(g_conf, np.float32)


def _port_value_and_grads(loc, conf, boxes, labels, valid, priors, dtype=torch.float32):
    lp = torch.from_numpy(loc).to(dtype).requires_grad_()
    cp = torch.from_numpy(conf).to(dtype).requires_grad_()
    ll, lc = multibox_loss(lp, cp, torch.from_numpy(boxes), torch.from_numpy(labels),
                           torch.from_numpy(valid), torch.from_numpy(priors))
    assert ll.dtype == lc.dtype == torch.float32
    (g_loc,) = torch.autograd.grad(ll, lp, retain_graph=True)
    (g_conf,) = torch.autograd.grad(lc, cp)
    return float(ll.detach()), float(lc.detach()), g_loc.float().numpy(), g_conf.float().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_and_grads_equal_jax(seed):
    case = _case(seed)
    want = _jax_value_and_grads(*case)
    got = _port_value_and_grads(*case)
    assert got[0] > 0 and got[1] > 0
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-7)


def test_loss_equals_oracle():
    """The reference semantics: the oracle's ragged GT lists in float64 (it
    has no empty-image case, so every image here has GT)."""
    loc, conf, boxes, labels, valid, priors = _case(5, empty=())
    got = _port_value_and_grads(loc, conf, boxes, labels, valid, priors)
    ol, oc = oracle.multibox_loss(loc.astype(np.float64), conf.astype(np.float64),
                                  [boxes[i][valid[i]] for i in range(3)],
                                  [labels[i][valid[i]].astype(np.int64) for i in range(3)],
                                  priors.astype(np.float64))
    np.testing.assert_allclose(got[:2], [ol, oc], rtol=1e-4)


def test_all_background_batch():
    """No valid GT anywhere: no positive, no mined negative, both terms 0
    (divided by max(0, 1)), gradients 0."""
    loc, conf, boxes, labels, valid, priors = _case(3, empty=(0, 1, 2))
    want = _jax_value_and_grads(loc, conf, boxes, labels, valid, priors)
    got = _port_value_and_grads(loc, conf, boxes, labels, valid, priors)
    assert got[0] == want[0] == 0.0 and got[1] == want[1] == 0.0
    assert not got[2].any() and not got[3].any()


def test_bf16_inputs_upcast_first():
    """bf16 predictions (a bf16 forward's outputs) are upcast before any
    arithmetic: the loss equals JAX's on the same bf16 values."""
    loc, conf, boxes, labels, valid, priors = _case(4)
    loc = torch.from_numpy(loc).to(torch.bfloat16).float().numpy()  # bf16-exact values
    conf = torch.from_numpy(conf).to(torch.bfloat16).float().numpy()
    want = _jax_value_and_grads(loc, conf, boxes, labels, valid, priors, jnp.bfloat16)
    got = _port_value_and_grads(loc, conf, boxes, labels, valid, priors, torch.bfloat16)
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    # the gradients come back in bf16 on both sides: one bf16 ulp
    np.testing.assert_allclose(got[2], want[2], rtol=2 ** -7, atol=1e-7)
    np.testing.assert_allclose(got[3], want[3], rtol=2 ** -7, atol=1e-7)


@pytest.mark.parametrize("levels", [0, 4, 1])
def test_hard_negative_ranks_equal_jax_with_ties(levels):
    """levels 0: distinct losses; 4: four distinct values (many exact ties);
    1: every loss equal, so the ranks are the indices."""
    rng = np.random.default_rng(levels)
    x = rng.uniform(0, 5, (4, 257)).astype(np.float32)
    if levels:
        x = np.floor(x * levels / 5).astype(np.float32)
    x[:, ::9] = 0.0  # the positives' zeros
    got = hard_negative_ranks(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ranks(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert (np.sort(got, 1) == np.arange(257)).all()  # a permutation per row
    if levels == 1:
        np.testing.assert_array_equal(got, np.tile(np.arange(257), (4, 1)))


def test_smooth_l1_equals_torch():
    x = torch.linspace(-3, 3, 601)
    torch.testing.assert_close(smooth_l1(x), torch.nn.functional.smooth_l1_loss(
        x, torch.zeros_like(x), reduction="none"), rtol=0, atol=0)
