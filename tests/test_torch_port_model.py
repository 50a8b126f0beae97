"""The port's model layers, a narrow SSD and the SSD300 structure against JAX.

Inputs and weights are made on the JAX side (weights by flax's own init from
a seed, images with numpy) and carried into the port by
``ssds_tpu_torch.weights.state_dict_from_jax``.

Tolerances (float32 throughout):
- pooling selects, so ``MaxPool`` is compared exactly;
- ``L2Norm`` is a sum of 8-64 squares, a sqrt and a division: rtol 1e-6;
- the narrow SSD sums a few hundred products per output in another order
  in XLA's and PyTorch's CPU convolutions, over six layers: loc with
  rtol 1e-4 / atol 1e-5 (|loc| is O(1)); softmax probabilities with
  atol 5e-6: they lie in [0, 1], but the logits reach |10| on these inputs,
  so their ~1e-6 relative error moves a probability by up to ~2.5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.models import builder as jbuilder
from ssds_tpu.models import layers as jl
from ssds_tpu.models.heads.ssd import build_ssd as jax_build_ssd
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.models import layers as tl
from ssds_tpu_torch.models.builder import create_model, create_priors
from ssds_tpu_torch.models.heads.ssd import build_ssd
from ssds_tpu_torch.weights import state_dict_from_jax


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("window,stride,padding,ceil,size", [
    (2, 2, 0, True, 75),   # VGG pool3: 75 -> 38
    (2, 2, 0, False, 75),  # floor mode: 75 -> 37
    (3, 1, 1, False, 19),  # VGG pool5: 3x3 stride 1 pad 1
    (2, 2, 0, True, 8),
])
def test_maxpool_equals_jax(window, stride, padding, ceil, size):
    x = np.random.default_rng(size).normal(0, 1, (2, size, size, 5)).astype(np.float32)
    want = np.asarray(jl.MaxPool(window, stride, padding, ceil).apply({}, jnp.asarray(x)))
    got = tl.MaxPool(window, stride, padding, ceil)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    if ceil and size == 75:
        assert got.shape[1:3] == (38, 38)
    np.testing.assert_array_equal(got, want)


def test_l2norm_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 6, 6, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero pixel: eps keeps it finite
    scale = rng.uniform(5, 25, 64).astype(np.float32)
    want = np.asarray(jl.L2Norm().apply({"params": {"scale": jnp.asarray(scale)}},
                                        jnp.asarray(x)))
    layer = tl.L2Norm(64)
    layer.weight.data = torch.from_numpy(scale)
    got = layer(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[0, 0, 0] == 0).all()
    bf = layer(_nchw(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16  # computed in float32, cast back


# A narrow SSD: conv / relu / ceil pool / conv / relu / pool5-style pool /
# dilated conv / relu, taps at 1 and 7, one 'S' and one '' extra block.
_FEATURE_LAYER = [[1, 7, "S", ""], [8, 16, 16, 16]]
_MBOX = [4, 6, 6, 4]
_CLASSES = 5


def _jax_base():
    return [lambda: jl.Conv(8, kernel=3, padding=1), lambda: jl.ReLU(),
            lambda: jl.MaxPool(2, 2, ceil_mode=True),
            lambda: jl.Conv(16, kernel=3, padding=1), lambda: jl.ReLU(),
            lambda: jl.MaxPool(3, 1, 1),
            lambda: jl.Conv(16, kernel=3, padding=2, dilation=2), lambda: jl.ReLU()]


def _port_base():
    return [lambda c: tl.Conv(c, 8, kernel=3, padding=1), lambda c: tl.ReLU(),
            lambda c: tl.MaxPool(2, 2, ceil_mode=True),
            lambda c: tl.Conv(c, 16, kernel=3, padding=1), lambda c: tl.ReLU(),
            lambda c: tl.MaxPool(3, 1, 1),
            lambda c: tl.Conv(c, 16, kernel=3, padding=2, dilation=2), lambda c: tl.ReLU()]


def _narrow_pair(seed=0):
    jmodel = jax_build_ssd(_jax_base(), _FEATURE_LAYER, _MBOX, _CLASSES)
    x0 = jnp.zeros((1, 23, 23, 3), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda r: jmodel.init(r, x0, phase="train"))(jax.random.PRNGKey(seed)))
    tmodel = build_ssd(_port_base(), _FEATURE_LAYER, _MBOX, _CLASSES)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel.eval()


def test_narrow_ssd_eval_equals_jax():
    jmodel, variables, tmodel = _narrow_pair()
    x = np.random.default_rng(1).normal(0, 50, (2, 23, 23, 3)).astype(np.float32)
    want_loc, want_conf = (np.asarray(a) for a in jax.jit(
        lambda v, x: jmodel.apply(v, x, phase="eval"))(variables, jnp.asarray(x)))
    with torch.no_grad():
        feats = tmodel(_nchw(x), phase="feature")
        got_loc, got_conf = (a.numpy() for a in tmodel(_nchw(x), phase="eval"))
    # 23 -> ceil pool 12; taps 23x23 and 12x12, extras 'S' 6x6 and '' 4x4
    assert [tuple(f.shape[2:]) for f in feats] == [(23, 23), (12, 12), (6, 6), (4, 4)]
    k = 23 * 23 * 4 + 12 * 12 * 6 + 6 * 6 * 6 + 4 * 4 * 4
    assert got_loc.shape == want_loc.shape == (2, k, 4)
    assert got_conf.shape == want_conf.shape == (2, k, _CLASSES)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_conf, want_conf, rtol=0, atol=5e-6)


def test_bridge_round_trip_through_torch_import(tmp_path):
    """JAX params -> port state dict -> .pth -> the JAX package's own importer:
    every tensor placed by its primary rule and identical to the original."""
    _, variables, tmodel = _narrow_pair(seed=3)
    pth = tmp_path / "narrow.pth"
    torch.save(tmodel.state_dict(), pth)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    assert stats["loaded"] == len(tmodel.state_dict())
    want = traverse_util.flatten_dict(variables)
    got = traverse_util.flatten_dict(back)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=str(key))


def test_ssd300_structure_equals_jax():
    """SSD300-VGG16 without full-size arithmetic: the port's meta-device build
    against ``jax.eval_shape`` of the JAX init, parameter by parameter."""
    cfg = default_config()
    model, fmaps = create_model(cfg.MODEL)
    assert fmaps == [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    assert create_priors(cfg.MODEL, fmaps).shape == (8732, 4)
    assert len(model.base) == 35
    jcfg = jax_default_config()
    jcfg.MODEL.S2D_STEM = 0  # the serving stem; the tree is the same either way
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert [tuple(f) for f in jfmaps] == fmaps
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 300, 300, 3)), phase="train"),
                            jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged = state_dict_from_jax(zeros)
    ours = model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name
    assert sum(t.numel() for t in ours.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
