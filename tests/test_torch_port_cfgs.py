"""Every ``experiments/cfgs/*.yml`` builds in the port as in the JAX package,
and SSD512-VGG16 runs at full size.

For each yml (one case each): the port's ``create_model`` feature maps
against the JAX package's (``jax.eval_shape``, no arithmetic on either
side), the priors bit for bit (none for a YOLO head, on either side), and
every parameter and running statistic by name and shape: the bridge's name
of each flax leaf (``ssds_tpu_torch.weights``) against the port model's
state dict, with nothing left over on either side.

SSD512-VGG16 (``ssd_vgg16_train_voc_512.yml``) is pinned: seven maps
64/32/16/8/4/2/1 and 24,564 priors, its written-out config equal to the
yml, and one float32 forward at 512 px with random weights (numpy, from a
seed) against JAX's: ``loc`` and the softmax within atol 1e-4 of their
largest value, rtol 1e-4 (sums of up to 4608 products in other orders
through 15 VGG convs, the 7 extra blocks and the heads).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.models import builder as jbuilder
from ssds_tpu_torch.config import cfg_from_file, ssd512_vgg16_config
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model, is_yolo
from test_torch_port_bn_layers import _nchw, _random_variables
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_heads import bridge, jax_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(glob.glob(os.path.join(REPO, "experiments/cfgs/*.yml")))
SSD512 = os.path.join(REPO, "experiments/cfgs/ssd_vgg16_train_voc_512.yml")
RTOL, ATOL = 1e-4, 1e-4


def test_every_yml_is_a_case():
    assert len(YMLS) == 24


@pytest.mark.parametrize("yml", YMLS, ids=os.path.basename)
def test_yml_builds_as_in_jax(yml):
    jcfg, tcfg = jax_cfg_from_file(yml), cfg_from_file(yml)
    model, fmaps = create_model(tcfg.MODEL)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps]
    if is_yolo(tcfg.MODEL):
        assert str(jcfg.MODEL.SSDS).startswith("yolo")
    else:
        got = create_priors(tcfg.MODEL, fmaps)
        want = jbuilder.create_priors(jcfg.MODEL, jfmaps)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))
    shapes = jax_shapes(jmodel, int(tcfg.MODEL.IMAGE_SIZE[0]))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged, ours = bridge(zeros, tcfg.MODEL), model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name


def test_written_out_ssd512_config_equals_its_yml():
    """``config.ssd512_vgg16_config`` (read where PyYAML is missing) is the
    yml loaded through ``cfg_from_file``, key for key."""
    assert ssd512_vgg16_config() == cfg_from_file(SSD512)


def test_ssd512_maps_and_priors():
    _, fmaps = create_model(ssd512_vgg16_config().MODEL)
    assert fmaps == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    assert create_priors(ssd512_vgg16_config().MODEL, fmaps).shape == (24564, 4)


def test_ssd512_forward_equals_jax():
    jcfg, tcfg = jax_cfg_from_file(SSD512), ssd512_vgg16_config()
    jmodel, _ = jbuilder.create_model(jcfg.MODEL)
    variables = _random_variables(jax_shapes(jmodel, 512), np.random.default_rng(3))
    model = init_model(create_model(tcfg.MODEL)[0])
    model.load_state_dict(bridge(variables, tcfg.MODEL), strict=True)
    x = np.random.default_rng(4).normal(0, 60, (1, 512, 512, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(lambda v, x: jmodel.apply(
        v, x, phase="eval", train=False))(variables, jnp.asarray(x))]
    with torch.no_grad():
        got = [a.numpy() for a in model.eval()(_nchw(x), phase="eval")]
    assert [g.shape for g in got] == [w.shape for w in want] == [(1, 24564, 4), (1, 24564, 21)]
    for name, g, w in zip(("loc", "conf"), got, want):
        print(f"SSD512 {name}: max|d| {np.abs(g - w).max():.2e} of max|{name}| "
              f"{np.abs(w).max():.2e}")
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * float(np.abs(w).max()),
                                   err_msg=name)
