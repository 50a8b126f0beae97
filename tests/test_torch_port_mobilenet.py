"""SSDLite over MobileNet V1 / V2 in the port against the JAX package: the
structure of the two 300 px configs, the reference torch layout, and the
``.pth`` round trip through the JAX package's importer.

``tests/test_torch_port_mobilenet_widths.py`` holds the forward of every
width; its helpers live here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ref_torch_skeletons import build_skeleton
from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.models import builder as jbuilder
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch.config import cfg_from_file
from ssds_tpu_torch.models.backbones import networks_map
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
from ssds_tpu_torch.models.heads import ssds_map
from ssds_tpu_torch.weights import state_dict_from_jax
from test_torch_port_bn_layers import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = {"mobilenet_v1": "experiments/cfgs/ssd_lite_mobilenetv1_train_voc.yml",
        "mobilenet_v2": "experiments/cfgs/ssd_lite_mobilenetv2_train_voc.yml"}
# (parameters, batch_stats values, BatchNorm layers) of the 300 px configs,
# from jax.eval_shape of the JAX init
COUNTS = {"mobilenet_v1": (4256196, 25344, 35), "mobilenet_v2": (3311012, 37568, 60)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for PyTorch while a module of these tests runs:
    under pytest-xdist each worker would otherwise start a thread for every
    core, and the workers' threads then crowd each other out."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lite_configs(net, image=300, **model):
    """The JAX and port configs of the SSDLite yml of ``net``'s family, with
    ``MODEL.NETS = net``, a square ``image`` and the ``model`` overrides."""
    path = os.path.join(REPO, CFGS[net[:len("mobilenet_v1")]])
    out = []
    for load in (jax_cfg_from_file, cfg_from_file):
        cfg = load(path)
        cfg.MODEL.update(NETS=net, IMAGE_SIZE=[image, image], **model)
        out.append(cfg)
    return out


def jax_shapes(jmodel, image):
    return jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, image, image, 3)), phase="train"),
                          jax.random.PRNGKey(0))


def lite_pair(net, image, seed=0, **model):
    """``(jmodel, variables, tmodel, cfg)``: the JAX SSDLite with random
    variables (every BN's scale, bias and running statistics too) and the
    port's model carrying them through ``state_dict_from_jax``; ``cfg`` is
    the port's config."""
    jcfg, tcfg = lite_configs(net, image, **model)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    variables = _random_variables(jax_shapes(jmodel, image), np.random.default_rng(seed))
    tmodel, fmaps = create_model(tcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps]
    tmodel = init_model(tmodel, seed)
    tmodel.load_state_dict(state_dict_from_jax(variables, net=net), strict=True)
    return jmodel, variables, tmodel, tcfg


def test_registries_hold_every_mobilenet_and_ssd_lite():
    assert {f"mobilenet_v{v}{w}" for v in (1, 2) for w in ("", "_075", "_050", "_025")} \
        <= set(networks_map)
    assert "ssd_lite" in ssds_map


@pytest.mark.parametrize("net", ["mobilenet_v1", "mobilenet_v2"])
def test_ssd_lite_300_structure_equals_jax(net):
    """The yml config at full size, built on ``meta``, against ``jax.eval_shape``
    of the JAX init: every parameter and running statistic by name and shape,
    and the counts."""
    jcfg, tcfg = lite_configs(net)
    model, fmaps = create_model(tcfg.MODEL)
    assert fmaps == [(19, 19), (10, 10), (5, 5), (3, 3), (2, 2), (1, 1)]
    assert create_priors(tcfg.MODEL, fmaps).shape == (3000, 4)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert [tuple(f) for f in jfmaps] == fmaps
    shapes = jax_shapes(jmodel, 300)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged = state_dict_from_jax(zeros, net=net)
    ours = model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name
    n_params, n_stats, n_bn = COUNTS[net]
    assert sum(p.numel() for p in model.parameters()) == n_params == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    stats = [b for n, b in model.named_buffers() if not n.endswith("num_batches_tracked")]
    assert sum(b.numel() for b in stats) == n_stats == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["batch_stats"]))
    assert len(stats) == 2 * n_bn


@pytest.mark.parametrize("net,skeleton", [("mobilenet_v1", "mbv1"), ("mobilenet_v2", "mbv2")])
def test_ssd_lite_layout_equals_reference_skeleton(net, skeleton):
    """The port's state-dict keys, ``num_batches_tracked`` included, are those
    of the reference torch modules (``tests/ref_torch_skeletons.py``)."""
    jcfg, tcfg = lite_configs(net)
    jmodel, _ = jbuilder.create_model(jcfg.MODEL)
    ref = build_skeleton("ssd_lite", jax_shapes(jmodel, 300), skeleton).state_dict()
    ours = create_model(tcfg.MODEL)[0].state_dict()
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        assert tuple(ref[name].shape) == tuple(t.shape), name


@pytest.mark.parametrize("net", ["mobilenet_v1_025", "mobilenet_v2_025"])
def test_pth_round_trip_through_torch_import(net, tmp_path):
    """The port's state dict (random BN buffers) -> ``.pth`` -> the JAX
    package's importer: every ``params`` and ``batch_stats`` array placed by
    its primary rule, and the bridge maps them back to the same tensors."""
    jcfg, tcfg = lite_configs(net, 96)
    model = init_model(create_model(tcfg.MODEL)[0], seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    pth = tmp_path / "lite.pth"
    torch.save(model.state_dict(), pth)
    jmodel, _ = jbuilder.create_model(jcfg.MODEL)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes(jmodel, 96))
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    ours = model.state_dict()
    assert stats["loaded"] == sum(not k.endswith("num_batches_tracked") for k in ours)
    assert sorted(traverse_util.flatten_dict(back)) == sorted(traverse_util.flatten_dict(zeros))
    again = state_dict_from_jax(back, net=net)
    assert sorted(again) == sorted(ours)
    for name, t in ours.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(again[name], t), name
