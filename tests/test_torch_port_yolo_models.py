"""The DarkNet backbones and the YOLO heads in the port against the JAX package.

Models get the same random variables on both sides (``tests/torch_port_heads.py``),
with the residual branches' last BatchNorm and the predictors scaled by 0.1
(:func:`_tame`: 23 residual blocks of unit gain would otherwise grow the
activations past float32 and the decode's ``exp`` past any box). Covered:
``darknet_19`` / ``darknet_53``'s flat lists (their length and every layer's
output shape, the taps' included) and a float32 forward at 64 x 64 through
every layer; ``DarkResidual`` and ``ConvSet`` in eval and train mode
(outputs, gradients, running statistics); the channel check; every ``experiments/cfgs/yolo_*.yml`` built with JAX's
feature maps; the two configs written out; the ``.pth`` round trip through
``ssds_tpu.torch_import``; the scope words.

Tolerances, with what was measured:

- blocks, float32: as ``tests/test_torch_port_rfb.py`` (outputs rtol / atol
  1e-5, running statistics rtol 1e-6 / atol 1e-7, each gradient within 1e-5
  of its largest element or of a tenth of the block's largest gradient);
- backbones, float32, every layer's output: rtol 1e-5, atol 1e-5 of the
  layer's largest value (measured 6.0e-7 at most over both nets);
- the ``.pth`` round trip: equal tensors.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from ssds_tpu import checkpoint as jax_ckpt
from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.models import builder as jbuilder
from ssds_tpu.models.backbones import darknet as jdarknet
from ssds_tpu.models.heads import yolo as jyolo
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import (cfg_from_file, yolo_v2_darknet19_config,
                                   yolo_v3_darknet53_config)
from ssds_tpu_torch.models.backbones import darknet as tdarknet
from ssds_tpu_torch.models.backbones import networks_map
from ssds_tpu_torch.models.builder import create_model, init_model
from ssds_tpu_torch.models.heads import ssds_map
from ssds_tpu_torch.models.heads import yolo as tyolo
from ssds_tpu_torch.models.layers import BatchNorm, build_layers
from ssds_tpu_torch.weights import port_name, state_dict_from_jax
from test_torch_port_bn_layers import _nchw, _nhwc, _random_variables
from test_torch_port_checkpoint import config_scopes
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_heads import (block_state, bridge, check_block_eval, check_block_train,
                              configs, head_pair, jax_shapes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
STATS_TOL = (1e-6, 1e-7)
YMLS = ["yolo_v3_darknet_53_train_voc.yml", "yolo_v3_darknet_53_train_coco.yml",
        "yolo_v2_darknet_19_train_voc.yml", "yolo_v3_mobilenetv1_train_voc.yml",
        "yolo_v2_mobilenetv1_train_voc.yml"]

# (ssds, net, image, FEATURE_LAYER, ASPECT_RATIOS) at 64 px: the paper anchors
DARKNET_V3 = ("yolo_v3", "darknet_53", 64, [[14, 23, 28], [256, 512, 1024]], [[2], [2], [2]])
DARKNET_V2 = ("yolo_v2", "darknet_19", 64, [[16, 22], [512, 1024]], [[2]])
# tests/test_yolo_overfit.py's MobileNetV1-0.25 heads (its anchors in MODEL.ANCHORS)
MBV1_V3 = ("yolo_v3", "mobilenet_v1_025", 64, [[5, 11, 13], [64, 128, 256]], [[2], [2], [2]])
MBV1_V2 = ("yolo_v2", "mobilenet_v1_025", 64, [[11, 13], [128, 256]], [[2]])
SMALL_ANCHORS = {"yolo_v3": [[[16, 16]], [[24, 24]], [[32, 32]]],
                 "yolo_v2": [[[16, 16], [32, 32]]]}


def _tame(variables):
    """Scale, in place, every residual block's second BatchNorm and every
    predictor by 0.1."""
    for path, v in traverse_util.flatten_dict(variables["params"]).items():
        residual = path[0].startswith("base_layers") and path[1:3] == ("ConvBNReLU_1",
                                                                         "BatchNorm_0")
        if residual or path[0].startswith("conf"):
            v *= np.float32(0.1)


def _pair(model, seed=21):
    anchors = {} if "darknet" in model[1] else {"ANCHORS": SMALL_ANCHORS[model[0]]}
    return head_pair(*model, seed=seed, tame=_tame, **anchors)


def test_registries_hold_darknet_and_yolo():
    assert {"darknet_19", "darknet_53"} <= set(networks_map)
    assert {"yolo_v2", "yolo_v3"} <= set(ssds_map)


# --------------------------------------------------------------------------
# backbones and blocks
# --------------------------------------------------------------------------


class _JaxBase(fnn.Module):
    """A JAX backbone's layer list alone, every layer's output returned."""

    specs: tuple

    def setup(self):
        self.base_layers = [s() for s in self.specs]

    def __call__(self, x, train: bool = False):
        outs = []
        for layer in self.base_layers:
            x = layer(x, train)
            outs.append(x)
        return outs


@pytest.mark.parametrize("net,taps", [("darknet_19", (16, 22)), ("darknet_53", (14, 23, 28))])
def test_darknet_layers_equal_jax(net, taps):
    """The flat list is the API: the same length, every layer's output shape
    (the taps' strides and widths with them), and the float32 values of
    every layer in eval mode."""
    jbase = _JaxBase(tuple(getattr(jdarknet, net)()))
    x = np.random.default_rng(0).normal(0, 60, (2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: jbase.init(r, jnp.asarray(x)), jax.random.PRNGKey(0))
    variables = _random_variables(shapes, np.random.default_rng(1))
    _tame(variables)
    want = [np.asarray(a) for a in jax.jit(lambda v, x: jbase.apply(v, x))(variables, x)]

    layers, widths = build_layers(getattr(tdarknet, net)(), 3)
    sd = {k[len("base."):]: v for k, v in state_dict_from_jax(variables, net=net,
                                                               ssds="yolo_v3").items()}
    layers.load_state_dict(sd, strict=True)
    assert len(layers) == len(want) == {"darknet_19": 23, "darknet_53": 29}[net]
    y = _nchw(x)
    with torch.no_grad():
        for i, (layer, w) in enumerate(zip(layers.eval(), want)):
            y = layer(y)
            assert _nhwc(y).shape == w.shape and widths[i] == w.shape[-1], (i, y.shape, w.shape)
            np.testing.assert_allclose(_nhwc(y), w, rtol=RTOL,
                                       atol=ATOL * float(np.abs(w).max()), err_msg=f"layer {i}")
    strides = [64 // want[t].shape[1] for t in taps]
    assert strides == ([16, 32] if net == "darknet_19" else [8, 16, 32])
    assert [want[t].shape[-1] for t in taps] == ([512, 1024] if net == "darknet_19"
                                                  else [256, 512, 1024])


# (id, flax block, port block from its input width, flax prefix, port prefix, net)
BLOCKS = [
    ("dark_residual", lambda: jdarknet.DarkResidual(16),
     lambda cin: tdarknet.DarkResidual(cin, 16), "base_layers_0/", "base.0.", "darknet_53"),
    ("conv_set", lambda: jyolo.ConvSet(16), lambda cin: tyolo.ConvSet(cin, 16),
     "extras_t16/", "extras_t16.", "darknet_53"),
]


def _block_names(case):
    _, _, _, prefix, strip, net = case
    return lambda v: block_state(v, prefix, strip, net=net, ssds="yolo_v3")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_yolo_block_equals_flax(case, train):
    rng = np.random.default_rng(7)
    x = rng.normal(0.5, 2.0, (4, 9, 9, 16)).astype(np.float32)
    jblock = case[1]()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    tblock = case[2](16)
    tblock.load_state_dict(_block_names(case)(variables), strict=True)
    if train:
        check_block_train(jblock, variables, tblock, x, _block_names(case), rng, (RTOL, ATOL),
                          STATS_TOL)
    else:
        check_block_eval(jblock, variables, tblock, x, RTOL, ATOL)


# --------------------------------------------------------------------------
# whole models (served: tests/test_torch_port_yolo_detector.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ssds", ["yolo_v2", "yolo_v3"])
def test_declared_channels_that_disagree_raise(ssds):
    model = MBV1_V2 if ssds == "yolo_v2" else MBV1_V3
    bad = [model[3][0], [c + 8 for c in model[3][1]]]
    jcfg, tcfg = configs(*model[:3], bad, model[4], ANCHORS=SMALL_ANCHORS[ssds])
    with pytest.raises(ValueError, match="FEATURE_LAYER declares channels"):
        jbuilder.create_model(jcfg.MODEL)
    with pytest.raises(ValueError, match="FEATURE_LAYER declares channels"):
        create_model(tcfg.MODEL)


# --------------------------------------------------------------------------
# configs, structure, import, scopes
# --------------------------------------------------------------------------


def _yml(name):
    return os.path.join(REPO, "experiments/cfgs", name)


@pytest.mark.parametrize("make,yml", [
    (yolo_v3_darknet53_config, "yolo_v3_darknet_53_train_voc.yml"),
    (yolo_v2_darknet19_config, "yolo_v2_darknet_19_train_voc.yml")], ids=["v3", "v2"])
def test_yolo_config_equals_its_yml(make, yml):
    assert make() == cfg_from_file(_yml(yml))


@pytest.mark.parametrize("yml", YMLS)
def test_yolo_yml_builds_as_in_jax(yml):
    """Each experiment config at 416 px, built on ``meta``, against
    ``jax.eval_shape`` of the JAX init: the feature maps, the decoded box
    count, the BatchNorm count, and every parameter and running statistic
    by name (the bridge's) and shape."""
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    model, fmaps = create_model(tcfg.MODEL)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps]
    want_boxes = {3: 10647, 2: 845}[model.version]
    assert model.num_boxes(fmaps) == want_boxes
    bns = sum(isinstance(m, BatchNorm) for m in model.modules())
    if "darknet" in yml:
        assert bns == (72 if model.version == 3 else 22)
    shapes = jax_shapes(jmodel, 416)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged, ours = bridge(zeros, tcfg.MODEL), model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name


def _full_size(yml):
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    return jbuilder.create_model(jcfg.MODEL)[0], tcfg


@pytest.mark.parametrize("yml", ["yolo_v3_darknet_53_train_voc.yml",
                                 "yolo_v2_darknet_19_train_voc.yml"], ids=["v3", "v2"])
def test_yolo_pth_round_trip_through_torch_import(yml, tmp_path):
    """The full-size model's state dict (random weights and BN buffers) ->
    ``.pth`` -> the JAX package's importer: every array placed, none relaxed,
    and the bridge maps them back to the same tensors."""
    jmodel, tcfg = _full_size(yml)
    model = init_model(create_model(tcfg.MODEL)[0], seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen))
    pth = tmp_path / "yolo.pth"
    torch.save(model.state_dict(), pth)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes(jmodel, 416))
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    ours = model.state_dict()
    assert stats["loaded"] == sum(not k.endswith("num_batches_tracked") for k in ours)
    again = bridge(back, tcfg.MODEL)
    assert sorted(again) == sorted(ours)
    for name, t in ours.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(again[name], t), name


@pytest.mark.parametrize("yml", ["yolo_v3_darknet_53_train_voc.yml",
                                 "yolo_v2_darknet_19_train_voc.yml"], ids=["v3", "v2"])
def test_yolo_scope_equals_jax(yml):
    """Every parameter, under every config's scope words: the port selects
    what the JAX package selects."""
    jmodel, tcfg = _full_size(yml)
    paths = list(traverse_util.flatten_dict(jax_shapes(jmodel, 416)["params"]))
    for scope in config_scopes():
        for path in paths:
            name = port_name("/".join(path), tcfg.MODEL.NETS, tcfg.MODEL.SSDS)
            assert ckpt.path_in_scope(name, scope) == jax_ckpt.path_in_scope(path, scope), \
                (scope, path, name)
