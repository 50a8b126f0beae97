"""ResNet-18/34/50/101 in the port against the JAX package.

Models get the same random variables on both sides (``tests/torch_port_heads.py``:
every kernel, BatchNorm scale, bias and running statistic drawn with numpy
from a seed, carried into the port by ``ssds_tpu_torch.weights``). Covered:
each backbone's flat layer list (length, stage ends, every layer's output
shape and float32 values in eval mode, resnet_101 at full depth); an SSD
over each backbone in the ``feature`` phase; SSD300-shaped detectors over
resnet_18 and resnet_50 served in float32 and bf16; one train step of a tiny
SSD over resnet_18 (``tests/test_heads_train.py``'s config) against
``ssds_tpu.solver.build_train_step``; the bridge's ResNet names; the ``.pth``
round trip through ``ssds_tpu.torch_import``; the scope words; checkpoints
and the train / eval modes through the port's Solver step.

Tolerances, with what was measured:

- layers and the ``feature`` phase, float32: rtol 1e-4 and atol 1e-4 of
  the output's largest value (convolutions summing up to 4608 products in
  other orders in XLA's and PyTorch's CPU code);
- detectors: :data:`F32_TOL` and the bf16 rule of
  ``torch_port_heads.served_forward_against_jax``;
- blocks (``Stem``, ``BasicBlock``, ``Bottleneck``, with and without the
  projection), float32 in eval and train mode:
  ``tests/test_torch_port_bn_layers.py``'s tolerances, outputs within rtol
  / atol 1e-5, each gradient within 1e-5 of its largest element (or of a
  tenth of the block's largest gradient), running statistics within rtol
  1e-6 / atol 1e-7;
- the model's train step, float64 in both packages (the loss is float32 in
  both): the losses within rtol 1e-5, every parameter's update (the
  gradient times the learning rate, plus the decay) within 2e-4 of the
  model's largest update, the running statistics within 1e-6 of each one's
  largest value (:data:`STEP_LIMITS`);
- the ``.pth`` round trip and checkpoints: equal tensors.
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
from ssds_tpu.models.backbones import resnet as jresnet
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import cfg_from_file, ssd_resnet50_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.models.backbones import networks_map
from ssds_tpu_torch.models.backbones import resnet as tresnet
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
from ssds_tpu_torch.models.layers import BatchNorm, build_layers
from ssds_tpu_torch.solver import build_train_step, configure_lr_scheduler, configure_optimizer
from ssds_tpu_torch.weights import port_name, state_dict_from_jax
from test_torch_port_bn_layers import _nchw, _nhwc, _random_variables
from test_torch_port_checkpoint import config_scopes
from test_torch_port_lite_train import errors
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_heads import (block_state, bridge, check_block_eval, check_block_train,
                              head_pair, jax_shapes, jax_steps, port_steps,
                              served_forward_against_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-4
# net: (layers, stage ends, the stage ends' widths)
NETS = {"resnet_18": (9, (2, 4, 6, 8), (64, 128, 256, 512)),
        "resnet_34": (17, (3, 7, 13, 16), (64, 128, 256, 512)),
        "resnet_50": (17, (3, 7, 13, 16), (256, 512, 1024, 2048)),
        "resnet_101": (34, (3, 7, 30, 33), (256, 512, 1024, 2048))}
YMLS = ["ssd_resnet34_train_voc.yml", "ssd_resnet50_train_voc.yml", "ssd_resnet101_train_voc.yml"]


def _yml(name):
    return os.path.join(REPO, "experiments/cfgs", name)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_registries_hold_every_resnet():
    assert {"resnet_18", "resnet_34", "resnet_50", "resnet_101"} <= set(networks_map)


def test_written_out_resnet50_config_equals_its_yml():
    """``config.ssd_resnet50_config`` (read where PyYAML is missing) is the
    yml loaded through ``cfg_from_file``, key for key."""
    assert ssd_resnet50_config() == cfg_from_file(_yml("ssd_resnet50_train_voc.yml"))


# --------------------------------------------------------------------------
# backbones
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


@pytest.mark.parametrize("net", list(NETS))
def test_resnet_layers_equal_jax(net):
    """The flat list is the API: the same length, stage ends at the JAX
    package's indices with their strides and widths, every layer's output
    shape, and its float32 values in eval mode, through every block."""
    length, ends, widths_at_ends = NETS[net]
    jbase = _JaxBase(tuple(getattr(jresnet, net)()))
    x = np.random.default_rng(0).normal(0, 60, (2, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: jbase.init(r, jnp.asarray(x)), jax.random.PRNGKey(0))
    variables = _random_variables(shapes, np.random.default_rng(1))
    want = [np.asarray(a) for a in jax.jit(lambda v, x: jbase.apply(v, x))(variables, x)]

    layers, widths = build_layers(getattr(tresnet, net)(), 3)
    sd = {k[len("base."):]: v for k, v in state_dict_from_jax(variables, net=net).items()}
    layers.load_state_dict(sd, strict=True)
    assert len(layers) == len(want) == length
    worst = 0.0
    y = _nchw(x)
    with torch.no_grad():
        for i, (layer, w) in enumerate(zip(layers.eval(), want)):
            y = layer(y)
            assert _nhwc(y).shape == w.shape and widths[i] == w.shape[-1], (i, y.shape, w.shape)
            worst = max(worst, _close(_nhwc(y), w, f"layer {i}"))
    print(f"{net}: largest error over the layer's largest value {worst:.2e}")
    assert [64 // want[e].shape[1] for e in ends] == [4, 8, 16, 32]
    assert tuple(want[e].shape[-1] for e in ends) == widths_at_ends
    # the shortcut projection exactly where the stride or the width changes
    projects = [i for i, m in enumerate(layers) if getattr(m, "projects", False)]
    first = [1] if net in ("resnet_50", "resnet_101") else []  # 64 -> 256 channels
    assert projects == first + [ends[0] + 1, ends[1] + 1, ends[2] + 1]


# (id, flax block, port block from its input width, input width)
BLOCKS = [
    ("stem", lambda: jresnet._Stem(), tresnet.Stem, 3),
    ("basic", lambda: jresnet.BasicBlock(16), lambda cin: tresnet.BasicBlock(cin, 16), 16),
    ("basic_projected", lambda: jresnet.BasicBlock(24, stride=2),
     lambda cin: tresnet.BasicBlock(cin, 24, stride=2), 16),
    ("bottleneck", lambda: jresnet.Bottleneck(4), lambda cin: tresnet.Bottleneck(cin, 4), 16),
    ("bottleneck_projected", lambda: jresnet.Bottleneck(8, stride=2),
     lambda cin: tresnet.Bottleneck(cin, 8, stride=2), 16),
]
BLOCK_TOL, BLOCK_STATS_TOL = (1e-5, 1e-5), (1e-6, 1e-7)


def _block_names(variables):
    return block_state(variables, "base_layers_0/", "base.0.", net="resnet_50")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_resnet_block_equals_flax(case, train):
    _, jmake, tmake, cin = case
    rng = np.random.default_rng(7)
    x = rng.normal(0.5, 2.0, (4, 12, 12, cin)).astype(np.float32)
    jblock = jmake()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    tblock = tmake(cin)
    tblock.load_state_dict(_block_names(variables), strict=True)
    if train:
        check_block_train(jblock, variables, tblock, x, _block_names, rng, BLOCK_TOL,
                          BLOCK_STATS_TOL)
    else:
        check_block_eval(jblock, variables, tblock, x, *BLOCK_TOL)


def _ssd(net, image=64, half=False, seed=21):
    """``head_pair`` of an SSD over ``net`` tapping the ends of stages 2-4."""
    _, ends, widths = NETS[net]
    return head_pair("ssd", net, image, [list(ends[1:]) + ["S"], list(widths[1:]) + [256]],
                     [[2], [2, 3], [2, 3], [2]], seed=seed, HALF_PRECISION=half)


@pytest.mark.parametrize("net", list(NETS))
def test_resnet_ssd_features_equal_jax(net):
    """``phase="feature"``: the tapped sources, the first after L2Norm, and
    the extra block's, in float32 through the bridge."""
    jmodel, variables, tmodel, _, _ = _ssd(net)
    x = np.random.default_rng(2).normal(0, 60, (2, 64, 64, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jmodel.apply(variables, jnp.asarray(x), phase="feature",
                                                train=False)]
    with torch.no_grad():
        got = tmodel.eval()(_nchw(x), phase="feature")
    assert [tuple(_nhwc(g).shape[1:3]) for g in got] == [(8, 8), (4, 4), (2, 2), (1, 1)]
    errs = [_close(_nhwc(g), w, f"source {k}") for k, (g, w) in enumerate(zip(got, want))]
    print(f"{net}: sources' largest errors over their largest values {errs}")


# Detectors at 96 px, float32: loc within atol 2e-3 and the softmax within
# 2e-4 (measured 5.6e-4 / 1.0e-3 on resnet_18 / resnet_50 where |loc|
# reaches 913 / 1238 on these random weights, 1e-6 of it; the softmax
# 4.8e-5 / 4.6e-5: sums in other orders through 8 / 16 residual blocks).
# bf16: no further from JAX's float32 forward than twice JAX's own bf16
# forward (``served_forward_against_jax``).
F32_TOL = (2e-3, 2e-4)


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("net", ["resnet_18", "resnet_50"])
def test_resnet_detector_forward_equals_jax(net, half, tmp_path):
    """``ObjectDetector(device="cpu")`` on a ``.pth`` written by the bridge
    against the JAX model's eval forward; bf16 casts every conv, the
    BatchNorms keep their float32 statistics."""
    jmodel, variables, _, _, tcfg = _ssd(net, image=96, half=half)
    pth = tmp_path / "resnet.pth"
    torch.save(bridge(variables, tcfg.MODEL), pth)
    tcfg.RESUME_CHECKPOINT = str(pth)
    det = ObjectDetector(tcfg, device="cpu")
    stem = det.model.base[0].ConvBNReLU_0
    assert stem[0].weight.dtype == (torch.bfloat16 if half else torch.float32)
    assert stem[1].running_var.dtype == torch.float32
    x = np.random.default_rng(1).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    print(net, half, served_forward_against_jax(jmodel, variables, det, x, half, F32_TOL))
    assert det.detect_rows(x).shape == (2, 4, 100, 5)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

# tests/test_heads_train.py's SSD over resnet_18 at 96 px (taps 4 and 8).
# Limits on (loss, update, statistics), see the module docstring; the update's
# is wider than the blocks' gradient tolerance: the step is ill-conditioned
# (20 train-mode BatchNorms, 3 x 3 maps at stage 4, a float32 loss), and JAX's
# own float64 step moves 6.3e-5 of the largest update when its weights move
# 1e-7 of themselves, the port's distance from it (measured 6.3e-5; loss
# 1.1e-7, statistics 5.5e-8).
TRAIN_MODEL = ("ssd", "resnet_18", 96, [[4, 8, "S"], [128, 512, 256]], [[2], [2, 3], [2]])
STEP_LIMITS = (1e-5, 2e-4, 1e-6)


def test_resnet18_train_step_equals_jax_in_float64():
    """One train-mode step (batch statistics, SGD 1e-3 with momentum and
    decay on every parameter): the losses, every parameter's update and
    every running statistic against flax's, in float64."""
    pair = head_pair(*TRAIN_MODEL, seed=11)
    want, got = jax_steps(pair, "float64", steps=1), port_steps(pair, "float64", steps=1)
    (errs,) = errors(got, want)
    print(f"resnet_18 SSD step: loss {errs[0]:.2e}, update {errs[1]:.2e}, "
          f"statistics {errs[2]:.2e}")
    assert all(e < lim for e, lim in zip(errs, STEP_LIMITS)), (errs, STEP_LIMITS)
    start, end = got[0][2], got[1][2]
    moved = {n for n in end if not torch.equal(end[n], start[n])}
    assert {"base.0.ConvBNReLU_0.0.weight", "base.0.ConvBNReLU_0.1.running_var",
            "base.3.ConvBNReLU_2.1.bias", "base.8.ConvBNReLU_1.1.running_mean",
            "norm.weight", "extras.1.weight", "conf.2.bias"} <= moved


def _small_cfg(seed):
    cfg = cfg_from_file(_yml("ssd_resnet50_train_voc.yml"))
    cfg.MODEL.update(NETS="resnet_18", IMAGE_SIZE=[96, 96], FEATURE_LAYER=TRAIN_MODEL[3],
                     ASPECT_RATIOS=TRAIN_MODEL[4], SIZES=[0.2, 0.5, 0.8, 0.95])
    model, fmaps = create_model(cfg.MODEL)
    model = init_model(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return cfg, model, fmaps


def test_resnet_solver_step_modes_scopes_and_checkpoint(tmp_path):
    """The yml's ``TRAINABLE_SCOPE`` trains every parameter; the Solver's
    step runs the BatchNorms in train mode (every running statistic moves
    and ``num_batches_tracked`` counts it) and moves every backbone weight; a
    checkpoint keeps every BN buffer, and ``RESUME_SCOPE 'base'`` restores
    exactly the backbone, statistics included."""
    cfg, model, fmaps = _small_cfg(seed=1)
    opt = configure_optimizer(cfg.TRAIN, model.named_parameters())
    assert all(p.requires_grad for p in model.parameters())
    priors = torch.from_numpy(create_priors(cfg.MODEL, fmaps))
    step = build_train_step(model.train(), priors, opt, configure_lr_scheduler(cfg.TRAIN, 1),
                            torch.float32, cfg.DATASET.PIXEL_MEANS)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)),
             "boxes": torch.tensor([[[0.1, 0.1, 0.6, 0.5]], [[0.3, 0.2, 0.9, 0.8]]]),
             "labels": torch.tensor([[3], [7]], dtype=torch.int32),
             "valid": torch.ones(2, 1, dtype=torch.bool)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(batch, 0)
    after = model.state_dict()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 20 and all(int(m.num_batches_tracked) == 1 for m in bns)
    assert all(not torch.equal(after[n], before[n]) for n in after if n.startswith("base."))

    path = ckpt.save_checkpoint(str(tmp_path), "resnet", 1, model.state_dict())
    raw = torch.load(path, weights_only=True)["state_dict"]
    assert sum(k.endswith("running_var") for k in raw) == 20
    _, grafted, _ = _small_cfg(seed=2)
    kept = {k: v.clone() for k, v in grafted.state_dict().items()}
    grafted.load_state_dict(ckpt.resume_checkpoint(grafted.state_dict(), path,
                                                   str(cfg.TRAIN.RESUME_SCOPE)))
    for name, t in grafted.state_dict().items():
        want = after[name] if name.startswith("base.") else kept[name]
        assert torch.equal(t, want), name


# --------------------------------------------------------------------------
# names, import, scopes
# --------------------------------------------------------------------------


def test_bridge_names_resnet_blocks_by_their_flax_names():
    """``base_layers_{i}/ConvBNReLU_{g}`` is ``base.{i}.ConvBNReLU_{g}.{0,1}``
    for a ResNet, not the MobileNetV1 flat stack's ``base.{i}.{3g + j}``."""
    path = "base_layers_1/ConvBNReLU_3/Conv_0/kernel"
    assert port_name(path, "resnet_50") == "base.1.ConvBNReLU_3.0.weight"
    assert port_name(path, "mobilenet_v1") == "base.1.9.weight"
    assert port_name("base_layers_0/ConvBNReLU_0/BatchNorm_0/var", "resnet_18") == \
        "base.0.ConvBNReLU_0.1.running_var"


@pytest.mark.parametrize("net", list(NETS))
def test_bridge_maps_every_resnet_leaf_and_loads_strictly(net):
    """Every flax leaf of an SSD over ``net`` has a port name, and the dict
    loads into the port's model with ``strict=True``: no key left over on
    either side, every shape equal."""
    jmodel, variables, tmodel, _, tcfg = _ssd(net)
    sd = bridge(variables, tcfg.MODEL)
    n_leaves = sum(len(traverse_util.flatten_dict(variables[c])) for c in variables)
    n_bns = len(traverse_util.flatten_dict(variables["batch_stats"])) // 2
    assert len(sd) == n_leaves + n_bns  # + num_batches_tracked for each BatchNorm
    assert n_bns == sum(isinstance(m, BatchNorm) for m in tmodel.modules())
    tmodel.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("yml", ["ssd_resnet50_train_voc.yml"])
def test_resnet_pth_round_trip_through_torch_import(yml, tmp_path):
    """SSD300-ResNet50's state dict (random weights and BN buffers) ->
    ``.pth`` -> the JAX package's importer, which has no ResNet rule: its
    trailing-index rule places ``base.{i}.ConvBNReLU_{g}.{0,1}`` at
    ``base_layers_{i}/ConvBNReLU_{g}/{Conv_0,BatchNorm_0}``, every array
    placed, none relaxed, and the bridge maps them back to the same tensors."""
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    jmodel = jbuilder.create_model(jcfg.MODEL)[0]
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
    pth = tmp_path / "resnet.pth"
    torch.save(model.state_dict(), pth)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes(jmodel, 300))
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    ours = model.state_dict()
    assert stats["loaded"] == sum(not k.endswith("num_batches_tracked") for k in ours)
    assert sum(k.endswith("running_var") for k in ours) == 53
    again = bridge(back, tcfg.MODEL)
    assert sorted(again) == sorted(ours)
    for name, t in ours.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(again[name], t), name


@pytest.mark.parametrize("yml", YMLS)
def test_resnet_scope_equals_jax(yml):
    """Every parameter of the yml's model, under every config's scope words
    (``TRAINABLE_SCOPE 'base,norm,extras,loc,conf'`` and ``RESUME_SCOPE
    'base'`` among them): the port selects what the JAX package selects."""
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    jmodel = jbuilder.create_model(jcfg.MODEL)[0]
    scopes = config_scopes()
    assert {str(tcfg.TRAIN.TRAINABLE_SCOPE), str(tcfg.TRAIN.RESUME_SCOPE)} <= set(scopes)
    for path in traverse_util.flatten_dict(jax_shapes(jmodel, 300)["params"]):
        name = port_name("/".join(path), tcfg.MODEL.NETS, tcfg.MODEL.SSDS)
        for scope in scopes:
            assert ckpt.path_in_scope(name, scope) == jax_ckpt.path_in_scope(path, scope), \
                (scope, path, name)
