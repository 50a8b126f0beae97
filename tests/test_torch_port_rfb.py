"""The RFB heads (``rfb``, ``rfb_lite``) in the port against the JAX package.

Blocks and models get the same random variables on both sides
(``tests/torch_port_heads.py``). Covered: ``BasicRFB`` ('R': stride 1,
visual 2; 'S': stride 2, visual 1; plain and lite) and ``BasicRFB_a`` (1x3 /
3x1 kernels, dilations 1/3/3/5) in eval and train mode (outputs, gradients,
running statistics); the whole models through ``ObjectDetector`` in float32
and bf16; two train steps against ``ssds_tpu.solver.build_train_step``; the
experiment configs' structure, the reference torch layout and the ``.pth``
round trip through ``ssds_tpu.torch_import``; the scope words.

Tolerances, with what was measured:

- blocks, float32: outputs within rtol 1e-5 / atol 1e-5 and running
  statistics within rtol 1e-6 / atol 1e-7, as
  ``tests/test_torch_port_bn_layers.py`` states for the same BatchNorm
  arithmetic; each gradient within 1e-5 of its largest element, or of a
  tenth of the block's largest gradient (``torch_port_heads.check_block_train``:
  ``branch0.1``'s BN bias feeds ``ConvLinear``'s train-mode BN, which takes
  its shift back out);
- models through the detector: see :data:`DETECTOR_TOL`;
- train steps: see the comment above :data:`FLOAT64_LIMITS`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ref_torch_skeletons import build_skeleton
from ssds_tpu import checkpoint as jax_ckpt
from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.models import builder as jbuilder
from ssds_tpu.models import layers as jl
from ssds_tpu.models.heads import rfb as jrfb
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import cfg_from_file, rfb_vgg16_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.models import layers as tl
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
from ssds_tpu_torch.models.heads import rfb as trfb
from ssds_tpu_torch.weights import port_name
from test_torch_port_bn_layers import _random_variables
from test_torch_port_checkpoint import config_scopes
from test_torch_port_lite_train import errors
from test_torch_port_lite_train_lowp import statistics_errors
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_heads import (block_state, bridge, check_block_eval, check_block_train,
                              head_pair, jax_shapes, jax_steps, port_steps,
                              served_forward_against_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
STATS_TOL = (1e-6, 1e-7)

# (ssds, net, image, FEATURE_LAYER, ASPECT_RATIOS): tests/test_models.py's
# narrow VGG16 RFB at 96 px with a plain '' tail (maps 12/6/3/1), and
# tests/test_heads_overfit.py's MobileNetV1-0.25 RFBLite at 96 px (12/3/2)
VGG = ("rfb", "vgg16", 96, [[22, "R", "S", ""], [512, 1024, 512, 256]],
       [[2], [2, 3], [2], [2]])
MBV1 = ("rfb_lite", "mobilenet_v1_025", 96, [[5, "R", "S"], [64, 256, 128]], [[2], [2, 3], [2]])
YMLS = ["rfb_vgg16_train_voc.yml", "rfb_vgg16_train_coco.yml",
        "rfb_lite_mobilenetv1_train_voc.yml", "rfb_lite_mobilenetv2_train_voc.yml"]


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

# (id, flax block, port block from its input width, where it sits: the head
# whose extras hold it, or 'norm')
BLOCKS = [
    ("rfb_R", lambda: jrfb.BasicRFB(32, stride=1, visual=2),
     lambda cin: trfb.BasicRFB(cin, 32, stride=1, visual=2), "rfb"),
    ("rfb_S", lambda: jrfb.BasicRFB(32, stride=2, visual=1),
     lambda cin: trfb.BasicRFB(cin, 32, stride=2, visual=1), "rfb"),
    ("rfb_lite_R", lambda: jrfb.BasicRFB(32, stride=1, visual=2, lite=True),
     lambda cin: trfb.BasicRFB(cin, 32, stride=1, visual=2, lite=True), "rfb_lite"),
    ("rfb_lite_S", lambda: jrfb.BasicRFB(32, stride=2, visual=1, lite=True),
     lambda cin: trfb.BasicRFB(cin, 32, stride=2, visual=1, lite=True), "rfb_lite"),
    ("rfb_a", lambda: jrfb.BasicRFB_a(32), lambda cin: trfb.BasicRFB_a(cin, 32), "norm"),
    # ConvBNReLU takes a dilation as the JAX block does (named as a pyramid block)
    ("conv_bn_relu_dilated", lambda: jl.ConvBNReLU(32, kernel=3, padding=3, dilation=3),
     lambda cin: tl.ConvBNReLU(cin, 32, 3, padding=3, dilation=3), "pyramid"),
]


def _names(head):
    if head == "norm":
        return lambda v: block_state(v, "norm/", "norm.")
    if head == "pyramid":
        return lambda v: block_state(v, "pyramid_layers_0/", "pyramids.0.", ssds="fssd")
    return lambda v: block_state(v, "extra_layers_0/", "extras.0.", ssds=head,
                                 feature_layer=[[22, "R"], [512, 32]])


def _block_pair(case, seed):
    _, make_j, make_t, head = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (4, 9, 9, 16)).astype(np.float32)
    jblock = make_j()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    tblock = make_t(16)
    tblock.load_state_dict(_names(head)(variables), strict=True)
    return jblock, variables, tblock, x, rng


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_rfb_block_equals_flax(case, train):
    jblock, variables, tblock, x, rng = _block_pair(case, 7)
    if train:
        check_block_train(jblock, variables, tblock, x, _names(case[3]), rng, (RTOL, ATOL),
                          STATS_TOL)
    else:
        check_block_eval(jblock, variables, tblock, x, RTOL, ATOL)


def test_basic_rfb_a_kernels_paddings_and_widths():
    """BasicRFB_a's 1x3 / 3x1 kernels with per-axis padding, its dilations,
    its widths (inter = features // 4; branch 3 inter // 2, then
    (inter // 4) * 3) and its 512 outputs whatever the input's width."""
    block = trfb.BasicRFB_a(96)
    convs = {n[:-len(".conv")]: m for n, m in block.named_modules() if n.endswith(".conv")}
    assert block.out_channels == 512
    assert convs["branch1.1"].kernel_size == (3, 1) and convs["branch1.1"].padding == (1, 0)
    assert convs["branch2.1"].kernel_size == (1, 3) and convs["branch2.1"].padding == (0, 1)
    assert [convs[f"branch{b}.{j}"].dilation for b, j in ((0, 1), (1, 2), (2, 2), (3, 3))] == [
        (1, 1), (3, 3), (3, 3), (5, 5)]
    assert convs["branch3.3"].padding == (5, 5)
    assert [convs[f"branch3.{j}"].out_channels for j in range(4)] == [64, 96, 128, 128]
    assert convs["shortcut"].in_channels == 96 and convs["ConvLinear"].in_channels == 512


# --------------------------------------------------------------------------
# whole models, served
# --------------------------------------------------------------------------

# Float32: loc within atol 5e-5 (|loc| < 25) and the softmax within 1e-5
# (measured 2.2e-5 and 3.6e-6: sums in other orders). bf16: each no further
# from JAX's float32 forward than twice JAX's bf16 forward
# (``torch_port_heads.served_forward_against_jax``; measured, port against
# JAX: loc 0.153 / 0.180 and softmax 0.025 / 0.023 on VGG16, 0.254 / 0.282
# and 0.047 / 0.059 on MobileNetV1-0.25, whose random weights give logits
# near 20).
F32_TOL = (5e-5, 1e-5)


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("model", [VGG, MBV1], ids=["rfb_vgg16", "rfb_lite_mbv1_025"])
def test_rfb_detector_forward_equals_jax(model, half, tmp_path):
    """``ObjectDetector(device="cpu")`` on a ``.pth`` written by the bridge
    against the JAX model's eval forward."""
    jmodel, variables, _, _, tcfg = head_pair(*model, seed=21)
    image = int(tcfg.MODEL.IMAGE_SIZE[0])
    tcfg.MODEL.HALF_PRECISION = half
    pth = tmp_path / "rfb.pth"
    torch.save(bridge(variables, tcfg.MODEL), pth)
    tcfg.RESUME_CHECKPOINT = str(pth)
    det = ObjectDetector(tcfg, device="cpu")
    assert det.model.norm.branch3[1].conv.weight.dtype == (torch.bfloat16 if half
                                                           else torch.float32)
    x = np.random.default_rng(1).integers(0, 256, (2, image, image, 3), dtype=np.uint8)
    print(tcfg.MODEL.SSDS, half, served_forward_against_jax(jmodel, variables, det, x, half,
                                                            F32_TOL))
    assert det.detect_rows(x).shape == (2, 4, 100, 5)


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

# Train steps of RFB and RFBLite over MobileNetV1-0.25 at 96 px (batch 4,
# SGD 1e-3 with momentum and decay on every parameter, two steps), after each
# step: (the losses' relative error, the largest update error over the
# largest update, the largest running-statistic error over that statistic's
# largest value). float64, train mode: FLOAT64_LIMITS per step, those of
# tests/test_torch_port_fssd.py (the loss is float32 in both packages, and
# step 2 starts from weights its rounding has moved apart); measured step 1
# (2.2e-7, 6.8e-6, 5.5e-8), step 2 (2.4e-7, 2.8e-6, 2.3e-7) at most over RFB
# and RFBLite. float32 and bf16 on running statistics: STEP_LIMITS on (loss,
# update), as tests/test_torch_port_lite_train_frozen.py, two steps in
# float32 (measured 2.2e-7, 1.3e-6) and the first in bf16 (measured 2.8e-4,
# 1.4e-2): from there, on these random weights (the loss falls from 45 to
# 18 in one step), each package's bf16 step 2 lies 4e-3 (JAX) and 1e-2 (the
# port) of the loss from JAX's float32 step 2, so the two bf16 runs part by
# 1.4e-2. float32 and bf16 in train mode: the running statistics after one
# step, STATS_LIMITS (measured 4.5e-7 and 1.6e-4).
TRAIN_MODEL = ("mobilenet_v1_025", 96, [[5, "R", "S"], [64, 256, 128]], [[2], [2, 3], [2]])
FLOAT64_LIMITS = [(1e-6, 2e-5, 1e-6), (1e-6, 5e-4, 1e-5)]
STEP_LIMITS = {"float32": (1e-6, 1e-4), "bf16": (2e-3, 0.5)}
STATS_LIMITS = {"float32": 1e-4, "bf16": 5e-3}


@pytest.mark.parametrize("ssds", ["rfb", "rfb_lite"])
def test_rfb_train_steps_equal_jax_in_float64(ssds):
    pair = head_pair(ssds, *TRAIN_MODEL, seed=11)
    want, got = jax_steps(pair, "float64"), port_steps(pair, "float64")
    for step, (errs, limits) in enumerate(zip(errors(got, want), FLOAT64_LIMITS), 1):
        print(f"{ssds} step {step}: loss {errs[0]:.2e}, update {errs[1]:.2e}, "
              f"statistics {errs[2]:.2e}")
        assert all(e < lim for e, lim in zip(errs, limits)), (step, errs, limits)
    start, end = got[0][2], got[2][2]
    moved = {n for n in end if not torch.equal(end[n], start[n])}
    assert {"norm.branch3.1.conv.weight", "norm.shortcut.bn.running_var",
            "extras.0.ConvLinear.bn.bias", "extras.1.branch2.3.conv.weight"} <= moved


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_rfb_train_steps_equal_jax_on_running_statistics(dtype):
    pair = head_pair("rfb", *TRAIN_MODEL, seed=11)
    loss_limit, update_limit = STEP_LIMITS[dtype]
    steps = 2 if dtype == "float32" else 1
    want = jax_steps(pair, dtype, frozen=True, steps=steps)
    got = port_steps(pair, dtype, frozen=True, steps=steps)
    for step, (loss, upd, stat) in enumerate(errors(got, want), 1):
        print(f"{dtype} step {step}: loss {loss:.2e}, update {upd:.2e}")
        assert loss < loss_limit and upd < update_limit, (dtype, step, loss, upd)
        assert stat == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_rfb_train_step_statistics_equal_jax(dtype):
    pair = head_pair("rfb", *TRAIN_MODEL, seed=11)
    err = statistics_errors(port_steps(pair, dtype, steps=1), jax_steps(pair, dtype, steps=1))[0]
    print(f"{dtype}: running statistics, port against JAX, {err:.2e}")
    assert err < STATS_LIMITS[dtype]


# --------------------------------------------------------------------------
# configs, structure, layout, import, scopes
# --------------------------------------------------------------------------


def _yml(name):
    return os.path.join(REPO, "experiments/cfgs", name)


def test_rfb_vgg16_config_equals_its_yml():
    assert rfb_vgg16_config() == cfg_from_file(_yml("rfb_vgg16_train_voc.yml"))


@pytest.mark.parametrize("yml", YMLS)
def test_rfb_yml_builds_as_in_jax(yml):
    """Each experiment config at 300 px, built on ``meta``, against
    ``jax.eval_shape`` of the JAX init: feature maps, priors, and every
    parameter and running statistic by name (the bridge's) and shape."""
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    model, fmaps = create_model(tcfg.MODEL)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps]
    n_priors = create_priors(tcfg.MODEL, fmaps).shape[0]
    assert n_priors == (8732 if "vgg16" in yml else 2976)
    assert model.norm.out_channels == 512  # whatever the tap's width (96 on MobileNetV2)
    shapes = jax_shapes(jmodel, 300)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged, ours = bridge(zeros, tcfg.MODEL), model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name


def _full_size(yml):
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    return jbuilder.create_model(jcfg.MODEL)[0], tcfg


def test_rfb_layout_equals_reference_skeleton():
    """The port's state-dict keys, ``num_batches_tracked`` included, are the
    reference torch modules' (``tests/ref_torch_skeletons.py``): RFBNet-300's
    extras are ``extras.0-2`` BasicRFB blocks and ``extras.3-6`` convs."""
    jmodel, tcfg = _full_size("rfb_vgg16_train_voc.yml")
    ref = build_skeleton("rfb", jax_shapes(jmodel, 300), "vgg").state_dict()
    ours = create_model(tcfg.MODEL)[0].state_dict()
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        assert tuple(ref[name].shape) == tuple(t.shape), name
    assert {k.split(".")[1] for k in ours if k.startswith("extras.")} == set("0123456")
    assert "extras.2.shortcut.conv.weight" in ours and "extras.6.weight" in ours


def test_rfb_pth_round_trip_through_torch_import(tmp_path):
    """RFBNet300-VGG16's state dict (random BN buffers) -> ``.pth`` -> the JAX
    package's importer: every array placed, none relaxed, and the bridge
    maps them back to the same tensors, but for a fault of the importer.

    RFBNet-300's extras are three BasicRFB blocks (``extras.0-2``) and two
    plain pairs (``extras.3-6``). The importer tries ``extras.{i}`` at
    ``extra_layers_{n + (i - n) // 2}`` for n = 1, 2, 3 BasicRFB blocks
    before it, first hit wins (``ssds_tpu/torch_import.py:127-141``), and
    for the second pair n = 1 already hits the first pair, whose shapes are
    the same: ``extras.5-6`` overwrite ``extra_layers_3`` and
    ``extra_layers_4`` keeps its values. ROADMAP.md lists this among the
    reference's faults; the test pins it."""
    jmodel, tcfg = _full_size("rfb_vgg16_train_voc.yml")
    model = init_model(create_model(tcfg.MODEL)[0], seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    pth = tmp_path / "rfb.pth"
    torch.save(model.state_dict(), pth)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes(jmodel, 300))
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    ours = model.state_dict()
    assert stats["loaded"] == sum(not k.endswith("num_batches_tracked") for k in ours)
    again = bridge(back, tcfg.MODEL)
    assert sorted(again) == sorted(ours)
    misplaced = {"extras.3": "extras.5", "extras.4": "extras.6"}
    for name, t in ours.items():
        module = name.rpartition(".")[0]
        if name.endswith("num_batches_tracked"):
            continue
        if module in misplaced:  # holds the second pair's tensors
            assert torch.equal(again[name], ours[name.replace(module, misplaced[module])]), name
        elif module in misplaced.values():  # kept the zeros it was given
            assert not again[name].any(), name
        else:
            assert torch.equal(again[name], t), name


@pytest.mark.parametrize("scope", config_scopes())
def test_rfb_scope_equals_jax(scope):
    """Every RFBNet300-VGG16 parameter, under every config's scope words:
    the port selects what the JAX package selects."""
    jmodel, tcfg = _full_size("rfb_vgg16_train_voc.yml")
    model = create_model(tcfg.MODEL)[0]
    aliases = getattr(model, "SCOPE_ALIASES", None)
    for path in traverse_util.flatten_dict(jax_shapes(jmodel, 300)["params"]):
        name = port_name("/".join(path), tcfg.MODEL.NETS, "rfb", tcfg.MODEL.FEATURE_LAYER)
        assert ckpt.path_in_scope(name, scope, aliases) == jax_ckpt.path_in_scope(path, scope), \
            (scope, path, name)
