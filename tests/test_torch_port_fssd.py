"""The FSSD heads (``fssd``, ``fssd_lite``) in the port against the JAX package.

Blocks and models get the same random variables on both sides
(``tests/torch_port_heads.py``). Covered: ``resize_bilinear`` against
``jax.image.resize``; each pyramid block and the fusion (transforms, resize,
concat, BN) with one pyramid block, in eval and train mode (outputs,
gradients, running statistics); the whole models through ``ObjectDetector``
in float32 and bf16, where the pyramid and the predictors stay float32 as in
JAX; two train steps against ``ssds_tpu.solver.build_train_step``; the
experiment configs' structure, the reference torch layout and the ``.pth``
round trip through ``ssds_tpu.torch_import``; the scope words.

Tolerances, with what was measured:

- resize: bf16 bit-identical on these shapes (the port contracts the axes
  in ``jnp.einsum``'s order and rounds as it does); float32 within atol
  1e-6 on values of |x| < 8 (measured 4.8e-7: one or two ulps, the sums
  formed in another order);
- blocks, float32: outputs within rtol 1e-5 / atol 1e-5 and running
  statistics within rtol 1e-6 / atol 1e-7, as
  ``tests/test_torch_port_bn_layers.py`` states for the same BatchNorm
  arithmetic; each gradient within 1e-5 of its largest element (measured
  6.7e-7 at most on the pyramid blocks). The fusion's train-mode outputs
  pass two batch-statistics BatchNorms in series (768 and 32 wide), where
  flax forms the variance as E[x^2] - E[x]^2: atol 3e-5 (measured 1.5e-5 on
  values ~1); its gradients within 3e-5 (measured 8.1e-6, the fusion BN's
  bias, against a tenth of the largest gradient: the pyramid's train-mode
  BN takes a per-channel shift back out but at the zero-padded border, so
  that gradient is a small sum of cancelling terms; 5.4e-6 elsewhere, the
  stem weight's, which sums ~1e3-sized terms); the pyramid BN's running statistics,
  taken over those outputs, within rtol 2e-5 / atol 2e-6 (measured 1.1e-5
  relative on a variance, 8.3e-7 on a mean);
- models through the detector: see :data:`DETECTOR_TOL`;
- train steps: see :data:`STEP_LIMITS`.
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
from ssds_tpu.models.heads import common as jcommon
from ssds_tpu.models.heads import fssd as jfssd
from ssds_tpu.torch_import import import_torch_checkpoint
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import cfg_from_file, fssd_vgg16_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.models import layers as tl
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
from ssds_tpu_torch.models.heads import common as tcommon
from ssds_tpu_torch.models.heads import fssd as tfssd
from ssds_tpu_torch.weights import port_name
from test_torch_port_bn_layers import _random_variables
from test_torch_port_checkpoint import config_scopes
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from torch_port_heads import (block_state, bridge, check_block_eval, check_block_train,
                              head_pair, jax_shapes, jax_steps, port_steps,
                              served_forward_against_jax)
from test_torch_port_lite_train import errors
from test_torch_port_lite_train_lowp import statistics_errors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
STATS_TOL = (1e-6, 1e-7)

# (ssds, net, image, FEATURE_LAYER, ASPECT_RATIOS): tests/test_models.py's
# narrow VGG16 FSSD at 96 px (maps 12/6/4) and tests/test_heads_overfit.py's
# MobileNetV1-0.25 FSSD at 96 px (maps 12/6/3)
VGG = ("fssd", "vgg16", 96, [[[22, 34, "S"], [512, 1024, 256]], [["", "S", "0"], [128, 128, 128]]],
       [[2], [2, 3], [2]])
MBV1 = ("fssd_lite", "mobilenet_v1_025", 96,
        [[[5, 11, 13], [64, 128, 256]], [["", "S", "S"], [128, 128, 128]]], [[2], [2, 3], [2]])
YMLS = ["fssd_vgg16_train_voc.yml", "fssd_vgg16_train_coco.yml",
        "fssd_lite_mobilenetv1_train_voc.yml", "fssd_lite_mobilenetv2_train_voc.yml"]


# --------------------------------------------------------------------------
# resize_bilinear (trouble spot: jax.image.resize's half-pixel centres,
# renormalised edges and antialiasing when it shrinks)
# --------------------------------------------------------------------------

# (h, w) -> (H, W): FSSD's upsamplings at 300 px (VGG16 and both MobileNets:
# 19 -> 38, 10 -> 38), the 96 px test models' (6 -> 12, 3 -> 12), a
# non-square one that contracts columns first, and shrinks
RESIZES = [((19, 19), (38, 38)), ((10, 10), (38, 38)), ((6, 6), (12, 12)), ((3, 3), (12, 12)),
           ((19, 20), (38, 40)), ((5, 7), (9, 11)), ((38, 38), (19, 19)), ((38, 38), (10, 10)),
           ((10, 7), (7, 3))]


@pytest.mark.parametrize("n_in,n_out", [(19, 38), (10, 38), (3, 12), (38, 19), (38, 10), (7, 3)])
def test_resize_weights_equal_jax(n_in, n_out):
    """The weight matrix is jax.image.resize of the identity along one axis:
    bit for bit when upsampling; when shrinking, XLA compiles the kernel's
    float32 arithmetic into other roundings, and the weights (<= 0.5) agree
    within 6e-8, two ulps (measured one)."""
    want = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in),
                                       "bilinear")).T
    got = tl._resize_weights(n_in, n_out)
    if n_out >= n_in:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                                                  for a, b in RESIZES])
def test_resize_bilinear_equals_jax_image_resize(src, dst, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[
        dtype]
    x = np.random.default_rng(sum(src + dst)).normal(0, 1.5, (2, *src, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x, jdt), (2, *dst, 5), "bilinear"),
                      np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    got = tl.resize_bilinear(xt, dst)
    assert got.dtype == tdt and tuple(got.shape[2:]) == dst
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if dst[0] >= src[0] and dst[1] >= src[1]:  # upsampling: F.interpolate's semantics
        plain = torch.nn.functional.interpolate(xt.float(), size=dst, mode="bilinear",
                                                align_corners=False)
        np.testing.assert_allclose(tl.resize_bilinear(xt.float(), dst).numpy(), plain.numpy(),
                                   rtol=0, atol=5e-6)


def test_resize_bilinear_keeps_bf16_under_autocast():
    x = torch.randn(1, 3, 5, 5, dtype=torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert tl.resize_bilinear(x, (10, 10)).dtype == torch.bfloat16
        assert tl.resize_bilinear(x.float(), (10, 10)).dtype == torch.float32


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

PYRAMID_CASES = [(kind, lite) for lite in (False, True) for kind in ("", "S", "0")]


def _pyramid_pair(kind, lite, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (4, 7, 7, 8)).astype(np.float32)
    jblock = jfssd.pyramid_spec(kind, 16, lite)()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    tblock = tfssd.pyramid_spec(kind, 16, lite)(8)
    tblock.load_state_dict(_pyramid_names(variables), strict=True)
    return jblock, variables, tblock, x, rng


def _pyramid_names(variables):
    return block_state(variables, "pyramid_layers_0/", "pyramids.0.", ssds="fssd")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind,lite", PYRAMID_CASES,
                         ids=[f"{k or 'keep'}{'_lite' if l else ''}" for k, l in PYRAMID_CASES])
def test_pyramid_block_equals_flax(kind, lite, train):
    jblock, variables, tblock, x, rng = _pyramid_pair(kind, lite, 3)
    if train:
        check_block_train(jblock, variables, tblock, x, _pyramid_names, rng, (RTOL, ATOL),
                          STATS_TOL)
    else:
        check_block_eval(jblock, variables, tblock, x, RTOL, ATOL)


def _fusion_pair(lite, seed):
    """A small FSSD on both sides: a two-conv base (stride 2 each) tapped at
    both convs, one 'S' fusion extra, and one pyramid block; its feature
    phase is the fusion (three transforms, two resizes to 8x8, the 768-wide
    BN) and the block. The JAX model's feature phase makes no predictors."""
    jbase = tuple(lambda ch=ch: jl.Conv(ch, kernel=3, stride=2, padding=1, relu=True)
                  for ch in (8, 16))
    tbase = [lambda cin, ch=ch: tl.Conv(cin, ch, 3, stride=2, padding=1, relu=True)
             for ch in (8, 16)]
    jmodel = jfssd.FSSD(base=jbase, fusion_extras=(jcommon.conv_extra_spec("S", 16),),
                        pyramid=(jfssd.pyramid_spec("", 32, lite),), taps=(0, 1),
                        num_anchors=(4,), num_classes=3, lite=lite)
    tmodel = tfssd.FSSD(base=tbase, fusion_extras=[tcommon.conv_extra_spec("S", 16)],
                        pyramid=[tfssd.pyramid_spec("", 32, lite)], taps=[0, 1],
                        num_anchors=[4], num_classes=3, lite=lite)
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (4, 16, 16, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                phase="feature"))
    variables = _random_variables(shapes, rng)
    sd, bridged = tmodel.state_dict(), _fusion_names(variables)
    assert sorted(bridged) == sorted(k for k in sd if not k.startswith(("loc.", "conf.")))
    tmodel.load_state_dict({**sd, **bridged}, strict=True)  # the predictors are not run
    return jmodel, variables, tmodel, x, rng


def _fusion_names(variables):
    return block_state(variables, "", "", ssds="fssd")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("lite", [False, True], ids=["fssd", "fssd_lite"])
def test_fusion_and_pyramid_block_equal_flax(lite, train):
    jmodel, variables, tmodel, x, rng = _fusion_pair(lite, 5)
    if train:
        check_block_train(jmodel, variables, tmodel, x, _fusion_names, rng, (RTOL, 3e-5),
                          (2e-5, 2e-6), grad_tol=3e-5, phase="feature")
    else:
        check_block_eval(jmodel, variables, tmodel, x, RTOL, ATOL, phase="feature")


# --------------------------------------------------------------------------
# whole models, served
# --------------------------------------------------------------------------

# Float32: loc within atol 2e-5 and the softmax within 1e-5 (measured 6.3e-6
# and 1.8e-6 on VGG16, |loc| < 5.3: sums in other orders through 15 convs),
# pyramid sources within 1e-4 of their largest value (measured 3.2e-6).
# bf16: each no further from JAX's float32 forward than twice JAX's bf16
# forward (``torch_port_heads.served_forward_against_jax``; measured, port
# against JAX: loc 0.044 / 0.049 and softmax 0.015 / 0.018 on VGG16, 0.016 /
# 0.011 and 0.0044 / 0.0030 on MobileNetV1-0.25); the pyramid sources,
# float32 on both sides, within 5e-2 of their largest value of JAX's bf16
# forward's (measured 2.2e-2). These cannot tell a float32 pyramid from a
# bf16 one (that adds ~1e-3);
# test_fssd_bf16_serving_computes_after_the_fusion_bn_in_float32 does.
F32_TOL, SOURCE_TOL = (2e-5, 1e-5), {False: 1e-4, True: 5e-2}


def _served(model, half, tmp_path):
    """The JAX model with its variables, and the port's ObjectDetector on a
    ``.pth`` written by the bridge."""
    jmodel, variables, _, _, tcfg = head_pair(*model, seed=21)
    tcfg.MODEL.HALF_PRECISION = half
    pth = tmp_path / "fssd.pth"
    torch.save(bridge(variables, tcfg.MODEL), pth)
    tcfg.RESUME_CHECKPOINT = str(pth)
    return jmodel, variables, ObjectDetector(tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("model", [VGG, MBV1], ids=["fssd_vgg16", "fssd_lite_mbv1_025"])
def test_fssd_detector_forward_equals_jax(model, half, tmp_path):
    """``ObjectDetector(device="cpu")`` against the JAX model's eval forward,
    and the pyramid sources (``phase="feature"``), float32 on both sides
    under bf16."""
    jmodel, variables, det, tcfg = _served(model, half, tmp_path)
    image = int(tcfg.MODEL.IMAGE_SIZE[0])
    dtype = torch.bfloat16 if half else torch.float32
    assert next(det.model.base.parameters()).dtype == det.model.transforms[0].weight.dtype == dtype
    for name in tfssd.FSSD.FLOAT32_MODULES:
        assert all(p.dtype == torch.float32 for p in det.model.get_submodule(name).parameters())
    x = np.random.default_rng(1).integers(0, 256, (2, image, image, 3), dtype=np.uint8)
    print(tcfg.MODEL.SSDS, half, served_forward_against_jax(jmodel, variables, det, x, half,
                                                            F32_TOL))

    means = np.asarray(tcfg.DATASET.PIXEL_MEANS, np.float32)
    want_src = jax.jit(lambda v, img: jmodel.apply(
        v, (img.astype(np.float32) - means).astype(jnp.bfloat16 if half else jnp.float32),
        phase="feature", train=False))(variables, x)
    xt = (torch.from_numpy(x).float() - det.means).permute(0, 3, 1, 2).to(dtype)
    with torch.no_grad():
        got_src = det.model(xt, phase="feature")
    for g, w in zip(got_src, want_src):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        w = np.asarray(w)
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max() / np.abs(w).max()
        print(f"  pyramid source {tuple(g.shape)}: max|d| / max|x| {err:.2e}")
        assert err < SOURCE_TOL[half]
    assert det.detect_rows(x).shape == (2, 4, 100, 5)


def _jax_after_fusion(m, fused):
    """The JAX FSSD from its fusion BN's input on (serving: running
    statistics): the pyramid sources and the eval-phase ``(loc, conf)``."""
    y = m.fusion_bn(fused, use_running_average=True)
    sources = []
    for layer in m.pyramid_layers:
        y = layer(y, False)
        sources.append(y)
    return sources, jcommon.finalize("eval", *m.head(sources, False))


@pytest.mark.parametrize("model", [VGG, MBV1], ids=["fssd_vgg16", "fssd_lite_mbv1_025"])
def test_fssd_bf16_serving_computes_after_the_fusion_bn_in_float32(model, tmp_path):
    """The trouble spot of FSSD in bf16: the JAX package's fusion BN has no
    ``dtype``, so its output and everything after it are float32. The same
    bf16 fused map goes into the JAX model's fusion BN, pyramid and head and
    into the bf16 detector's: the sources and ``(loc, conf)`` agree to
    float32 precision (rtol 1e-5 of the largest value; measured ~1e-6),
    while rounding the fusion BN's output to bf16 alone, as a bf16 pyramid
    would take it, moves the sources by more than 30 times that."""
    jmodel, variables, det, _ = _served(model, True, tmp_path)
    c = det.model.norm.num_features
    fused = np.random.default_rng(2).normal(0.3, 1.0, (2, 12, 12, c)).astype(np.float32)
    fused_bf16 = torch.from_numpy(fused).bfloat16()
    want_src, (want_loc, want_conf) = jmodel.apply(
        variables, jnp.asarray(fused, jnp.bfloat16), method=_jax_after_fusion)
    m = det.model
    with torch.no_grad():
        y = m.norm(fused_bf16.permute(0, 3, 1, 2))
        got_src = m.run_pyramid(y)
        got_loc, got_conf = tcommon.finalize("eval", *tcommon.multibox(
            got_src, m.loc, m.conf, m.num_classes))
        rounded_src = m.run_pyramid(y.bfloat16().float())
    assert y.dtype == torch.float32 and want_src[0].dtype == jnp.float32
    for g, r, w in zip(got_src, rounded_src, want_src):
        w = np.asarray(w)
        scale = np.abs(w).max()
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max() / scale
        moved = np.abs(r.permute(0, 2, 3, 1).numpy() - w).max() / scale
        print(f"source {tuple(g.shape)}: float32 {err:.2e}, from a bf16 input {moved:.2e}")
        assert g.dtype == torch.float32 and err < 1e-5 and moved > 30 * 1e-5
    for g, w in ((got_loc, want_loc), (got_conf, want_conf)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_fssd_runs_after_the_fusion_bn_in_float32_under_autocast():
    """Training's autocast (bf16 on the CPU here): the backbone's sources are
    bf16, the pyramid sources and the raw ``(loc, conf)`` float32."""
    _, _, tmodel, _, tcfg = head_pair(*MBV1, seed=3)
    x = torch.randn(2, 3, 96, 96) * 50
    tmodel.train()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        sources = tmodel(x, phase="feature")
        loc, conf = tmodel(x, phase="train")
        tap = tcommon.run_layers(tmodel.base, [5], x)[0][0]
    assert tap.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in sources)
    assert loc.dtype == conf.dtype == torch.float32


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

# Train steps of FSSD and FSSDLite over MobileNetV1-0.25 at 96 px (batch 4,
# SGD 1e-3 with momentum and decay on every parameter, two steps), after each
# step: (the losses' relative error, the largest update error over the
# largest update, the largest running-statistic error over that statistic's
# largest value).
# float64, train mode (batch statistics): both packages run the model in
# float64 and the loss in float32, as written. Step 1 within (1e-6, 2e-5,
# 1e-6), as tests/test_torch_port_lite_train.py holds SSDLite (measured
# 6.4e-8, 4.7e-7, 5.5e-8 for FSSD; 1.7e-7, 1.9e-7, 5.3e-8 for FSSDLite).
# Step 2 starts from weights that the float32 loss's rounding has put ~1e-7
# apart, and FSSDLite's 34 train-mode BatchNorms amplify that: (1e-6, 5e-4,
# 1e-5) (measured 5.4e-7, 8.8e-5, 2.2e-6; FSSD 1.9e-7, 4.8e-7, 1.7e-7).
# float32 and bf16 on running statistics (every BatchNorm in eval mode, where
# the backward is well-conditioned; tests/test_torch_port_lite_train_frozen.py):
# STEP_LIMITS on (loss, update), two steps in float32 (measured 2.0e-7,
# 4.4e-6), the first in bf16 (measured 8.9e-5, 1.8e-2). A second bf16 step
# starts from weights ~1 % of an update apart, and on these random weights
# each package's own bf16 step lies up to 1e-2 of the loss from its float32
# one by the second or third step (tests/test_torch_port_rfb.py's RFB).
TRAIN_MODEL = ("mobilenet_v1_025", 96, [[[5, 11, 13], [64, 128, 256]],
                                        [["", "S", "S"], [128, 128, 128]]], [[2], [2, 3], [2]])
FLOAT64_LIMITS = [(1e-6, 2e-5, 1e-6), (1e-6, 5e-4, 1e-5)]
STEP_LIMITS = {"float32": (1e-6, 1e-4), "bf16": (2e-3, 0.5)}
STATS_LIMITS = {"float32": 1e-4, "bf16": 5e-3}


@pytest.mark.parametrize("ssds", ["fssd", "fssd_lite"])
def test_fssd_train_steps_equal_jax_in_float64(ssds):
    pair = head_pair(ssds, *TRAIN_MODEL, seed=11)
    want, got = jax_steps(pair, "float64"), port_steps(pair, "float64")
    for step, (errs, limits) in enumerate(zip(errors(got, want), FLOAT64_LIMITS), 1):
        print(f"{ssds} step {step}: loss {errs[0]:.2e}, update {errs[1]:.2e}, "
              f"statistics {errs[2]:.2e}")
        assert all(e < lim for e, lim in zip(errs, limits)), (step, errs, limits)
    start, end = got[0][2], got[2][2]
    moved = {n for n in end if not torch.equal(end[n], start[n])}
    assert {"norm.weight", "norm.running_var", "transforms.2.weight", "pyramids.1.1.bias",
            "base.0.0.weight"} <= moved


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_fssd_train_steps_equal_jax_on_running_statistics(dtype):
    pair = head_pair("fssd", *TRAIN_MODEL, seed=11)
    loss_limit, update_limit = STEP_LIMITS[dtype]
    steps = 2 if dtype == "float32" else 1
    want = jax_steps(pair, dtype, frozen=True, steps=steps)
    got = port_steps(pair, dtype, frozen=True, steps=steps)
    for step, (loss, upd, stat) in enumerate(errors(got, want), 1):
        print(f"{dtype} step {step}: loss {loss:.2e}, update {upd:.2e}")
        assert loss < loss_limit and upd < update_limit, (dtype, step, loss, upd)
        assert stat == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_fssd_train_step_statistics_equal_jax(dtype):
    """Train mode in float32 and bf16 (the card's bf16 autocast; the pyramid
    and head in float32 in both packages): the running statistics after one
    step against the JAX package's step of the same type, as their largest
    error over their largest movement, within the limits
    tests/test_torch_port_lite_train_lowp.py sets for SSDLite: 1e-4 in
    float32 (measured 2.5e-7) and 5e-3 in bf16 (measured 5.1e-5)."""
    pair = head_pair("fssd", *TRAIN_MODEL, seed=11)
    err = statistics_errors(port_steps(pair, dtype, steps=1), jax_steps(pair, dtype, steps=1))[0]
    print(f"{dtype}: running statistics, port against JAX, {err:.2e}")
    assert err < STATS_LIMITS[dtype]


# --------------------------------------------------------------------------
# configs, structure, layout, import, scopes
# --------------------------------------------------------------------------


def _yml(name):
    return os.path.join(REPO, "experiments/cfgs", name)


def test_fssd_vgg16_config_equals_its_yml():
    assert fssd_vgg16_config() == cfg_from_file(_yml("fssd_vgg16_train_voc.yml"))


@pytest.mark.parametrize("yml", YMLS)
def test_fssd_yml_builds_as_in_jax(yml):
    """Each experiment config at 300 px, built on ``meta``, against
    ``jax.eval_shape`` of the JAX init: feature maps, priors, and every
    parameter and running statistic by name (the bridge's) and shape."""
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    model, fmaps = create_model(tcfg.MODEL)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps]
    n_priors = create_priors(tcfg.MODEL, fmaps).shape[0]
    assert n_priors == (8732 if "vgg16" in yml else 8744)
    shapes = jax_shapes(jmodel, 300)
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    bridged, ours = bridge(zeros, tcfg.MODEL), model.state_dict()
    assert sorted(bridged) == sorted(ours)
    for name, t in ours.items():
        assert tuple(bridged[name].shape) == tuple(t.shape), name


def _full_size(yml):
    jcfg, tcfg = jax_cfg_from_file(_yml(yml)), cfg_from_file(_yml(yml))
    return jbuilder.create_model(jcfg.MODEL)[0], tcfg


def test_fssd_layout_equals_reference_skeleton():
    """The port's state-dict keys, ``num_batches_tracked`` included, are the
    reference torch modules' (``tests/ref_torch_skeletons.py``)."""
    jmodel, tcfg = _full_size("fssd_vgg16_train_voc.yml")
    ref = build_skeleton("fssd", jax_shapes(jmodel, 300), "vgg").state_dict()
    ours = create_model(tcfg.MODEL)[0].state_dict()
    assert sorted(ours) == sorted(ref)
    for name, t in ours.items():
        assert tuple(ref[name].shape) == tuple(t.shape), name


def test_fssd_pth_round_trip_through_torch_import(tmp_path):
    """FSSD300-VGG16's state dict (random BN buffers) -> ``.pth`` -> the JAX
    package's importer: every array placed by its primary rule, none
    relaxed, and the bridge maps them back to the same tensors."""
    jmodel, tcfg = _full_size("fssd_vgg16_train_voc.yml")
    model = init_model(create_model(tcfg.MODEL)[0], seed=5)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        model.norm.running_mean.copy_(torch.randn(model.norm.running_mean.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    pth = tmp_path / "fssd.pth"
    torch.save(model.state_dict(), pth)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), jax_shapes(jmodel, 300))
    back, stats = import_torch_checkpoint(zeros, str(pth), verbose=False, return_stats=True)
    assert stats["missed"] == [] and stats["relaxed"] == []
    ours = model.state_dict()
    assert stats["loaded"] == sum(not k.endswith("num_batches_tracked") for k in ours)
    again = bridge(back, tcfg.MODEL)
    assert sorted(again) == sorted(ours)
    for name, t in ours.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(again[name], t), name


@pytest.mark.parametrize("scope", config_scopes())
def test_fssd_scope_equals_jax_but_for_the_fusion_bn_under_norm(scope):
    """Every FSSD300-VGG16 parameter, TRAINABLE_SCOPE / RESUME_SCOPE words of
    every config: the port (``FSSD.SCOPE_ALIASES``) selects what the JAX
    package selects, with one difference. JAX maps the word ``norm`` to a
    flax ``norm`` module, which FSSD lacks, so ``norm`` leaves its fusion BN
    out; the port's fusion BN is the reference's ``norm`` and the word
    selects it (the reference trains it under ``norm``). The word ``fusion``
    selects it in both."""
    jmodel, tcfg = _full_size("fssd_vgg16_train_voc.yml")
    words = {w.strip() for w in scope.split(",")}
    for path in traverse_util.flatten_dict(jax_shapes(jmodel, 300)["params"]):
        name = port_name("/".join(path), tcfg.MODEL.NETS, "fssd", tcfg.MODEL.FEATURE_LAYER)
        got = ckpt.path_in_scope(name, scope, tfssd.FSSD.SCOPE_ALIASES)
        want = jax_ckpt.path_in_scope(path, scope)
        if path[0] == "fusion_bn" and "norm" in words and "fusion" not in words:
            assert got and not want, (scope, path)
        else:
            assert got == want, (scope, path, name)


def test_default_scope_trains_the_fusion_bn_in_the_port_and_freezes_it_in_jax():
    """The default TRAINABLE_SCOPE (no ``fusion``): the JAX package freezes
    the fusion BN, the port trains it; the FSSD yml's scope (with ``fusion``)
    trains it in both. ROADMAP.md lists the difference among the reference's
    faults."""
    from ssds_tpu.config import default_config as jax_default_config
    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.solver import trainable_mask

    scope = default_config().TRAIN.TRAINABLE_SCOPE
    assert scope == jax_default_config().TRAIN.TRAINABLE_SCOPE and "fusion" not in scope
    names = ["norm.weight", "norm.bias", "transforms.0.weight", "pyramids.0.1.weight"]
    mask = trainable_mask(names, scope, tfssd.FSSD.SCOPE_ALIASES)
    assert all(v == "train" for v in mask.values())
    assert not jax_ckpt.path_in_scope(("fusion_bn", "scale"), scope)
    assert jax_ckpt.path_in_scope(("transforms_0", "Conv_0", "kernel"), scope)
    yml_scope = fssd_vgg16_config().TRAIN.TRAINABLE_SCOPE
    assert jax_ckpt.path_in_scope(("fusion_bn", "scale"), yml_scope)
    assert trainable_mask(["norm.weight"], yml_scope, tfssd.FSSD.SCOPE_ALIASES) == {
        "norm.weight": "train"}
    assert trainable_mask(["norm.weight", "loc.0.weight"], "fusion",
                          tfssd.FSSD.SCOPE_ALIASES)["loc.0.weight"] == "freeze"
