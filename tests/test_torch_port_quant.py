"""int8 post-training quantisation in the port (``ssds_tpu_torch/quant.py``,
``ops/quant.py``, ``ops/cuda/int8_conv.py``) against the JAX package's
(``ssds_tpu/quant.py``, ``ObjectDetector.quantize_int8``).

Bit-equal to JAX's (no tolerance): ``quantize_act`` (float32 and bf16
inputs, ties at .5), the int8 weights and their per-channel scales, the
activation scale, the int32 accumulators of the ``s8 x s8 -> s32`` conv over
kernel sizes 1 / 3 / 7, strides 1 / 2, dilations 1 / 6 and paddings, and the
float32 dequant. The set of quantised convs equals JAX's, through the
bridge's names, for SSD-VGG16, SSDLite-MobileNetV2, FSSD, RFB, YOLOv3 and
SSD-ResNet, with and without ``skip_re="loc|conf"``. Calibration maxima: the
first conv's (whose input is the same array) bit-equal, the others within
rtol 1e-5, since the two frameworks' float32 forwards round differently.
The whole int8 network from JAX's quantised variables, through the bridge,
gives JAX's outputs within 1e-2 of their largest magnitude (the same
float32 rounding differences can move a value across a rounding boundary of
the next ``quantize_act``; measured below).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu import quant as jq
from ssds_tpu_torch import quant as tq
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.export import export_detector, load_exported
from ssds_tpu_torch.ops import quant as oq
from ssds_tpu_torch.ops.cuda import int8_conv as ci
from ssds_tpu_torch.weights import port_name, quant_state_from_jax
from test_torch_port_export import MODELS as EXPORT_MODELS
from test_torch_port_export import _unpruned
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_yolo_models import DARKNET_V3, _tame
from torch_port_heads import head_pair


def _nhwc_of(q_nhwc_padded, c):
    return q_nhwc_padded[..., :c].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    scale = np.float32(0.5)
    x = rng.normal(0, 30, (2, 7, 5, 3)).astype(np.float32)  # NHWC, past +-127 * scale too
    x[0, 0, :, 0] = [0.25, 0.75, 1.25, -0.25, -0.75]  # ties: x / scale = +-0.5, 1.5, 2.5
    x[0, 1, :, 0] = [63.25, 63.75, 200.0, -200.0, 0.0]
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jq.quantize_act(xj, jnp.float32(scale)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = ci.quantize_act(xt, torch.tensor(scale))
    assert got.dtype == torch.int8 and got.shape == (2, 7, 5, 4)
    np.testing.assert_array_equal(_nhwc_of(got, 3), want)
    assert not got[..., 3].any()  # the padding channel
    np.testing.assert_array_equal(want[0, 0, :, 0], [0, 2, 2, 0, -2])


def test_weight_and_activation_scales_bit_equal_to_jax():
    """``quantize_variables`` on one conv: the int8 kernel, ``w_scale``
    (a zero channel floored at 1e-12) and ``act_scale``."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.05, (3, 3, 6, 5)).astype(np.float32)  # HWIO
    w[..., 2] = 0.0
    w[0, 0, 0, 1] = 0.5 * w[..., 1].max() / 0.5  # some values near .5 steps
    amax = 3.7123456
    variables = {"params": {"m": {"Conv_0": {"kernel": jnp.asarray(w)}}}}
    q = jq.quantize_variables(variables, {("m", "act_absmax"): amax})
    wq, w_scale = oq.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(q["params"]["m"]["Conv_0"]["kernel"])
                                  .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(w_scale.numpy(), np.asarray(q["quant"]["m"]["w_scale"]))
    assert oq.act_scale_of(amax) == np.asarray(q["quant"]["m"]["act_scale"])
    assert oq.act_scale_of(0.0) == np.float32(1e-8 / 127.0)


# (Cin, Cout, kernel, stride, padding, dilation, H, W)
CONVS = [(3, 8, 3, 1, 1, 1, 9, 11), (5, 7, 1, 1, 0, 1, 6, 5), (16, 9, 3, 2, 1, 1, 10, 9),
         (12, 6, 7, 2, 3, 1, 15, 13), (8, 10, 3, 1, 6, 6, 19, 19), (4, 3, 1, 2, 0, 1, 7, 8),
         (9, 4, 3, 1, 0, 1, 5, 6), (6, 5, 7, 1, 2, 1, 9, 9)]


@pytest.mark.parametrize("cin,cout,k,s,p,d,h,w", CONVS)
def test_int8_conv_accumulators_and_dequant_bit_equal_to_jax(cin, cout, k, s, p, d, h, w):
    rng = np.random.default_rng(cin * 100 + k)
    xq = rng.integers(-127, 128, (2, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jq.int8_conv(jnp.asarray(xq), jnp.asarray(wq), stride=(s, s),
                                   padding=((p, p), (p, p)), dilation=(d, d)))
    xt = torch.from_numpy(np.pad(xq, ((0, 0), (0, 0), (0, 0), (0, oq.padded_channels(cin) - cin))))
    wt = oq.pack_weight(torch.from_numpy(wq.transpose(3, 2, 0, 1)))
    act = torch.tensor(np.float32(0.0371))
    w_scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32))
    acc = ci.int8_conv(xt, wt, act, w_scale, None, (s, s), (p, p), (d, d), False, torch.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want)
    bias = rng.normal(0, 1, cout).astype(np.float32)
    for out_dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for b in (None, bias):
            y = ci.int8_conv(xt, wt, act, w_scale, None if b is None else torch.from_numpy(b),
                             (s, s), (p, p), (d, d), False, out_dtype)
            yj = jq.dequant(jnp.asarray(want), jnp.float32(act.item()), jnp.asarray(w_scale),
                            None if b is None else jnp.asarray(b), jdt)
            np.testing.assert_array_equal(y.permute(0, 2, 3, 1).float().numpy(),
                                          np.asarray(yj).astype(np.float32))
    relu = ci.int8_conv(xt, wt, act, w_scale, torch.from_numpy(bias), (s, s), (p, p), (d, d),
                        True, torch.bfloat16)
    yj = jax.nn.relu(jq.dequant(jnp.asarray(want), jnp.float32(act.item()), jnp.asarray(w_scale),
                                jnp.asarray(bias), jnp.bfloat16))
    np.testing.assert_array_equal(relu.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(yj).astype(np.float32))


def test_operators_opcheck_and_fakes():
    x = torch.randn(2, 5, 6, 7)
    act = torch.tensor(np.float32(0.02))
    torch.library.opcheck(torch.ops.ssds_tpu_torch.quantize_act.default, (x, act))
    xq = ci.quantize_act(x, act)
    wq = oq.pack_weight(torch.randint(-127, 128, (3, 5, 3, 3), dtype=torch.int8))
    args = (xq, wq, act, torch.rand(3) * 1e-2, torch.randn(3), [2, 1], [1, 1], [1, 1], True,
            torch.float32)
    torch.library.opcheck(torch.ops.ssds_tpu_torch.int8_conv.default, args)
    got = torch.ops.ssds_tpu_torch.int8_conv(*args)
    assert got.shape == (2, 3, 3, 7) and torch.equal(got, ci.int8_conv(*args))


# -- which convs: calibration and the quantised set, family by family ------

FAMILIES = {
    "ssd_vgg16": (("ssd", "vgg16", 64, [[22, 34, "S"], [512, 1024, 512]], [[2], [2, 3], [2]]),
                  {}),
    "ssd_lite_mobilenet_v2": (("ssd_lite", "mobilenet_v2_025", 96,
                               [[7, 14, "S"], [96, 320, 128]], [[2], [2, 3], [2]]), {}),
    "fssd_vgg16": (("fssd", "vgg16", 96, [[[22, 34, "S"], [512, 1024, 256]],
                                          [["", "S", "0"], [128, 128, 128]]],
                    [[2], [2, 3], [2]]), {}),
    "rfb_vgg16": (("rfb", "vgg16", 96, [[22, "R", "S", ""], [512, 1024, 512, 256]],
                   [[2], [2, 3], [2], [2]]), {}),
    "yolo_v3_darknet53": (DARKNET_V3, {"tame": _tame}),
    "ssd_resnet18": (("ssd", "resnet_18", 96, [[4, 8, "S"], [128, 512, 256]],
                      [[2], [2, 3], [2]]), {}),
}
_CALIBRATED = {}


def _jax_names(keys, cfg):
    """The port's conv names of JAX calibration (or ``quant``) keys."""
    names = {}
    for key in keys:
        module, leaf = "/".join(key[:-1]), key[-1]
        prefix = f"{module}/" if module else ""
        if leaf.startswith("act_absmax_src"):
            k = leaf[len("act_absmax_src"):]
            convs = [f"{prefix}loc{k}/Conv_0", f"{prefix}conf{k}/Conv_0"]
        else:
            convs = [f"{prefix}Conv_0"]
        for conv in convs:
            name = port_name(f"{conv}/kernel", cfg.NETS, cfg.SSDS, cfg.FEATURE_LAYER)
            names[name[:-len(".weight")]] = key
    return names


def _calibrated(family):
    """``(jmodel, variables, tmodel, tcfg, x, JAX absmax, port absmax)``."""
    if family not in _CALIBRATED:
        model, kw = FAMILIES[family]
        jmodel, variables, tmodel, _, tcfg = head_pair(*model, seed=5, **kw)
        image = model[2]
        x = np.random.default_rng(2).normal(0, 60, (2, image, image, 3)).astype(np.float32)
        amax = jq.collect_absmax(lambda v, b: jmodel.apply(
            v, b, phase="eval", train=False, mutable=["quant_calib"]), variables, [jnp.asarray(x)])
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            tamax = tq.collect_absmax(tmodel, [xt], lambda b: tmodel(b, phase="eval"))
        _CALIBRATED[family] = (jmodel, variables, tmodel, tcfg.MODEL, xt, amax, tamax)
    return _CALIBRATED[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibration_absmax_equals_jax(family):
    _, _, _, cfg, _, amax, tamax = _calibrated(family)
    names = _jax_names(amax, cfg)
    assert sorted(names) == sorted(tamax)  # every calibrated conv, and no other
    first = next(iter(tamax))
    assert tamax[first] == np.float32(amax[names[first]])  # the same input: bit-equal
    for name, key in names.items():
        np.testing.assert_allclose(tamax[name], amax[key], rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("skip_re", [None, "loc|conf"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantised_conv_set_equals_jax(family, skip_re):
    jmodel, variables, tmodel, cfg, _, amax, tamax = _calibrated(family)
    qvars = jq.quantize_variables(variables, amax, skip_re=skip_re)
    want = quant_state_from_jax(qvars, cfg.NETS, cfg.SSDS, cfg.FEATURE_LAYER)
    got = [n for unit in tq.plan(tmodel, tamax, skip_re) for n in unit]
    assert sorted(got) == sorted(want)
    assert len(got) == jq.num_quantized(qvars)
    if skip_re:
        assert not any(n.startswith(("loc", "conf")) for n in got) and got
    if family == "rfb_vgg16":  # BasicRFB_a: bare nn.Conv in JAX, float in both
        assert not any(n.startswith("norm.") for n in got)
        assert any(n.startswith("extras.0.branch") for n in got)


@pytest.mark.parametrize("family", ["ssd_vgg16", "ssd_lite_mobilenet_v2"])
def test_jax_quantised_variables_through_the_bridge_give_jax_outputs(family):
    """JAX's int8 network and the port's holding its quantised variables:
    outputs within 1e-2 of JAX's largest (measured: 0 for SSD-VGG16 and
    SSDLite-MobileNetV2 on this input)."""
    jmodel, variables, tmodel, cfg, xt, amax, _ = _calibrated(family)
    qvars = jq.quantize_variables(variables, amax)
    import copy

    model = copy.deepcopy(tmodel)
    n = tq.load_quantized(model, quant_state_from_jax(qvars, cfg.NETS, cfg.SSDS,
                                                      cfg.FEATURE_LAYER))
    assert n == jq.num_quantized(qvars) == tq.num_quantized(model)
    want = jmodel.apply(qvars, jnp.asarray(xt.permute(0, 2, 3, 1).numpy()), phase="eval",
                        train=False)
    with torch.no_grad():
        got = model(xt, phase="eval")
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        print(family, "max |d|", err, "of", np.abs(w).max())
        assert err <= 1e-2 * np.abs(w).max()


# -- ports of tests/test_quant.py -------------------------------------------


def _tiny_ssd(quant=""):
    cfg = default_config()
    cfg.MODEL.update(IMAGE_SIZE=[96, 96], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                     ASPECT_RATIOS=[[2], [2, 3], [2]], SIZES=[0.2, 0.5, 0.8, 0.95],
                     HALF_PRECISION=False, QUANT=quant)
    return cfg


@pytest.fixture(scope="module")
def ssd_pair():
    """A float and an int8 tiny SSD detector on the same seeded weights; the
    int8 one quantised at construction (``MODEL.QUANT: int8``)."""
    return ObjectDetector(_tiny_ssd(), device="cpu"), ObjectDetector(_tiny_ssd("int8"),
                                                                     device="cpu")


def test_model_quant_int8_quantises_at_construction(ssd_pair):
    fdet, qdet = ssd_pair
    assert tq.num_quantized(fdet.model) == 0
    n = tq.num_quantized(qdet.model)
    assert n > 10
    # the same as quantising by hand with JAX's default calibration images
    again = ObjectDetector(_tiny_ssd(), device="cpu")
    assert again.quantize_int8() == n
    for (name, a), (_, b) in zip(qdet.model.state_dict().items(),
                                 again.model.state_dict().items()):
        assert torch.equal(a, b), name


def test_int8_outputs_close_to_float(ssd_pair):
    fdet, qdet = ssd_pair
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3),
                                                           dtype=np.uint8))
    loc_f, conf_f = fdet.forward(x)
    loc_q, conf_q = qdet.forward(x)
    assert float((conf_f - conf_q).abs().max()) < 0.08
    assert np.corrcoef(conf_f.ravel().numpy(), conf_q.ravel().numpy())[0, 1] > 0.99
    assert float((loc_f - loc_q).abs().max()) / (float(loc_f.abs().max()) + 1e-6) < 0.1


def test_skip_re_keeps_heads_float_and_skipping_everything_raises():
    det = ObjectDetector(_tiny_ssd(), device="cpu")
    n = det.quantize_int8(skip_re="loc|conf")
    names = [name for name, m in det.model.named_modules() if isinstance(m, tq.QuantConv2d)]
    assert n == len(names) > 0 and not any(x.startswith(("loc", "conf")) for x in names)
    with pytest.raises(ValueError, match="nothing was quantized"):
        ObjectDetector(_tiny_ssd(), device="cpu").quantize_int8(skip_re=".")


def test_no_calibration_statistics_raises():
    det = ObjectDetector(_tiny_ssd(), device="cpu")
    with pytest.raises(ValueError, match="calibration recorded no conv input"):
        tq.collect_absmax(det.model, [0], lambda b: None)


def _lite_cfg():
    cfg = default_config()
    cfg.MODEL.update(SSDS="ssd_lite", NETS="mobilenet_v1_025", IMAGE_SIZE=[96, 96],
                     NUM_CLASSES=3, FEATURE_LAYER=[[11, 13], [128, 256]],
                     ASPECT_RATIOS=[[2], [2]], SIZES=[0.3, 0.6, 0.9], HALF_PRECISION=False)
    cfg.POST_PROCESS.NUM_CLASSES = 3
    return cfg


def test_detector_quantize_int8_lite_head():
    """The lite head: depthwise convs stay float, pointwise go int8, and
    ``predict`` still serves."""
    det = ObjectDetector(_lite_cfg(), device="cpu")
    img = np.random.default_rng(1).integers(0, 255, (120, 160, 3), dtype=np.uint8)
    ref = det.predict(img, threshold=0.0)
    assert det.quantize_int8() > 0
    depthwise = [m for m in det.model.modules()
                 if isinstance(m, torch.nn.Conv2d) and m.groups == m.in_channels > 1]
    assert depthwise  # still float Conv2d modules
    assert isinstance(det.model.loc[0][2], tq.QuantConv2d)
    boxes, labels, scores = det.predict(img, threshold=0.0)
    assert boxes.shape[1] == 4 and np.isfinite(boxes).all()
    assert abs(len(scores) - len(ref[2])) <= max(10, len(ref[2]))


def test_batch_stats_model_quantises_and_stays_close():
    cfg = _lite_cfg()
    cfg.MODEL.update(NETS="mobilenet_v2_025", NUM_CLASSES=4, FEATURE_LAYER=[[7, 14], [96, 320]])
    cfg.POST_PROCESS.NUM_CLASSES = 4
    det = ObjectDetector(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 96, 96, 3),
                                                           dtype=np.uint8))
    out_f = det.forward(x)
    stats = {k: v.clone() for k, v in det.model.state_dict().items() if "running" in k}
    det.quantize_int8()
    after = det.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in stats.items())  # BN untouched, no folding
    out_q = det.forward(x)
    assert float((out_f[1] - out_q[1]).abs().max()) < 0.5


def test_bn_backbone_quantises_whole_network():
    """DarkNet-19 with the YOLOv2 head: the backbone's conv-BN convs go int8,
    not only the head's, and the top scores track the float ones."""
    cfg = default_config()
    cfg.MODEL.update(SSDS="yolo_v2", NETS="darknet_19", IMAGE_SIZE=[96, 96], NUM_CLASSES=4,
                     FEATURE_LAYER=[[10, 12], [256, 512]], ASPECT_RATIOS=[[2], [2]],
                     SIZES=[0.3, 0.5, 0.7], HALF_PRECISION=False)
    cfg.POST_PROCESS.NUM_CLASSES = 4
    det = ObjectDetector(cfg, device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (120, 160, 3), dtype=np.uint8)
    _, _, s_fp = det.predict(img, threshold=0.0)
    assert det.quantize_int8() >= 20
    boxes, _, s_q = det.predict(img, threshold=0.0)
    assert np.isfinite(boxes).all()
    assert float(np.max(np.abs(np.sort(s_fp)[-10:] - np.sort(s_q)[-10:]))) < 0.1


@pytest.mark.slow
def test_int8_preserves_detections_after_overfit():
    """JAX's overfit tiny SSDLite (``tests/test_overfit.py``) through the
    bridge, quantised by the port on its training images: the planted box
    is still found at the same IoU bar with a comparable score."""
    from ssds_tpu_torch.ops.postprocess import PostProcessConfig, detect
    from ssds_tpu_torch.weights import state_dict_from_jax
    from test_overfit import iou, make_cfg, overfit_tiny_model
    from ssds_tpu_torch.models.builder import create_model, init_model

    _, priors, trained, batch, _ = overfit_tiny_model()
    jcfg = make_cfg()
    tmodel, _ = create_model(jcfg.MODEL)
    tmodel = init_model(tmodel)
    tmodel.load_state_dict(state_dict_from_jax(trained, net=jcfg.MODEL.NETS,
                                               ssds=jcfg.MODEL.SSDS), strict=True)
    x = torch.from_numpy(np.array(batch["images"])).permute(0, 3, 1, 2).contiguous()
    post = PostProcessConfig(num_classes=3, score_threshold=0.2, iou_threshold=0.45,
                             max_detections=10)
    pri = torch.from_numpy(np.asarray(priors))
    with torch.no_grad():
        best_f = detect(*tmodel(x, phase="eval"), pri, post)[0, 1, 0].numpy()
        amax = tq.collect_absmax(tmodel, [x], lambda b: tmodel(b, phase="eval"))
        assert tq.quantize_model(tmodel, amax) > 0
        best_q = detect(*tmodel(x, phase="eval"), pri, post)[0, 1, 0].numpy()
    gt = np.asarray(batch["boxes"][0, 0])
    assert best_f[0] > 0.2 and best_q[0] > 0.2
    assert iou(best_q[1:], gt) > 0.5
    assert iou(best_q[1:], best_f[1:]) > 0.5 and abs(best_q[0] - best_f[0]) < 0.25


# -- the export of a quantised detector ---------------------------------------


def test_export_int8_quantized(tmp_path):
    """Quantise, then export (``tests/test_export.py::test_export_int8_quantized``'s
    counterpart): the artifact carries the int8 weights, its graph calls the
    two operators, and the reloaded program's rows equal the in-process
    quantised detector's (unpruned: a symbolic batch takes no prune)."""
    cfg = EXPORT_MODELS["ssd_lite"](default_config())
    det = ObjectDetector(cfg, device="cpu")
    n = det.quantize_int8()
    out = export_detector(det, str(tmp_path / "served_int8"))
    predict, meta = load_exported(out)
    program = torch.export.load(os.path.join(out, "predict.pt2"))
    int8_consts = [k for k, v in program.state_dict.items() if v.dtype == torch.int8]
    assert len(int8_consts) == n and meta["batch"] == "symbolic"
    targets = {str(node.target) for node in program.graph.nodes if node.op == "call_function"}
    assert {"ssds_tpu_torch.quantize_act.default", "ssds_tpu_torch.int8_conv.default"} <= targets
    rng = np.random.default_rng(3)
    for b in (1, 3):
        imgs = torch.from_numpy(rng.integers(0, 255, (b, 96, 96, 3), dtype=np.uint8))
        with torch.no_grad():
            want = _unpruned(det)(imgs)
        assert torch.equal(predict(imgs), want)
