"""Shared harness of the FSSD and RFB parity tests (``tests/test_torch_port_fssd.py``,
``tests/test_torch_port_rfb.py``): a JAX head and the port's with the same
random variables, a block or model run on both sides in eval and train mode,
and the two packages' train steps.

Variables are random (``tests/test_torch_port_bn_layers.py::_random_variables``:
every BatchNorm's scale, bias and running statistics too), made with numpy
from a seed, and carried into the port by ``ssds_tpu_torch.weights.port_name``
with the head's kind and FEATURE_LAYER.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.models import builder as jbuilder
from ssds_tpu.solver import TrainState
from ssds_tpu.solver import build_train_step as jax_build_train_step
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model, is_yolo
from ssds_tpu_torch.solver import build_train_step, configure_lr_scheduler, configure_optimizer
from ssds_tpu_torch.weights import port_name, state_dict_from_jax
from test_torch_port_bn_layers import _nchw, _nhwc, _random_variables
from test_torch_port_lite_train import _freeze_statistics, _RunningStatistics

MEANS = (104, 117, 123)
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs(ssds, net, image, feature_layer, aspect_ratios, num_classes=4, **model):
    """The JAX and port configs of a small head: the defaults with these
    ``MODEL`` keys (and ``SIZES`` one longer than the maps), and any other
    ``MODEL`` keys given (a YOLO head's ``ANCHORS``)."""
    out = []
    for make in (jax_default_config, default_config):
        cfg = make()
        cfg.MODEL.update(SSDS=ssds, NETS=net, IMAGE_SIZE=[image, image], NUM_CLASSES=num_classes,
                         FEATURE_LAYER=feature_layer, ASPECT_RATIOS=aspect_ratios,
                         SIZES=[0.2, 0.4, 0.6, 0.8, 0.95][:len(aspect_ratios) + 1], **model)
        cfg.POST_PROCESS.NUM_CLASSES = num_classes
        out.append(cfg)
    if hasattr(out[0].MODEL, "S2D_STEM"):
        out[0].MODEL.S2D_STEM = 0  # the port has the plain VGG stem only
    return out


def jax_shapes(jmodel, image, **kw):
    return jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros((1, image, image, 3)), phase="train", **kw),
        jax.random.PRNGKey(0))


def bridge(variables, model_cfg):
    """``state_dict_from_jax`` with the config's backbone, head and FEATURE_LAYER."""
    return state_dict_from_jax(variables, net=model_cfg.NETS, ssds=model_cfg.SSDS,
                               feature_layer=model_cfg.FEATURE_LAYER)


def head_pair(ssds, net, image, feature_layer, aspect_ratios, seed=0, tame=None, **model):
    """``(jmodel, variables, tmodel, jcfg, tcfg)``: the JAX model with random
    variables and the port's model holding them, the feature-map sizes of
    the two held equal. ``tame(variables)``, when given, rescales the random
    variables in place (a deep residual stack would otherwise blow up);
    ``model`` holds further ``MODEL`` keys."""
    jcfg, tcfg = configs(ssds, net, image, feature_layer, aspect_ratios, **model)
    jmodel, jfmaps = jbuilder.create_model(jcfg.MODEL)
    variables = _random_variables(jax_shapes(jmodel, image), np.random.default_rng(seed))
    if tame is not None:
        tame(variables)
    tmodel, fmaps = create_model(tcfg.MODEL)
    assert fmaps == [tuple(f) for f in jfmaps], (fmaps, jfmaps)
    tmodel = init_model(tmodel, seed)
    tmodel.load_state_dict(bridge(variables, tcfg.MODEL), strict=True)
    return jmodel, variables, tmodel, jcfg, tcfg


def block_state(variables, prefix, strip, **name_kw):
    """A block's flax variables as the port's state dict: each path named as
    if it sat under ``prefix`` of a model's tree (``'extra_layers_0/'``,
    ``'norm/'``), then ``strip``, that module's port name (``'extras.0.'``),
    taken off."""
    sd = {}
    for col in ("params", "batch_stats"):
        for path, v in traverse_util.flatten_dict(variables.get(col, {})).items():
            name = port_name(prefix + "/".join(path), **name_kw)
            assert name.startswith(strip), (name, strip)
            name = name[len(strip):]
            arr = v.transpose(3, 2, 0, 1) if path[-1] == "kernel" else v
            sd[name] = torch.from_numpy(np.array(arr, np.float32))
            if path[-1] == "mean":
                sd[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def check_block_eval(jblock, variables, tblock, x, rtol, atol, **apply_kw):
    """Eval mode: the outputs of ``jblock.apply(variables, x)`` and ``tblock(x)``."""
    want = _as_list(jblock.apply(variables, jnp.asarray(x), train=False, **apply_kw))
    with torch.no_grad():
        got = _as_list(tblock.eval()(_nchw(x), **apply_kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _nhwc(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=rtol, atol=atol)


def _close_to_largest(got, want, tol, what, floor):
    """``max |got - want| <= tol * max(max |want|, floor)``: a gradient summed
    over every position and channel rounds in proportion to its largest
    terms, not to each element."""
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), floor)
    assert err <= tol, f"{what}: max|d| / max|want| = {err:.2e} > {tol:.0e}"
    return err


def check_block_train(jblock, variables, tblock, x, port_names, rng, tol, stats_tol,
                      grad_tol=1e-5, **apply_kw):
    """Train mode (batch statistics): the outputs (``tol`` = rtol, atol), the
    gradients of ``sum(out * cotangent)`` for the input and every parameter
    (each within ``grad_tol`` of its largest element, or of a tenth of the
    block's largest gradient where that is more: a BatchNorm's bias whose
    per-channel shift a later train-mode BatchNorm takes back out has a
    gradient that is zero up to rounding, a sum of cancelling terms as large
    as the block's other gradients), and the running buffers after the call.
    ``port_names(flax tree) -> state dict`` names a flax tree the port's way.
    Returns the largest gradient error seen."""
    def f(params, x):
        return jblock.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"], **apply_kw)

    want, mut = f(variables["params"], jnp.asarray(x))
    want = [np.asarray(w) for w in _as_list(want)]
    cots = [rng.normal(0, 1, w.shape).astype(np.float32) for w in want]
    _, pull = jax.vjp(lambda p, x: _as_list(f(p, x)[0]), variables["params"], jnp.asarray(x))
    g_params, g_x = pull([jnp.asarray(c) for c in cots])

    tblock.train()
    xt = _nchw(x).requires_grad_()
    outs = _as_list(tblock(xt, **apply_kw))
    sum((o * _nchw(c)).sum() for o, c in zip(outs, cots)).backward()
    rtol, atol = tol
    for o, w in zip(outs, want):
        np.testing.assert_allclose(_nhwc(o), w, rtol=rtol, atol=atol)
    want_grads = port_names({"params": jax.tree_util.tree_map(np.asarray, g_params)})
    floor = 0.1 * max(float(g.abs().max()) for g in want_grads.values())
    worst = _close_to_largest(_nhwc(xt.grad), np.asarray(g_x), grad_tol, "input", floor)
    params = dict(tblock.named_parameters())
    assert set(want_grads) <= set(params)
    for name, p in params.items():
        if name not in want_grads:  # a module the JAX block does not make
            assert p.grad is None, name
            continue
        worst = max(worst, _close_to_largest(p.grad.numpy(), want_grads[name].numpy(), grad_tol,
                                             name, floor))
    new_stats = port_names({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                  mut["batch_stats"])})
    buffers = dict(tblock.named_buffers())
    for name, want_stat in new_stats.items():
        if name.endswith("num_batches_tracked"):
            assert int(buffers[name]) == 1, name
            continue
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(), rtol=stats_tol[0],
                                   atol=stats_tol[1], err_msg=name)
    print(f"largest gradient error over its tensor's largest element: {worst:.2e}")
    return worst


def served_forward_against_jax(jmodel, variables, det, x, half, f32_tol,
                               names=("loc", "conf")):
    """The detector's eval forward on uint8 ``x`` against the JAX model's (the
    mean subtracted in float32, then the bf16 cast). Float32: ``loc`` and the
    softmax within ``f32_tol`` (atol each). bf16: each lies no further from
    JAX's float32 forward than twice JAX's own bf16 forward does (every
    layer rounds to bf16 in both packages, and where the two round a
    convolution's sum differs, so the two bf16 forwards are not closer to
    each other than to the float32 one). Returns the errors for printing,
    under ``names`` (a YOLO head's outputs are decoded boxes and scores)."""
    means = np.asarray(det.cfg.DATASET.PIXEL_MEANS, np.float32)
    forward = jax.jit(lambda v, img, dt: jmodel.apply(
        v, (img.astype(jnp.float32) - means).astype(dt), phase="eval", train=False),
        static_argnums=2)
    want = [np.asarray(a) for a in forward(variables, x, jnp.bfloat16 if half else jnp.float32)]
    got = [a.numpy() for a in det.forward(torch.from_numpy(x))]
    assert all(g.shape == w.shape and g.dtype == w.dtype == np.float32 for g, w in zip(got, want))
    if not half:
        for g, w, tol in zip(got, want, f32_tol):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        return {k: float(np.abs(g - w).max()) for k, g, w in zip(names, got, want)}
    ref = [np.asarray(a) for a in forward(variables, x, jnp.float32)]
    out = {}
    for k, g, w, r in zip(names, got, want, ref):
        port_err, jax_err = float(np.abs(g - r).max()), float(np.abs(w - r).max())
        out[k] = (port_err, jax_err)
        assert port_err <= 2 * jax_err, (k, port_err, jax_err)
    return out


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------


def batch(image, seed=0, b=4, g=4):
    """A uint8 batch of ``b`` images with up to ``g`` padded GT boxes each."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.15, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < rng.integers(1, g + 1, (b, 1))
    boxes[~valid] = 0.0
    return {"images": rng.integers(0, 256, (b, image, image, 3), dtype=np.uint8),
            "boxes": boxes, "labels": rng.integers(0, 3, (b, g)).astype(np.int32),
            "valid": valid}


def _train_cfg(cfg, lr=1e-3):
    tc = cfg.TRAIN
    tc.TRAINABLE_SCOPE = ""
    tc.OPTIMIZER.update(LEARNING_RATE=lr, MOMENTUM=0.9, WEIGHT_DECAY=5e-4)
    tc.LR_SCHEDULER.update(SCHEDULER="step", STEPS=[1], GAMMA=0.5, WARM_UP_EPOCHS=0)
    return tc


def _state(model_cfg, params, batch_stats):
    """A flax tree as the port's state dict (the bridge's names), in float64."""
    f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    sd = bridge({"params": f64, "batch_stats": jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), batch_stats)}, model_cfg)
    return {k: (v.double() if v.is_floating_point() else v) for k, v in sd.items()}


class _FrozenHead(_RunningStatistics):
    """:class:`_RunningStatistics` that also shows the model's attributes (a
    YOLO step reads its ``anchors`` and ``version``)."""

    def __getattr__(self, name):
        return getattr(self.model, name)


def _priors(model_cfg):
    """The config's priors, or None for a YOLO head (which decodes its own boxes)."""
    if is_yolo(model_cfg):
        return None
    return create_priors(model_cfg, create_model(model_cfg)[1])


def jax_steps(pair, dtype_name, frozen=False, data=None, steps=2, lr=1e-3):
    """The JAX package's train steps on ``pair`` (:func:`head_pair`'s result):
    ``[(loss_l, loss_c, state dict)]``, the start first (losses ``None``),
    state dicts in float64. ``frozen`` runs every BatchNorm on its running
    statistics; SGD (momentum 0.9, decay 5e-4) at ``lr``."""
    jdtype, _ = DTYPES[dtype_name]
    jmodel, variables, _, jcfg, tcfg = pair
    image = int(tcfg.MODEL.IMAGE_SIZE[0])
    if frozen:
        jmodel = _FrozenHead(jmodel)
    priors = _priors(tcfg.MODEL)
    data = {k: jnp.asarray(v) for k, v in (data or batch(image)).items()}
    tc = _train_cfg(jcfg, lr)
    out = [(None, None, _state(tcfg.MODEL, variables["params"], variables["batch_stats"]))]
    with jax.enable_x64(dtype_name == "float64"):
        params, stats = variables["params"], variables["batch_stats"]
        if dtype_name == "float64":
            to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa
            params, stats = to64(params), to64(stats)
        tx = jax_opt(tc, jax_sched(tc, 1))(params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
        step = jax_build_train_step(jmodel, None if priors is None else jnp.asarray(priors),
                                    priors is None, (image, image), jdtype, pixel_means=MEANS)
        for _ in range(steps):
            state, m = step(state, data)
            out.append((float(m["loss_l"]), float(m["loss_c"]),
                        _state(tcfg.MODEL, jax.device_get(state.params),
                               jax.device_get(state.batch_stats))))
    return out


def port_steps(pair, dtype_name, frozen=False, data=None, steps=2, lr=1e-3, start=0,
               scheduler="step"):
    """The port's train steps, as :func:`jax_steps` gives them; the first
    has step index ``start`` (YOLOv2's seen images and the schedule count
    from it) under the LR ``scheduler``."""
    _, tdtype = DTYPES[dtype_name]
    _, variables, _, jcfg, tcfg = pair
    image = int(tcfg.MODEL.IMAGE_SIZE[0])
    tmodel = init_model(create_model(tcfg.MODEL)[0])
    tmodel.load_state_dict(bridge(variables, tcfg.MODEL), strict=True)
    if tdtype == torch.float64:
        tmodel.double()
    if frozen:
        _freeze_statistics(tmodel)
    priors = _priors(tcfg.MODEL)
    priors = None if priors is None else torch.from_numpy(priors)
    data = {k: torch.from_numpy(v) for k, v in (data or batch(image)).items()}
    tc = copy.deepcopy(_train_cfg(tcfg, lr))
    tc.LR_SCHEDULER.SCHEDULER = scheduler
    tmodel.train()
    opt = configure_optimizer(tc, tmodel.named_parameters())
    step = build_train_step(tmodel, priors, opt, configure_lr_scheduler(tc, 1), tdtype, MEANS)

    def snapshot():
        return {k: v.detach().clone().double() if v.is_floating_point() else v.clone()
                for k, v in tmodel.state_dict().items()}

    out = [(None, None, snapshot())]
    for i in range(steps):
        m = step(data, start + i)
        out.append((float(m["loss_l"]), float(m["loss_c"]), snapshot()))
    return out
