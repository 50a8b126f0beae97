"""The port's SSDLite train step, with BatchNorm, against the JAX package's.

A narrow SSDLite-MobileNetV2 (width 0.25, 64 px, taps 13 and 18 and one 'S'
extra: maps 4/2/1) with random variables (BN statistics too) carried by the
bridge, the same uint8 batch of 4 and padded GT, and the same SGD config
(momentum 0.9, weight decay 4e-5 on every parameter, BN scale and bias
included), through ``ssds_tpu.solver.build_train_step`` (``TrainState.batch_stats``
filled) and ``ssds_tpu_torch.solver.build_train_step`` for two steps. After
each step: the losses, every parameter's update since the start, every
running statistic and ``num_batches_tracked``.

Here both packages run the model in float64 (``jax.enable_x64``, the port's
model ``.double()``; the loss stays float32 in both, as written), and agree
within rtol 1e-6 (losses, statistics) and 2e-5 of the largest update.
Measured: step 1 losses equal, updates 7.0e-8, statistics 4.1e-14; step 2
1.3e-7, 3.7e-6 and 1.5e-7 (the float32 loss's rounding, carried through the
ill-conditioned backward). Float32 cannot be held this tight: through some 60
train-mode BatchNorms the step is ill-conditioned, and the port's own
float32 step-1 update lies 0.35 % of the largest update from its float64
one (1.4 % at 128 px; 12 % after step 2). The float32 and bf16 steps are
held against JAX's in ``tests/test_torch_port_lite_train_lowp.py`` (batch
statistics) and ``tests/test_torch_port_lite_train_frozen.py`` (running
statistics, where the backward is well-conditioned).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ssds_tpu.solver import TrainState
from ssds_tpu.solver import build_train_step as jax_build_train_step
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu_torch.models.builder import create_priors
from ssds_tpu_torch.models.layers import BatchNorm
from ssds_tpu_torch.solver import build_train_step, configure_lr_scheduler, configure_optimizer
from ssds_tpu_torch.weights import port_name
from test_torch_port_mobilenet import lite_pair, one_torch_thread  # noqa: F401
from torch_port_ddp_worker import errors

NET, IMAGE = "mobilenet_v2_025", 64
MODEL = dict(FEATURE_LAYER=[[13, 18, "S"], [96, 1280, 256]], ASPECT_RATIOS=[[2, 3]] * 3)
MAPS = [(4, 4), (2, 2), (1, 1)]
MEANS = (104, 117, 123)
DTYPES = {"float64": (jnp.float64, torch.float64), "float32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _batch(seed=0, b=4, g=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.15, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < np.array([[3], [1], [4], [2]])
    boxes[~valid] = 0.0
    return {"images": rng.integers(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8),
            "boxes": boxes, "labels": rng.integers(0, 20, (b, g)).astype(np.int32),
            "valid": valid}


def _train_cfg(cfg):
    tc = cfg.TRAIN
    tc.OPTIMIZER.LEARNING_RATE = 1e-3
    tc.LR_SCHEDULER.update(SCHEDULER="step", STEPS=[1], GAMMA=0.5, WARM_UP_EPOCHS=0)
    return tc


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


class _RunningStatistics:
    """A JAX model applied with ``train=False`` whatever the step passes: its
    BatchNorms normalise with the running statistics and leave them as they
    are."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, x, **kwargs):
        return self.model.apply(variables, x, **{**kwargs, "train": False})


def _freeze_statistics(model):
    """The port's counterpart: every BatchNorm stays in eval mode whatever
    ``model.train()`` asks."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.train = lambda mode=True, m=m: torch.nn.Module.train(m, False)


def jax_steps(dtype_name, seed=11, frozen=False, batch=None):
    """The JAX package's two steps: ``[(loss_l, loss_c, state dict)]``, the
    start first (losses ``None``); state dicts in float64. ``frozen`` runs
    every BatchNorm on its running statistics (:class:`_RunningStatistics`);
    ``batch`` replaces :func:`_batch`'s."""
    jdtype, _ = DTYPES[dtype_name]
    jmodel, variables, _, cfg = lite_pair(NET, IMAGE, seed=seed, **MODEL)
    if frozen:
        jmodel = _RunningStatistics(jmodel)
    priors = create_priors(cfg.MODEL, MAPS)
    batch = {k: jnp.asarray(v) for k, v in (batch or _batch()).items()}
    tc = _train_cfg(cfg)
    out = [(None, None, _state(variables["params"], variables["batch_stats"]))]
    with jax.enable_x64(dtype_name == "float64"):
        params, stats = variables["params"], variables["batch_stats"]
        if dtype_name == "float64":
            params, stats = _f64(params), _f64(stats)
        tx = jax_opt(tc, jax_sched(tc, 1))(params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
        step = jax_build_train_step(jmodel, jnp.asarray(priors), False, (IMAGE, IMAGE), jdtype,
                                    pixel_means=MEANS)
        for _ in range(2):
            state, m = step(state, batch)
            out.append((float(m["loss_l"]), float(m["loss_c"]),
                        _state(jax.device_get(state.params), jax.device_get(state.batch_stats))))
    return out


def _state(params, batch_stats):
    """A flax tree as the port's state dict (the bridge's names), in float64."""
    sd = {}
    for path, leaf in list(_flatten(params)) + list(_flatten(batch_stats)):
        arr = np.asarray(leaf, np.float64)
        if path.endswith("kernel"):
            arr = arr.transpose(3, 2, 0, 1)
        sd[port_name(path, NET)] = torch.from_numpy(np.array(arr))
    return sd


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, v


def port_steps(dtype_name, seed=11, frozen=False, batch=None):
    """The port's two steps, as :func:`jax_steps` gives them."""
    _, tdtype = DTYPES[dtype_name]
    _, _, tmodel, cfg = lite_pair(NET, IMAGE, seed=seed, **MODEL)
    if tdtype == torch.float64:
        tmodel.double()
    if frozen:
        _freeze_statistics(tmodel)
    priors = torch.from_numpy(create_priors(cfg.MODEL, MAPS))
    batch = {k: torch.from_numpy(v) for k, v in (batch or _batch()).items()}
    tc = _train_cfg(cfg)
    tmodel.train()
    opt = configure_optimizer(tc, tmodel.named_parameters())
    step = build_train_step(tmodel, priors, opt, configure_lr_scheduler(tc, 1), tdtype, MEANS)

    def snapshot():
        return {k: v.detach().clone().double() if v.is_floating_point() else v.clone()
                for k, v in tmodel.state_dict().items()}

    out = [(None, None, snapshot())]
    for i in range(2):
        m = step(batch, i)
        out.append((float(m["loss_l"]), float(m["loss_c"]), snapshot()))
    return out


def test_two_lite_train_steps_equal_jax_in_float64():
    want, got = jax_steps("float64"), port_steps("float64")
    for step, (loss, upd, stat) in enumerate(errors(got, want), 1):
        print(f"step {step}: loss {loss:.2e}, update {upd:.2e}, statistics {stat:.2e}")
        assert loss < 1e-6 and upd < 2e-5 and stat < 1e-6, (step, loss, upd, stat)
        sd = got[step][2]
        assert all(int(v) == step for k, v in sd.items() if k.endswith("num_batches_tracked"))
    start, end = got[0][2], got[2][2]
    moved = {n for n in end if not torch.equal(end[n], start[n])}
    assert {"base.0.0.weight", "base.0.1.weight", "base.0.1.bias", "base.0.1.running_mean",
            "base.1.conv.1.running_var", "norm.weight", "extras.1.4.running_var",
            "loc.0.0.weight", "conf.2.2.bias"} <= moved
