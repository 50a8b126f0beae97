"""The Solver's config switches that the port once ignored or refused, now
read as the JAX package reads them: ``TPU.COMPUTE_DTYPE`` (with
``MODEL.HALF_PRECISION``), ``TPU.DEBUG_NANS`` and ``DATASET.DEVICE_AUG``.

The float32 step under ``COMPUTE_DTYPE: float32`` is held to JAX's step at
``tests/test_torch_port_train.py``'s float32 limits: losses within rtol 1e-5,
parameters within rtol 1e-4 / atol 1e-6.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.solver import Solver as JaxSolver
from ssds_tpu.solver import TrainState
from ssds_tpu.solver import build_train_step as jax_build_train_step
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu_torch import solver as solver_mod
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.ops import augment_device
from ssds_tpu_torch.solver import (
    Solver, build_train_step, configure_lr_scheduler, configure_optimizer)
from ssds_tpu_torch.weights import state_dict_from_jax
from test_solver_e2e import make_voc
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_model import _narrow_pair
from test_torch_port_train import HW, MEANS, _batch, _priors, _train_cfg


def _small_cfg(tmp_path, **model):
    cfg = default_config()
    cfg.MODEL.update(IMAGE_SIZE=[64, 64], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                     ASPECT_RATIOS=[[2], [2, 3], [2, 3]], **model)
    cfg.EXP_DIR = str(tmp_path / "exp")
    cfg.LOG_DIR = str(tmp_path / "exp" / "logs")
    return cfg


@pytest.mark.parametrize("half,compute,want", [
    (True, "bfloat16", torch.bfloat16), (True, "float32", torch.float32),
    (False, "bfloat16", torch.float32), (False, "float32", torch.float32)])
def test_compute_dtype_needs_half_precision_and_bfloat16(tmp_path, half, compute, want):
    """JAX's rule (``ssds_tpu/solver.py:306-309``): bf16 only when
    ``MODEL.HALF_PRECISION`` is set and ``TPU.COMPUTE_DTYPE`` is bfloat16."""
    cfg = _small_cfg(tmp_path, HALF_PRECISION=half)
    cfg.TPU.COMPUTE_DTYPE = compute
    assert Solver(cfg, device="cpu").compute_dtype == want


def test_float32_step_under_compute_dtype_float32_equals_jax(tmp_path):
    """``HALF_PRECISION: True`` with ``COMPUTE_DTYPE: float32``: both Solvers
    pick float32, and the port's step in that dtype equals JAX's."""
    cfg = _small_cfg(tmp_path, HALF_PRECISION=True)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg = jax_default_config()
    jcfg.MODEL.update(IMAGE_SIZE=[64, 64], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                      ASPECT_RATIOS=[[2], [2, 3], [2, 3]], HALF_PRECISION=True, S2D_STEM=0)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    jcfg.EXP_DIR = cfg.EXP_DIR
    jax_dtype = JaxSolver(jcfg).compute_dtype
    port_dtype = Solver(cfg, device="cpu").compute_dtype
    assert jax_dtype == jnp.float32 and port_dtype == torch.float32

    jmodel, variables, tmodel = _narrow_pair(seed=4)
    priors, batch, tc = _priors(), _batch(), _train_cfg()
    params = variables["params"]
    tx = jax_opt(tc, jax_sched(tc, 1))(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), tx=tx)
    jstep = jax_build_train_step(jmodel, jnp.asarray(priors), False, (HW, HW), jax_dtype,
                                 pixel_means=MEANS)
    state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(state.params))

    tmodel.train()
    tstep = build_train_step(tmodel, torch.from_numpy(priors),
                             configure_optimizer(tc, tmodel.named_parameters()),
                             configure_lr_scheduler(tc, 1), port_dtype, MEANS)
    got = tstep({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose([float(got["loss_l"]), float(got["loss_c"])],
                               [float(m["loss_l"]), float(m["loss_c"])], rtol=1e-5)
    port = tmodel.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(port[name].numpy(), w.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def _nan_batch(b=2):
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=b).items()}
    images = batch["images"].float()
    images[0, 3, 4, 1] = float("nan")
    return dict(batch, images=images)


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_raises_at_the_first_non_finite_loss(tmp_path, debug_nans):
    """``TPU.DEBUG_NANS`` (JAX's ``jax_debug_nans``): a step fed a NaN image
    raises ``FloatingPointError`` naming the step and the tensor, before the
    update; off, the step runs on (no check, so no host synchronisation)."""
    cfg = _small_cfg(tmp_path, HALF_PRECISION=False)
    cfg.TPU.DEBUG_NANS = debug_nans
    solver = Solver(cfg, device="cpu")
    solver.build_state(steps_per_epoch=1)
    step = solver.make_train_step()
    before = {k: v.clone() for k, v in solver.model.state_dict().items()}
    batch = _nan_batch()
    batch["images"] = torch.nn.functional.interpolate(
        batch["images"].permute(0, 3, 1, 2), size=(64, 64)).permute(0, 2, 3, 1).contiguous()
    with mock.patch.object(solver_mod, "check_finite", wraps=solver_mod.check_finite) as check:
        if debug_nans:
            with pytest.raises(FloatingPointError, match=r"step 7: loss_l is not finite"):
                step(batch, 7)
            after = solver.model.state_dict()
            assert all(torch.equal(after[k], v) for k, v in before.items())  # no update
        else:
            out = step(batch, 7)
            assert not torch.isfinite(out["loss"])
        assert check.call_count == int(debug_nans)


def test_debug_nans_names_a_non_finite_gradient():
    """A finite loss whose gradient is not: the message names the parameter."""
    _, _, tmodel = _narrow_pair(seed=4)
    tc = _train_cfg()
    tmodel.train()
    step = build_train_step(tmodel, torch.from_numpy(_priors()),
                            configure_optimizer(tc, tmodel.named_parameters()),
                            configure_lr_scheduler(tc, 1), torch.float32, MEANS,
                            debug_nans=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    step(batch, 0)  # finite: trains
    tmodel.norm.weight.register_hook(lambda g: g * float("nan"))
    with pytest.raises(FloatingPointError,
                       match=r"step 1: the gradient of norm.weight is not finite"):
        step(batch, 1)


# -- DATASET.DEVICE_AUG ---------------------------------------------------------


def _aug_cfg(tmp_path, epochs=2):
    root = str(tmp_path / "VOCdevkit")
    make_voc(root, n_images=8)
    cfg = _small_cfg(tmp_path, HALF_PRECISION=False)
    cfg.DATASET.update(DATASET_DIR=root, TRAIN_SETS=[["2007", "trainval"]], PROB=0.6,
                       NUM_WORKERS=0, MAX_GT=8, DEVICE_AUG=True)
    cfg.TRAIN.update(MAX_EPOCHS=epochs, CHECKPOINTS_EPOCHS=1, BATCH_SIZE=4)
    cfg.TRAIN.OPTIMIZER.LEARNING_RATE = 1e-4
    cfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 0
    cfg.PHASE = ["train"]
    return cfg


class _Writer:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))


def _recording(draws):
    sample = augment_device.sample_params

    def record(generator, boxes, valid, prob):
        p = sample(generator, boxes, valid, prob)
        draws.append((prob, p))
        return p

    return record


def test_device_aug_solver_trains_with_a_resize_only_loader(tmp_path):
    """``DEVICE_AUG``: the loader resizes only (``PROB -1`` on the host) and
    every train step augments on the device with ``DATASET.PROB``."""
    cfg = _aug_cfg(tmp_path)
    writer = _Writer()
    solver = Solver(cfg, device="cpu", writer=writer)
    draws = []
    with mock.patch.object(augment_device, "sample_params", _recording(draws)):
        solver.train_model()
    assert solver.get_loader("train").dataset.preproc.p == -1
    assert solver.step == 4 and len(draws) == 4 and all(p == 0.6 for p, _ in draws)
    assert all(np.isfinite(v) for vals in writer.scalars.values() for v in vals)
    assert len(writer.scalars["loss_loc"]) == 2


def test_device_aug_resume_replays_the_draws(tmp_path):
    """The generator is re-seeded from ``(17, step)`` at every step: a Solver
    that resumes at epoch 1 draws for steps 2-3 what the unbroken run drew."""
    cfg = _aug_cfg(tmp_path)
    first, resumed = [], []
    with mock.patch.object(augment_device, "sample_params", _recording(first)):
        Solver(cfg, device="cpu", writer=_Writer()).train_model()
    os.remove(os.path.join(cfg.EXP_DIR, f"{cfg.CHECKPOINTS_PREFIX}_epoch_2.pth"))
    again = Solver(cfg, device="cpu", writer=_Writer())
    with mock.patch.object(augment_device, "sample_params", _recording(resumed)):
        again.train_model()
    assert again.start_epoch == 1 and again.step == 4 and len(resumed) == 2
    for (_, a), (_, b) in zip(first[2:], resumed):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(first[0][1], first[1][1]))
