"""The port's solver math against the JAX package's: LR schedules, the
TRAINABLE_SCOPE mask, and the optimizers against the optax chains.

Tolerances: the schedules are the same float32 operations (rtol 1e-6, atol
1e-9: XLA's ``pow`` and ``cos`` against numpy's may round one ulp apart); the
optimizers' parameters after 3 updates, rtol 1e-6 and atol 2.5e-7 (the same
elementwise float32 arithmetic, in places fused into a multiply-add on one
side; the atol is two ulps at the weights' scale, |p| ~ 1, for a weight
that an update takes close to 0).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.solver import Solver as JaxSolver
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu.solver import trainable_mask as jax_mask
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.solver import (Solver, apply_gradients, configure_lr_scheduler,
                                   configure_optimizer, trainable_mask)
from ssds_tpu_torch.weights import port_name
from test_torch_port_checkpoint import config_scopes, ssd300_flax_paths


def _train_cfg(**sched):
    tc = default_config().TRAIN
    tc.MAX_EPOCHS = 20
    tc.LR_SCHEDULER.update(sched)
    return tc


@pytest.mark.parametrize("warm", [0, 3])
@pytest.mark.parametrize("kind,steps,gamma,lr_min", [
    ("step", [4], 0.5, 0.0), ("step", [], 0.98, 0.0), ("multi_step", [2, 5, 11], 0.1, 0.0),
    ("multi_step", [], 0.1, 0.0), ("exponential", [], 0.9, 0.0), ("sgdr", [6], 1.0, 1e-5),
    ("sgdr", [], 1.0, 0.0)])
def test_lr_schedule_equals_jax(kind, steps, gamma, lr_min, warm):
    tc = _train_cfg(SCHEDULER=kind, STEPS=steps, GAMMA=gamma, LR_MIN=lr_min, WARM_UP_EPOCHS=warm)
    tc.OPTIMIZER.LEARNING_RATE = 0.004
    ours, theirs = configure_lr_scheduler(tc, 7), jax_sched(copy.deepcopy(tc), 7)
    got = np.array([ours(s) for s in range(200)])
    want = np.array([float(theirs(s)) for s in range(200)])
    # atol: sgdr's 1 + cos(pi t) near its trough cancels; one ulp of cos
    # there is 1.2e-10 of LR
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    if warm or steps or kind != "multi_step":
        assert len(set(got.tolist())) > 2  # the schedule moves inside 200 steps


@pytest.mark.parametrize("scope", config_scopes())
def test_trainable_mask_equals_jax_on_every_ssd300_param(scope, capsys):
    paths = ssd300_flax_paths()
    tree = {}
    for path in paths:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = 0.0
    want = jax_mask(tree, scope)
    jax_said = capsys.readouterr().out
    got = trainable_mask([port_name("/".join(p)) for p in paths], scope)
    assert capsys.readouterr().out == jax_said  # the warning, or nothing
    for path in paths:
        node = want
        for p in path:
            node = node[p]
        assert got[port_name("/".join(path))] == node, (scope, path)
    if scope == "bogus_scope_word_zzz":
        assert "matches no parameter" in jax_said and set(got.values()) == {"train"}


# flax paths and their port names for the optimizer runs; shapes are free
# (the updates are elementwise and the clip norm sums over a group)
_PARAMS = ("base_layers_0/Conv_0/kernel", "base_layers_0/Conv_0/bias",
           "base_layers_5/Conv_0/kernel", "norm/scale",
           "extra_layers_0/layers_1/Conv_0/kernel", "head/loc0/Conv_0/kernel",
           "head/conf1/Conv_0/bias")


def _optimizer_case(kind):
    tc = _train_cfg(SCHEDULER="step", STEPS=[1], GAMMA=0.8, WARM_UP_EPOCHS=1)
    o = tc.OPTIMIZER
    o.OPTIMIZER, o.LEARNING_RATE, o.MOMENTUM, o.WEIGHT_DECAY = kind, 0.05, 0.9, 0.01
    o.EPS = 1e-3 if kind == "rmsprop" else 1e-8  # large enough that its placement shows
    o.CLIP_GRADIENT = 0.9
    o.DIFFERENTIAL_LEARNING_RATE = [["base", 0.1], ["loc,base", 3.0]]
    tc.TRAINABLE_SCOPE = "base,extras,loc,conf"  # norm frozen
    return tc


def _flax_tree(values):
    tree = {}
    for path, v in values.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("kind", ["sgd", "adam", "rmsprop"])
def test_three_updates_equal_the_optax_chain(kind):
    tc = _optimizer_case(kind)
    rng = np.random.default_rng(0)
    shapes = [(3, 3, 4, 5), (5,), (3, 3, 2, 4), (6,), (1, 1, 3, 3), (3, 3, 2, 8), (7,)]
    init = {p: rng.normal(0, 1, s).astype(np.float32) for p, s in zip(_PARAMS, shapes)}
    # per step and param; base_layers_5 gets large gradients so that its
    # group's norm clips and the other groups' do not
    grads = [{p: (rng.normal(0, 3 if "base" in p else 0.05, v.shape)).astype(np.float32)
              for p, v in init.items()} for _ in range(3)]

    sched = jax_sched(copy.deepcopy(tc), 2)
    tx = jax_opt(copy.deepcopy(tc), sched)(_flax_tree(init))
    params = _flax_tree(init)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(_flax_tree(g), state, params)
        params = optax.apply_updates(params, updates)
    want = {p: np.asarray(v) for p, v in zip(
        _PARAMS, (params["base_layers_0"]["Conv_0"]["kernel"], params["base_layers_0"]["Conv_0"]["bias"],
                  params["base_layers_5"]["Conv_0"]["kernel"], params["norm"]["scale"],
                  params["extra_layers_0"]["layers_1"]["Conv_0"]["kernel"],
                  params["head"]["loc0"]["Conv_0"]["kernel"], params["head"]["conf1"]["Conv_0"]["bias"]))}

    named = [(port_name(p), torch.nn.Parameter(torch.from_numpy(init[p].copy()))) for p in _PARAMS]
    opt = configure_optimizer(tc, named)
    schedule = configure_lr_scheduler(tc, 2)
    by_name = dict(named)
    assert not by_name["norm.weight"].requires_grad  # frozen: outside the optimizer
    assert sorted(g["name"] for g in opt.param_groups) == ["dlr0", "dlr1", "train"]
    for step, g in enumerate(grads):
        for p in _PARAMS:
            param = by_name[port_name(p)]
            if param.requires_grad:
                param.grad = torch.from_numpy(g[p].copy())
        apply_gradients(opt, schedule(step), float(tc.OPTIMIZER.CLIP_GRADIENT))
    for p in _PARAMS:
        got = by_name[port_name(p)].detach().numpy()
        np.testing.assert_allclose(got, want[p], rtol=1e-6, atol=2.5e-7, err_msg=p)
        if p == "norm/scale":
            np.testing.assert_array_equal(got, init[p])
        else:
            assert np.abs(got - init[p]).max() > 1e-4, p  # it moved


def test_rmsprop_eps_inside_the_root():
    """One RMSprop step on one element: u = g / sqrt((1 - 0.9) g^2 + eps)."""
    tc = _train_cfg(WARM_UP_EPOCHS=0)
    tc.OPTIMIZER.OPTIMIZER, tc.OPTIMIZER.MOMENTUM, tc.OPTIMIZER.WEIGHT_DECAY = "rmsprop", 0.0, 0.0
    tc.OPTIMIZER.EPS = 0.01
    w = torch.nn.Parameter(torch.zeros(1))
    opt = configure_optimizer(tc, [("loc.0.weight", w)])
    w.grad = torch.tensor([0.1])
    apply_gradients(opt, 1.0)
    np.testing.assert_allclose(float(w.detach()), -0.1 / np.sqrt(0.1 * 0.01 + 0.01), rtol=1e-6)


def _small_cfg():
    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    return cfg


def test_resume_lr_jax_restarts_the_schedule_port_continues(tmp_path):
    """The JAX solver restores ``step = start_epoch * steps_per_epoch`` but
    builds a fresh optax state, whose schedule count starts at 0: after a
    resume at epoch 10 its first update applies warm-up step 0's LR
    (ssds_tpu/solver.py:368-374; ROADMAP.md §3, a fault of the reference).
    The port applies the LR of the restored step."""
    jcfg = jax_default_config()
    jcfg.TRAIN.LR_SCHEDULER.WARM_UP_EPOCHS = 5
    jcfg.TRAIN.LR_SCHEDULER.STEPS = [1000]  # no decay inside this test
    jcfg.TRAIN.OPTIMIZER.WEIGHT_DECAY = 0.0
    jcfg.TRAIN.TRAINABLE_SCOPE = ""
    base = float(jcfg.TRAIN.OPTIMIZER.LEARNING_RATE)
    js = JaxSolver.__new__(JaxSolver)  # build_state only
    js.cfg, js.start_epoch = jcfg, 10
    js.params, js.batch_stats = {"w": jnp.zeros((1,))}, {}
    js.build_state(steps_per_epoch=7)
    assert int(js.state.step) == 70
    assert float(js.lr_schedule(int(js.state.step))) == pytest.approx(base)  # what it prints
    updates, _ = js.state.tx.update({"w": jnp.ones((1,))}, js.state.opt_state, js.params)
    applied = -float(updates["w"][0])
    assert applied == pytest.approx(float(js.lr_schedule(0)))  # what it applies: warm-up step 0
    assert applied == pytest.approx(base / 35)

    cfg = _small_cfg()
    cfg.TRAIN.LR_SCHEDULER.update(WARM_UP_EPOCHS=5, STEPS=[1000])
    cfg.TRAIN.OPTIMIZER.WEIGHT_DECAY = 0.0
    cfg.EXP_DIR = str(tmp_path)
    solver = Solver(cfg, device="cpu")
    solver.start_epoch = 10
    solver.build_state(steps_per_epoch=7)
    assert solver.step == 70
    w = next(solver.model.parameters())
    before = w.detach().clone()
    for p in solver.model.parameters():
        p.grad = torch.ones_like(p)
    apply_gradients(solver.optimizer, solver.lr_schedule(solver.step))
    assert {g["lr"] for g in solver.optimizer.param_groups} == {solver.lr_schedule(70)}
    assert solver.lr_schedule(70) == pytest.approx(base, rel=1e-7)
    # the step moved each weight by the LR (a difference of float32 weights)
    np.testing.assert_allclose((before - w.detach()).numpy(), base, rtol=5e-5)


def test_solver_refuses_cuda_without_a_gpu_and_unported_phases(tmp_path):
    cfg = _small_cfg()
    cfg.EXP_DIR = str(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            Solver(cfg)
    cfg.PHASE = ["train", "visualize"]  # ported: visualize_epoch
    assert Solver(cfg, device="cpu").phases == ["train", "visualize"]
    cfg.TPU.MESH.SPATIAL = 2  # ported (parallel/spatial.py), but one process holds one band
    with pytest.raises(ValueError, match="SPATIAL"):
        Solver(cfg, device="cpu")
