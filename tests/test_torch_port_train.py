"""The port's train step against the JAX package's, and its train/test CLIs.

The train step: the narrow SSD of ``tests/test_torch_port_model.py`` with the
same weights (carried by ``state_dict_from_jax``), the same uint8 batch and
padded GT, and the same SGD config, through ``ssds_tpu.solver.build_train_step``
and ``ssds_tpu_torch.solver.build_train_step`` for two steps. Float32:
losses within rtol 1e-5 (float32 sums over the priors in other orders),
parameters within rtol 1e-4 / atol 1e-6 (the forward's convolutions already
differ at rtol 1e-4, ``test_narrow_ssd_eval_equals_jax``; measured 1.5e-8).
bf16 forward: losses within rtol 1e-3 and parameters within atol 5e-5
(measured 3.8e-4 and 1.6e-5, where the weights moved up to 8e-3: the two
frameworks round the bf16 convolutions' sums and bias adds at different
points; JAX's own bf16 step is 1.1e-4 from its float32 step).

The CLIs: ``python -m ssds_tpu_torch.train`` then ``ssds_tpu_torch.test`` on
the CPU over a synthetic VOC, then the train CLI again, which auto-resumes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.solver import TrainState
from ssds_tpu.solver import build_train_step as jax_build_train_step
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.ops.anchors import AnchorConfig, generate_anchors
from ssds_tpu_torch.solver import build_train_step, configure_lr_scheduler, configure_optimizer
from ssds_tpu_torch.weights import state_dict_from_jax
from test_solver_e2e import make_voc
from test_torch_port_model import _narrow_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEANS = (104, 117, 123)
HW = 23


def _priors():
    # the narrow SSD's maps at 23 px and its [4, 6, 6, 4] anchors per cell
    return generate_anchors(AnchorConfig(
        image_size=(HW, HW), feature_maps=((23, 23), (12, 12), (6, 6), (4, 4)),
        aspect_ratios=((2,), (2, 3), (2, 3), (2,)), sizes=(0.2, 0.95), steps=(), clip=True))


def _batch(seed=0, b=2, g=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.6, (b, g, 2))
    wh = rng.uniform(0.15, 0.4, (b, g, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < np.array([[3], [1]])
    boxes[~valid] = 0.0
    return {"images": rng.integers(0, 256, (b, HW, HW, 3), dtype=np.uint8), "boxes": boxes,
            "labels": rng.integers(0, 4, (b, g)).astype(np.int32), "valid": valid}


def _train_cfg():
    tc = default_config().TRAIN
    tc.OPTIMIZER.LEARNING_RATE = 1e-5  # steps of ~1 % of the loss: no divergence
    tc.LR_SCHEDULER.update(SCHEDULER="step", STEPS=[1], GAMMA=0.5, WARM_UP_EPOCHS=0)
    return tc


def _two_steps(half: bool):
    jmodel, variables, tmodel = _narrow_pair(seed=4)
    priors = _priors()
    batch = _batch()
    tc = _train_cfg()

    params = variables["params"]
    tx = jax_opt(tc, jax_sched(tc, 1))(params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), tx=tx)
    jstep = jax_build_train_step(jmodel, jnp.asarray(priors), False, (HW, HW),
                                 jnp.bfloat16 if half else jnp.float32, pixel_means=MEANS)
    jax_losses = []
    for _ in range(2):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jax_losses.append((float(m["loss_l"]), float(m["loss_c"])))
    jax_params = state_dict_from_jax(jax.device_get(state.params))

    tmodel.train()
    opt = configure_optimizer(tc, tmodel.named_parameters())
    tstep = build_train_step(tmodel, torch.from_numpy(priors), opt, configure_lr_scheduler(tc, 1),
                             torch.bfloat16 if half else torch.float32, MEANS)
    port_losses = []
    for i in range(2):
        m = tstep({k: torch.from_numpy(v) for k, v in batch.items()}, i)
        assert all(v.dtype == torch.float32 and v.ndim == 0 for v in m.values())
        port_losses.append((float(m["loss_l"]), float(m["loss_c"])))
    return jax_losses, port_losses, jax_params, tmodel.state_dict(), variables


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
def test_two_train_steps_equal_jax(half):
    jax_losses, port_losses, jax_params, port_params, start = _two_steps(half)
    rtol_loss, rtol_p, atol_p = (1e-3, 0.0, 5e-5) if half else (1e-5, 1e-4, 1e-6)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=rtol_loss)
    assert port_losses[1] != port_losses[0]  # the first step changed the weights
    start = state_dict_from_jax(start)
    assert sorted(port_params) == sorted(jax_params)
    for name, want in jax_params.items():
        np.testing.assert_allclose(port_params[name].numpy(), want.numpy(), rtol=rtol_p,
                                   atol=atol_p, err_msg=name)
    moved = {n for n, t in port_params.items() if not torch.equal(t, start[n])}
    assert {"base.0.weight", "norm.weight", "loc.0.weight", "conf.1.weight"} <= moved


CFG = """
MODEL:
  IMAGE_SIZE: [64, 64]
  FEATURE_LAYER: [[22, 34, 'S'], [512, 1024, 512]]
  ASPECT_RATIOS: [[2], [2, 3], [2, 3]]
  HALF_PRECISION: False
TRAIN:
  MAX_EPOCHS: {epochs}
  CHECKPOINTS_EPOCHS: 1
  BATCH_SIZE: 4
  OPTIMIZER: {{OPTIMIZER: sgd, LEARNING_RATE: 0.001, MOMENTUM: 0.9, WEIGHT_DECAY: 0.0005}}
  LR_SCHEDULER: {{SCHEDULER: sgdr, WARM_UP_EPOCHS: 1}}
TEST: {{BATCH_SIZE: 4, TEST_SCOPE: [2, 2]}}
POST_PROCESS: {{MAX_DETECTIONS: 20}}
DATASET:
  DATASET: voc
  DATASET_DIR: {root}
  TRAIN_SETS: [['2007', 'trainval']]
  TEST_SETS: [['2007', 'test']]
  PROB: 0.6
  NUM_WORKERS: 2
  MAX_GT: 8
EXP_DIR: {exp}
LOG_DIR: {exp}/logs
CHECKPOINTS_PREFIX: smoke
PHASE: ['train', 'eval']
"""


def _cli(module, cfg_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", module, "--cfg", cfg_path, "--device", "cpu"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_train_then_test_cli_then_auto_resume(tmp_path):
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    make_voc(root, n_images=8)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, exp=exp, epochs=2))

    out = _cli("ssds_tpu_torch.train", cfg_path)
    assert "epoch 1/2" in out and "epoch 2/2" in out and "eval epoch 2:" in out
    with open(os.path.join(exp, "checkpoint_list.txt")) as f:
        assert f.read() == "epoch 1:smoke_epoch_1.pth\nepoch 2:smoke_epoch_2.pth\n"
    raw = torch.load(os.path.join(exp, "smoke_epoch_2.pth"), weights_only=True)
    assert raw["epoch"] == 2 and len(raw["state_dict"]) == 47
    assert os.listdir(os.path.join(exp, "logs"))  # the summary writer's events

    out = _cli("ssds_tpu_torch.test", cfg_path)
    assert "resume: loaded 47/47 variables" in out and "smoke_epoch_2.pth" in out
    m_ap = float(out.split("test: mAP=")[1].split()[0])
    assert 0.0 <= m_ap <= 1.0
    assert os.path.exists(os.path.join(exp, "results", "det_test_car.txt"))

    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, exp=exp, epochs=3))
    out = _cli("ssds_tpu_torch.train", cfg_path)
    assert "smoke_epoch_2.pth" in out and "epoch 3/3" in out and "epoch 2/3" not in out
    with open(os.path.join(exp, "checkpoint_list.txt")) as f:
        assert f.read().splitlines()[-1] == "epoch 3:smoke_epoch_3.pth"
