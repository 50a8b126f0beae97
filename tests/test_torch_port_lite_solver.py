"""The port's Solver, checkpoints and CLIs on SSDLite-MobileNet: BatchNorm
state through training, freezing, weight decay, save, resume and
``RESUME_SCOPE``; the LR schedules of the SSDLite configs; the written-out
copy of the SSDLite-MobileNetV2-300 config.

No tolerances: buffers are compared exactly (a checkpoint stores them as
they are), and the rest are structural checks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import cfg_from_file, ssd_lite_mobilenetv2_config
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model
from ssds_tpu_torch.models.layers import BatchNorm
from ssds_tpu_torch.solver import build_train_step, configure_lr_scheduler, configure_optimizer
from test_multiclass_map_cli import CFG as ORACLE_CFG
from test_solver_e2e import make_voc
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2_CFG = os.path.join(REPO, "experiments/cfgs/ssd_lite_mobilenetv2_train_voc.yml")
SMALL = dict(NETS="mobilenet_v2_025", IMAGE_SIZE=[64, 64],
             FEATURE_LAYER=[[13, 18, "S"], [96, 1280, 256]], ASPECT_RATIOS=[[2, 3]] * 3)


def test_written_out_lite_config_equals_its_yml():
    """``config.ssd_lite_mobilenetv2_config`` (read where PyYAML is missing)
    is the yml loaded through ``cfg_from_file``, key for key."""
    assert ssd_lite_mobilenetv2_config() == cfg_from_file(V2_CFG)


def _small_cfg():
    cfg = cfg_from_file(V2_CFG)
    cfg.MODEL.update(SMALL)
    return cfg


def _model(cfg, seed):
    model, fmaps = create_model(cfg.MODEL)
    model = init_model(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
            elif name.endswith("num_batches_tracked"):
                b.fill_(seed)
    return model, fmaps


def test_checkpoint_keeps_bn_buffers_and_resume_scope_base_restores_the_base(tmp_path):
    cfg = _small_cfg()
    saved, _ = _model(cfg, seed=1)
    path = ckpt.save_checkpoint(str(tmp_path), "lite", 3, saved.state_dict())
    assert ckpt.find_previous(str(tmp_path)) == ([3], [path])
    raw = torch.load(path, weights_only=True)["state_dict"]
    assert sum(k.endswith("running_var") for k in raw) == 54  # 52 BNs in the base, 2 in the extra

    fresh, _ = _model(cfg, seed=2)
    fresh.load_state_dict(ckpt.resume_checkpoint(fresh.state_dict(), path, ""))
    for name, t in saved.state_dict().items():
        assert torch.equal(fresh.state_dict()[name], t), name

    grafted, _ = _model(cfg, seed=2)
    before = {k: v.clone() for k, v in grafted.state_dict().items()}
    grafted.load_state_dict(ckpt.resume_checkpoint(grafted.state_dict(), path, "base"))
    for name, t in grafted.state_dict().items():
        want = saved.state_dict()[name] if name.startswith("base.") else before[name]
        assert torch.equal(t, want), name
    assert any(n.startswith("extras.") and n.endswith("running_var") for n in before)


def test_frozen_scope_still_updates_statistics_and_decay_covers_bn():
    """TRAINABLE_SCOPE 'extras,loc,conf': the base's parameters stay, its
    running statistics move (JAX's ``mutable=['batch_stats']`` step updates
    every BN); every trainable BN scale and bias is in a group with the
    weight decay (``optax.add_decayed_weights`` decays every parameter)."""
    cfg = _small_cfg()
    cfg.TRAIN.TRAINABLE_SCOPE = "extras,loc,conf"
    model, fmaps = _model(cfg, seed=3)
    opt = configure_optimizer(cfg.TRAIN, model.named_parameters())
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"] == 4e-5 for p in g["params"]}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            trainable = not name.startswith("base.")
            assert m.weight.requires_grad == m.bias.requires_grad == trainable, name
            assert (id(m.weight) in decayed and id(m.bias) in decayed) == trainable, name
    priors = torch.from_numpy(create_priors(cfg.MODEL, fmaps))
    step = build_train_step(model.train(), priors, opt, configure_lr_scheduler(cfg.TRAIN, 1),
                            torch.float32, cfg.DATASET.PIXEL_MEANS)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)),
             "boxes": torch.tensor([[[0.1, 0.1, 0.6, 0.5]], [[0.3, 0.2, 0.9, 0.8]]]),
             "labels": torch.tensor([[3], [7]], dtype=torch.int32),
             "valid": torch.ones(2, 1, dtype=torch.bool)}
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step(batch, 0)
    after = model.state_dict()
    for name in after:
        moved = not torch.equal(after[name], before[name])
        if name.startswith("base.") and name.endswith(("weight", "bias")):
            assert not moved, name
        elif name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert moved, name
    assert not torch.equal(after["extras.1.1.weight"], before["extras.1.1.weight"])


CFG = """
MODEL:
  SSDS: ssd_lite
  NETS: mobilenet_v2_025
  IMAGE_SIZE: [64, 64]
  FEATURE_LAYER: [[13, 18, 'S'], [96, 1280, 256]]
  ASPECT_RATIOS: [[2, 3], [2, 3], [2, 3]]
  HALF_PRECISION: False
TRAIN:
  MAX_EPOCHS: 1
  CHECKPOINTS_EPOCHS: 1
  BATCH_SIZE: 4
  TRAINABLE_SCOPE: 'base,norm,extras,loc,conf'
  OPTIMIZER: {{OPTIMIZER: sgd, LEARNING_RATE: 0.01, MOMENTUM: 0.9, WEIGHT_DECAY: 0.00004}}
  LR_SCHEDULER: {{SCHEDULER: sgdr, WARM_UP_EPOCHS: 1}}
TEST: {{BATCH_SIZE: 4, TEST_SCOPE: [1, 1]}}
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
CHECKPOINTS_PREFIX: lite
PHASE: ['train', 'eval']
"""


def _cli(module, cfg_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", module, "--cfg", cfg_path, "--device", "cpu"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_ssd_lite_train_then_test_cli(tmp_path):
    """SSDLite through ``python -m ssds_tpu_torch.train`` / ``.test``: the
    checkpoint holds the BN buffers, the test CLI restores every one of them
    (``num_batches_tracked`` counts the steps) and evaluates."""
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    make_voc(root, n_images=8)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, exp=exp))
    out = _cli("ssds_tpu_torch.train", cfg_path)
    assert "epoch 1/1" in out and "eval epoch 1:" in out
    sd = torch.load(os.path.join(exp, "lite_epoch_1.pth"), weights_only=True)["state_dict"]
    n_bn = sum(k.endswith("running_var") for k in sd)
    assert n_bn == 54 and len(sd) == 351
    assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    out = _cli("ssds_tpu_torch.test", cfg_path)
    assert f"resume: loaded {len(sd)}/{len(sd)} variables" in out
    assert 0.0 <= float(out.split("test: mAP=")[1].split()[0]) <= 1.0


@pytest.mark.parametrize("source", ["ssd_lite_mobilenetv1_train_voc.yml",
                                    "ssd_lite_mobilenetv2_train_voc.yml", "oracle"])
def test_lr_schedules_of_the_ssd_lite_configs_equal_jax(source, tmp_path):
    """The SSDLite ymls' sgdr with 5 warm-up epochs (VOC07+12 at batch 64:
    258 steps an epoch) and the 5-class oracle's multi_step with 2 warm-up
    epochs (100 images at batch 16: 6 steps an epoch), over the whole run,
    against the JAX schedule: rtol 1e-6 / atol 1e-9, as
    ``tests/test_torch_port_solver.py::test_lr_schedule_equals_jax``."""
    if source == "oracle":
        path, spe = str(tmp_path / "oracle.yml"), 6
        with open(path, "w") as f:
            f.write(ORACLE_CFG.format(root=tmp_path, exp=tmp_path, epochs=50, lr_step=35))
    else:
        path, spe = os.path.join(REPO, "experiments/cfgs", source), 16551 // 64
    ours = configure_lr_scheduler(cfg_from_file(path).TRAIN, spe)
    jtrain = jax_cfg_from_file(path).TRAIN
    theirs = jax_sched(jtrain, spe)
    steps = np.linspace(0, int(jtrain.MAX_EPOCHS) * spe - 1, 997).astype(int)
    got = np.array([ours(int(s)) for s in steps])
    want = np.array([float(theirs(int(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert ours(0) < ours(spe * int(jtrain.LR_SCHEDULER.WARM_UP_EPOCHS) - 1)  # warm-up climbs
