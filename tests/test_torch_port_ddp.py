"""The port's data-parallel train step against the JAX package's step over a
sharded batch.

Two gloo ranks on the CPU (``tests/torch_port_ddp_worker.py``, launched here
by ``subprocess`` on ``localhost``, one free port a launch; they import no
JAX) each take half of a global batch of 4 through the port's DDP step. The
JAX package takes the same global batch sharded over a 2-device mesh
(``TPU.MESH.DATA: 2`` through ``create_mesh``, ``shard_batch``, the state
replicated), on two of the 8 host devices ``tests/conftest.py`` provides.
Both run in float64 (the losses stay float32 inside both packages), with
the bounds of ``tests/test_torch_port_lite_train.py``: losses and running
statistics within rtol 1e-6, every update within 2e-5 of the largest.

(a) the narrow SSDLite-MobileNetV2 of that file, two steps: 60 train-mode
BatchNorms, whose statistics must be the global batch's; (a') the same run
with each rank's BatchNorms on their own half batch must miss the bounds;
(b) an SSD step in which rank 1's images have no ground truth: the MultiBox
normaliser is the global positive count, and the per-rank normaliser (b')
misses; (c) a YOLOv2 step at step 4000, where the global ``step x batch``
(16,000) has passed the 12,800 images of the prior-regression warm-up and a
rank's ``step x 2`` (8,000) has not; (d) ``DATASET.DEVICE_AUG``: the two
ranks apply different rows of the global draws, and the 2-rank step equals
the port's 1-rank step on the global batch.

Measured (loss, update, statistics): (a) step 1 9.9e-8, 2.9e-6, 5.7e-8, step
2 6.7e-8, 3.7e-6, 1.5e-7; its control 1.7e-2, 7.0 (seven times the largest
update), 0.39. (b) 0, 9.9e-7, 5.7e-8; its control 0.5, 0.5 (the GT-free
rank's loss is 0, so DDP's mean halves the step). (c) 4.6e-8, 9.3e-8,
5.5e-8; JAX's own step with the warm-up on moves 9.6e-3, 6.2e-3. (d) 1.0e-7,
2.8e-10, 5.0e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.parallel.sharding import create_mesh, replicate, shard_batch
from ssds_tpu.solver import TrainState
from ssds_tpu.solver import build_train_step as jax_build_train_step
from ssds_tpu.solver import configure_lr_scheduler as jax_sched
from ssds_tpu.solver import configure_optimizer as jax_opt
from ssds_tpu_torch.models.builder import create_priors
from test_torch_port_lite_train import IMAGE, MAPS, MEANS, MODEL, NET, _batch, _train_cfg
from test_torch_port_mobilenet import lite_pair, one_torch_thread  # noqa: F401
from test_torch_port_yolo_train import _pair as yolo_pair
from torch_port_ddp_worker import collect, errors, launch
from torch_port_heads import _state, batch as head_batch

LIMITS = (1e-6, 2e-5, 1e-6)  # loss, update over the largest update, statistic
YOLO_START = 4000  # global seen 4000 x 4 = 16,000 >= 12,800 > 4000 x 2 = 8,000
AUG_PROB = 0.6


def _lite():
    jmodel, variables, tmodel, cfg = lite_pair(NET, IMAGE, seed=11, **MODEL)
    return {"jmodel": jmodel, "variables": variables, "model_cfg": cfg.MODEL,
            "train_cfg": _train_cfg(cfg), "priors": create_priors(cfg.MODEL, MAPS),
            "state_dict": tmodel.state_dict()}


def _gt_free_batch():
    """:func:`_batch` with rank 1's images (2 and 3) left without ground truth."""
    b = _batch()
    b["valid"][2:] = False
    b["boxes"][2:] = 0.0
    return b


def _yolo_v2():
    jmodel, variables, tmodel, _, cfg = yolo_pair("yolo_v2")
    tc = cfg.TRAIN
    tc.TRAINABLE_SCOPE = ""
    tc.OPTIMIZER.update(LEARNING_RATE=1e-3, MOMENTUM=0.9, WEIGHT_DECAY=5e-4)
    # a constant LR: the JAX optimizer counts its own steps from 0
    tc.LR_SCHEDULER.update(SCHEDULER="step", STEPS=[1], GAMMA=1.0, WARM_UP_EPOCHS=0)
    return {"jmodel": jmodel, "variables": variables, "model_cfg": cfg.MODEL, "train_cfg": tc,
            "priors": None, "state_dict": tmodel.state_dict()}


@pytest.fixture(scope="module")
def models():
    return {"lite": _lite(), "yolo_v2": _yolo_v2()}


def _run(model, data, steps, start=0, **flags):
    return dict(model=model["model_cfg"], train_cfg=model["train_cfg"],
                state_dict=model["state_dict"], priors=model["priors"], batch=data,
                steps=steps, start=start, means=MEANS, **flags)


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """Every port run: ``{"two": {run: [rank 0's, rank 1's]}, "one": {...}}``,
    both launches running at once."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    lite, yolo = models["lite"], models["yolo_v2"]
    two = {"lite": _run(lite, _batch(), 2),
           "lite_local_stats": _run(lite, _batch(), 2, per_rank_stats=True),
           "gt_free": _run(lite, _gt_free_batch(), 1),
           "gt_free_local_norm": _run(lite, _gt_free_batch(), 1, per_rank_normaliser=True),
           "yolo_v2": _run(yolo, head_batch(64), 1, start=YOLO_START),
           "aug": _run(lite, _batch(), 2, device_aug_prob=AUG_PROB)}
    one = {"aug": two["aug"]}
    started = [launch(tmp, "two", two, 2), launch(tmp, "one", one, 1)]
    two_out, one_out = (collect(*s) for s in started)
    return {"two": {k: [r[k] for r in two_out] for k in two},
            "one": {k: [r[k] for r in one_out] for k in one}}


def jax_mesh_steps(model, data, steps, start=0):
    """The JAX package's float64 steps with the batch sharded over a 2-device
    mesh: ``[(loss_l, loss_c, state dict)]`` as ``errors`` takes them."""
    cfg = jax_default_config()
    cfg.TPU.MESH.DATA = 2
    mesh = create_mesh(cfg.TPU, batch_size=data["images"].shape[0])
    assert mesh.devices.shape == (2, 1)
    variables, mcfg = model["variables"], model["model_cfg"]
    tc = model["train_cfg"]
    image = int(mcfg.IMAGE_SIZE[0])
    out = [(None, None, _state(mcfg, variables["params"], variables["batch_stats"]))]
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa
        params, stats = to64(variables["params"]), to64(variables["batch_stats"])
        tx = jax_opt(tc, jax_sched(tc, 1))(params)
        state = TrainState(step=jnp.asarray(start, jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
        state = jax.device_put(state, replicate(mesh))
        priors = model["priors"]
        step = jax_build_train_step(model["jmodel"], None if priors is None else
                                    jnp.asarray(priors), priors is None, (image, image),
                                    jnp.float64, pixel_means=MEANS)
        sharded = shard_batch({k: np.asarray(v) for k, v in data.items()}, mesh)
        for _ in range(steps):
            state, m = step(state, sharded)
            out.append((float(m["loss_l"]), float(m["loss_c"]),
                        _state(mcfg, jax.device_get(state.params),
                               jax.device_get(state.batch_stats))))
    return out


def _within(rows):
    return all(all(e < lim for e, lim in zip(row, LIMITS)) for row in rows)


def _both_ranks_equal(per_rank):
    """The ranks end with the same weights and running statistics."""
    a, b = per_rank[0]["steps"][-1][2], per_rank[1]["steps"][-1][2]
    return all(torch.equal(a[k], b[k]) for k in a)


def test_lite_steps_with_global_batchnorm_equal_jax_mesh(models, ranks):
    """(a) and (a'): two SSDLite steps, 2 ranks against the 2-device mesh."""
    want = jax_mesh_steps(models["lite"], _batch(), 2)
    got = errors(ranks["two"]["lite"][0]["steps"], want)
    local = errors(ranks["two"]["lite_local_stats"][0]["steps"], want)
    for step, (g, lo) in enumerate(zip(got, local), 1):
        print(f"step {step}: global statistics loss {g[0]:.2e}, update {g[1]:.2e}, statistics "
              f"{g[2]:.2e}; per-rank statistics {lo[0]:.2e}, {lo[1]:.2e}, {lo[2]:.2e}")
    assert _within(got), got
    assert _both_ranks_equal(ranks["two"]["lite"])
    sd = ranks["two"]["lite"][0]["steps"][-1][2]
    assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    assert not _within(local), local  # the control: a plain DDP's statistics


def test_gt_free_rank_takes_the_global_normaliser(models, ranks):
    """(b) and (b'): rank 1's images have no ground truth."""
    want = jax_mesh_steps(models["lite"], _gt_free_batch(), 1)
    got = errors(ranks["two"]["gt_free"][0]["steps"], want)
    local = errors(ranks["two"]["gt_free_local_norm"][0]["steps"], want)
    print(f"global normaliser {got}; per-rank normaliser {local}")
    assert _within(got), got
    assert _both_ranks_equal(ranks["two"]["gt_free"])
    assert not _within(local), local


def test_yolo_v2_warm_up_counts_the_global_batch(models, ranks):
    """(c): at step 4000 the global batch has seen 16,000 images (warm-up
    over), a rank's half 8,000; JAX's own step with the warm-up still on
    (8,000 seen) differs, so the count is held."""
    model = models["yolo_v2"]
    data = head_batch(64)
    want = jax_mesh_steps(model, data, 1, start=YOLO_START)
    got = errors(ranks["two"]["yolo_v2"][0]["steps"], want)
    warm = errors(jax_mesh_steps(model, data, 1, start=YOLO_START // 2), want)
    print(f"yolo_v2 at step {YOLO_START}: {got}; JAX with the warm-up on against off {warm}")
    assert _within(got), got
    assert not _within(warm), warm
    assert _both_ranks_equal(ranks["two"]["yolo_v2"])


def test_device_aug_two_ranks_equal_one_rank_at_the_global_batch(ranks):
    """(d): each rank applies its rows of the global batch's draws."""
    two, one = ranks["two"]["aug"], ranks["one"]["aug"][0]
    for step in range(2):
        p0, p1, whole = two[0]["applied"][step], two[1]["applied"][step], one["applied"][step]
        assert not torch.equal(p0.crop_x, p1.crop_x)  # the ranks' crops differ
        for a, b, w in zip(p0, p1, whole):
            assert torch.equal(torch.cat([a, b]), w)
    got = errors(two[0]["steps"], one["steps"])
    print(f"DEVICE_AUG: 2 ranks against 1 rank at the global batch {got}")
    assert _within(got), got
    assert _both_ranks_equal(two)
