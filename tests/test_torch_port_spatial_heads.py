"""The spatial mesh axis (``TPU.MESH.SPATIAL``) for the families whose head
mixes rows across the bands with a layer that is neither a conv nor a pool:
FSSD and FSSDLite (the fusion's bilinear resizes), YOLOv3 (its two
upsamples) and YOLOv2 (its reorg), against the JAX package's step on a
``('data', 'spatial')`` mesh and the port's own one-process step.

Gloo ranks on the CPU (``tests/torch_port_ddp_worker.py``'s spatial runs; they
import no JAX) take the batch on ``1 x S`` layouts; the JAX package takes it
through ``create_mesh`` and ``shard_batch`` on the host devices
``tests/conftest.py`` provides. The models are the port's float64 parity
models (random variables from a seed, ``tests/torch_port_heads.py``; every
parameter trains, ``TRAINABLE_SCOPE: ''``, in both packages, so the FSSD
fusion BatchNorm, which JAX's default scope freezes and the port's trains,
trains in both): FSSD and FSSDLite over MobileNetV1-0.25 at 96 px, the
models of ``tests/test_torch_port_fssd.py``'s float64 parity (fusion
sources 12 / 6 / 3 rows, as FSSD-VGG16's at 96 px, so at S = 4 the 3-row
source splits 1/1/1/0 and one rank owns output rows of the 12-row grid but
no input row; VGG16's 22 M parameters would make each rank write ~0.5 GB of
float64 states a run, so FSSD-VGG16 is held on the card, at 300 px, by
``chip_smoke.py`` phase 19), YOLOv3 and YOLOv2
over MobileNetV1-0.25 at 64 px (``tests/test_torch_port_yolo_train.py``:
YOLOv3's 2-row map splits 1/1/0/0 at S = 4), and YOLOv2 at 96 px, whose
6-row stride-16 map splits 3/3 at S = 2, so the reorg's band boundary is odd
and rank 0's second output row reads row 3 of rank 1.

(a) Two steps at 1 x 2 against JAX's two steps on a ``(1, 2)`` mesh, within
each family's own float64 bounds against JAX (``FSSD_LIMITS``: FSSD's
``FLOAT64_LIMITS``; ``YOLO_LIMITS``: YOLO's ``STEP1_LIMITS`` /
``STEP2_LIMITS``); JAX's 2-D meshes have a fault of their own
(``tests/test_torch_port_spatial.py::JAX_2D_MESH_FAULT``), so only 1-D ones
are used. (b) The first step at 1 x 2 and 1 x 4 against the port's
one-process step within ``LIMITS`` (``tests/test_torch_port_spatial.py``),
the ranks' states equal. (c) A control: YOLOv3 with zero rows where a band's
neighbours' rows belong misses those bounds. (b') Two steps at 2 x 2 (two
data groups of two bands) of FSSDLite and of YOLOv2 at 96 px across its
warm-up's edge (``WARM_EDGE``) against the port's one-process steps within
``LIMITS`` (JAX's 2-D meshes have their fault), and a control: the
one-process YOLOv2 steps with one group's seen images miss them. (d) Each new layer alone, S
ranks as threads on an in-process transport, at every geometry of
FSSD-VGG16-300, FSSDLite-MobileNetV2-300, YOLOv3-DarkNet53-416 and
YOLOv2-DarkNet19-416 and one shrinking resize: the forward rows equal the
whole map's bit for bit in float32 and bf16, and the input's gradient the
whole map's (``GRAD_TOL``). (e) Every FSSD and YOLO yml partitions at its own
image size on 2 and 4 bands, on the ``meta`` device. (f) The train CLI under
``torch.distributed.run`` at 1 x 2 on YOLOv3, then a 1-process
``test_model`` on its checkpoint.
"""

import copy
import os
import subprocess
import sys
import tempfile

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
from ssds_tpu_torch.config import cfg_from_file
from ssds_tpu_torch.models.builder import create_model
from ssds_tpu_torch.models.heads.yolo import Reorg
from ssds_tpu_torch.models.layers import Resize
from ssds_tpu_torch.parallel import spatial
from ssds_tpu_torch.solver import Solver
from test_torch_port_fssd import FLOAT64_LIMITS as FSSD_LIMITS
from test_torch_port_fssd import TRAIN_MODEL as FSSD_MODEL
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_spatial import LIMITS, on_threads
from test_torch_port_yolo_solver import _write_cfg
from test_torch_port_yolo_train import SMALL, STEP1_LIMITS, STEP2_LIMITS
from torch_port_ddp_worker import collect, errors, expand, free_port, launch
from torch_port_heads import (DTYPES, MEANS, _priors, _state, _train_cfg, batch, bridge,
                              head_pair, port_steps)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
YOLO_LIMITS = [STEP1_LIMITS, STEP2_LIMITS]
# the input's gradient of a banded resize: the whole map's W @ g is a sum
# over every output row, the bands' a sum of each band's share, each
# computed in float32 (resize_bilinear's contraction); the reorg's is exact
GRAD_TOL = 1e-6  # of the gradient's largest element; measured 9.3e-8 at most

# name -> (ssds, net, image, FEATURE_LAYER, ASPECT_RATIOS, further MODEL keys)
MODELS = {
    "fssd": ("fssd", *FSSD_MODEL, {}),
    "fssd_lite": ("fssd_lite", *FSSD_MODEL, {}),
    "yolo_v3": ("yolo_v3", *SMALL["yolo_v3"][:4], {"ANCHORS": SMALL["yolo_v3"][4]}),
    "yolo_v2": ("yolo_v2", *SMALL["yolo_v2"][:4], {"ANCHORS": SMALL["yolo_v2"][4]}),
    "yolo_v2_96": ("yolo_v2", "mobilenet_v1_025", 96, *SMALL["yolo_v2"][2:4],
                   {"ANCHORS": SMALL["yolo_v2"][4]}),
}
JAX_LIMITS = {"fssd": FSSD_LIMITS, "fssd_lite": FSSD_LIMITS, "yolo_v3": YOLO_LIMITS,
              "yolo_v2": YOLO_LIMITS, "yolo_v2_96": YOLO_LIMITS}
# 2 x 2 (two data groups of two bands): YOLOv2's warm-up, a pull of every
# cell toward its anchor, lasts while fewer than 12,800 images are seen,
# counted over the data groups (solver.py's ``step * batch * groups``). At
# the global batch of 4 its two steps start one step short of that edge:
# step 3199 has seen 12,796 images (warm), step 3200 12,800 (not); a count of
# one group's images (6,398 / 6,400) would keep step 2 warm. The schedule is
# multi_step (the LR halved once after the first epoch): the tests' "step"
# schedule would take the LR to 0.5 ** 3199 = 0 by then.
WARM_EDGE, EDGE_SCHEDULER = 12800 // 4 - 1, "multi_step"
TWO_BY_TWO = ("fssd_lite", "yolo_v2_96")


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, (ssds, net, image, feature_layer, aspect_ratios, extra) in MODELS.items():
        out[name] = head_pair(ssds, net, image, feature_layer, aspect_ratios, seed=11, **extra)
    return out


def _image(pair):
    return int(pair[4].MODEL.IMAGE_SIZE[0])


def _run(pair, steps, **flags):
    _, variables, _, _, tcfg = pair
    return dict(model=tcfg.MODEL, train_cfg=_train_cfg(tcfg), priors=_priors(tcfg.MODEL),
                state_dict=bridge(variables, tcfg.MODEL), batch=batch(_image(pair)),
                steps=steps, means=MEANS, compact=True, **flags)


def _edge_run(pair, **flags):
    """Two steps of :func:`_run` from ``WARM_EDGE`` under ``EDGE_SCHEDULER``."""
    train_cfg = copy.deepcopy(_train_cfg(pair[4]))
    train_cfg.LR_SCHEDULER.SCHEDULER = EDGE_SCHEDULER
    return dict(_run(pair, 2, **flags), train_cfg=train_cfg, start=WARM_EDGE)


@pytest.fixture(scope="module")
def ranks(pairs, request):
    """Every port run, by layout: ``{layout: {run: (rank 0's steps, each
    rank's transfers, whether the ranks' last states are equal)}}``; the
    launches run at once, and alongside the JAX steps and this process's.
    Their files are removed as soon as they are read."""
    layouts = {
        "1x2": (2, {**{name: _run(pair, 2, spatial=2) for name, pair in pairs.items()},
                    "zero_halo": _run(pairs["yolo_v3"], 1, spatial=2, zero_halo=True)}),
        "1x4": (4, {name: _run(pair, 1, spatial=4) for name, pair in pairs.items()
                    if name != "yolo_v2"}),  # yolo_v2_96's reorg covers the family
        "2x2": (4, {"fssd_lite": _run(pairs["fssd_lite"], 2, spatial=2),
                    "yolo_v2_96": _edge_run(pairs["yolo_v2_96"], spatial=2)}),
    }
    with tempfile.TemporaryDirectory() as tmp:
        started = {k: launch(tmp, k, runs, world) for k, (world, runs) in layouts.items()}
        request.getfixturevalue("jax_steps")
        request.getfixturevalue("one_process")
        request.getfixturevalue("one_process_2x2")
        out = {}
        for k, st in started.items():
            per_rank = collect(*st)
            for path in st[1]:
                os.remove(path)
            out[k] = {name: (expand(run, per_rank[0][name]),
                             [r[name]["transfers"] for r in per_rank],
                             len({r[name]["last_digest"] for r in per_rank}) == 1)
                      for name, run in layouts[k][1].items()}
    return out


@pytest.fixture(scope="module")
def one_process(pairs, one_torch_thread):  # noqa: F811
    return {name: port_steps(pair, "float64", steps=1) for name, pair in pairs.items()}


@pytest.fixture(scope="module")
def one_process_2x2(pairs, one_torch_thread):  # noqa: F811
    """The one-process steps the 2 x 2 runs are held to: FSSDLite's first
    two, YOLOv2's two at the warm-up's edge."""
    return {"fssd_lite": port_steps(pairs["fssd_lite"], "float64", steps=2),
            "yolo_v2_96": port_steps(pairs["yolo_v2_96"], "float64", steps=2, start=WARM_EDGE,
                                     scheduler=EDGE_SCHEDULER)}


def jax_mesh_steps(pair, mesh_shape, steps=2):
    """``torch_port_heads.jax_steps`` in float64 on a ``mesh_shape`` =
    ``(data, spatial)`` mesh of the host devices, the images placed
    ``P('data', 'spatial')``."""
    jmodel, variables, _, jcfg, tcfg = pair
    image = _image(pair)
    data = batch(image)
    mesh_cfg = jax_default_config()
    mesh_cfg.TPU.MESH.DATA, mesh_cfg.TPU.MESH.SPATIAL = mesh_shape
    mesh = create_mesh(mesh_cfg.TPU, batch_size=data["images"].shape[0])
    assert mesh.devices.shape == mesh_shape and mesh.axis_names == ("data", "spatial")
    priors = _priors(tcfg.MODEL)
    tc = _train_cfg(jcfg)
    out = [(None, None, _state(tcfg.MODEL, variables["params"], variables["batch_stats"]))]
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)  # noqa
        params, stats = to64(variables["params"]), to64(variables["batch_stats"])
        tx = jax_opt(tc, jax_sched(tc, 1))(params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), tx=tx)
        state = jax.device_put(state, replicate(mesh))
        step = jax_build_train_step(jmodel, None if priors is None else jnp.asarray(priors),
                                    priors is None, (image, image), DTYPES["float64"][0],
                                    pixel_means=MEANS)
        sharded = shard_batch(data, mesh)
        for _ in range(steps):
            state, m = step(state, sharded)
            out.append((float(m["loss_l"]), float(m["loss_c"]),
                        _state(tcfg.MODEL, jax.device_get(state.params),
                               jax.device_get(state.batch_stats))))
    return out


@pytest.fixture(scope="module")
def jax_steps(pairs):
    return {name: jax_mesh_steps(pair, (1, 2)) for name, pair in pairs.items()}


def _within(rows, limits):
    """``limits``: one bound triple for every row, or one a row."""
    limits = limits if isinstance(limits[0], (tuple, list)) else [limits] * len(rows)
    return all(all(e <= lim for e, lim in zip(row, lims)) for row, lims in zip(rows, limits))


def _report(what, rows):
    for step, row in enumerate(rows, 1):
        print(f"{what} step {step}: loss {row[0]:.2e}, update {row[1]:.2e}, "
              f"statistics {row[2]:.2e}")


# -- (a), (b): the spatial steps against JAX's mesh and the port's one process --


@pytest.mark.parametrize("name", sorted(MODELS))
def test_1x2_steps_equal_jax_mesh_and_one_process(name, ranks, jax_steps, one_process):
    """(a) and (b) at 1 x 2: two steps against JAX's ``(1, 2)`` mesh, the
    first against the port's one process; the ranks' states equal, and the
    new layer fetched rows."""
    got, transfers, equal = ranks["1x2"][name]
    rows = errors(got, jax_steps[name])
    _report(f"{name} 1x2 against JAX (1, 2):", rows)
    assert _within(rows, JAX_LIMITS[name]), rows
    rows = errors(got[:2], one_process[name])
    _report(f"{name} 1x2 against the port's one process:", rows)
    assert _within(rows, LIMITS), rows
    assert equal
    sd = got[-1][2]
    assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    print(f"{name} 1x2 transfers over two steps, rank 0: {transfers[0]}")
    assert transfers[0]["halo_messages"] > 0


@pytest.mark.parametrize("name", sorted(set(MODELS) - {"yolo_v2"}))
def test_1x4_step_equals_one_process(name, ranks, one_process):
    """(b) at 1 x 4: thin and empty bands (a 3-row fusion source 1/1/1/0,
    YOLOv3's 2-row map 1/1/0/0, YOLOv2's 3-row reorg output at 96 px 1/1/1/0)."""
    got, _, equal = ranks["1x4"][name]
    rows = errors(got, one_process[name])
    _report(f"{name} 1x4 against the port's one process:", rows)
    assert _within(rows, LIMITS), rows
    assert equal


@pytest.mark.parametrize("name", TWO_BY_TWO)
def test_2x2_steps_equal_one_process(name, ranks, one_process_2x2):
    """Two steps on 2 x 2 (the batch split over two data groups, each
    group's images over two bands; BatchNorm statistics and the MultiBox
    normaliser over all four ranks) against the port's one process, within
    ``LIMITS``: FSSDLite's fusion resizes, and YOLOv2's reorg across the
    warm-up's edge, where the seen images must count both groups."""
    got, transfers, equal = ranks["2x2"][name]
    rows = errors(got, one_process_2x2[name])
    _report(f"{name} 2x2 against the port's one process:", rows)
    assert _within(rows, LIMITS), rows
    assert equal
    assert transfers[0]["halo_messages"] > 0


def test_2x2_control_one_groups_seen_images_misses_the_bounds(pairs, one_process_2x2,
                                                               monkeypatch):
    """The edge is sharp: YOLOv2's one-process steps with the seen images of
    one data group (half the global count) equal the true ones at the warm
    step and miss ``LIMITS`` at the next, which they keep warm."""
    from ssds_tpu_torch import solver

    loss = solver.detection_loss
    monkeypatch.setattr(solver, "detection_loss",
                        lambda *a, seen_images, **k: loss(*a, seen_images=seen_images / 2, **k))
    half = port_steps(pairs["yolo_v2_96"], "float64", steps=2, start=WARM_EDGE,
                      scheduler=EDGE_SCHEDULER)
    rows = errors(half, one_process_2x2["yolo_v2_96"])
    _report("control: one group's seen images (YOLOv2):", rows)
    assert _within(rows[:1], LIMITS) and not _within(rows[1:], LIMITS), rows


def test_zero_halo_control_misses_the_bounds(ranks, one_process):
    """(c): YOLOv3 at 1 x 2 with zeros for the neighbours' rows (the convs',
    and the upsamples' fetches) is not the one-process step."""
    rows = errors(ranks["1x2"]["zero_halo"][0], one_process["yolo_v3"])
    _report("control zero_halo (YOLOv3):", rows)
    assert not _within(rows, LIMITS), rows


# -- (d): each new layer alone, S ranks as threads ----------------------------------


def _layer_geometries():
    """Every resize and reorg geometry of FSSD-VGG16-300,
    FSSDLite-MobileNetV2-300, YOLOv3-DarkNet53-416 and YOLOv2-DarkNet19-416
    (partitioned on ``meta``), and one shrinking resize."""
    found = {spatial.WindowGeometry.bilinear(38, 10)}
    for yml in ("fssd_vgg16_train_voc.yml", "fssd_lite_mobilenetv2_train_voc.yml",
                "yolo_v3_darknet_53_train_voc.yml", "yolo_v2_darknet_19_train_voc.yml"):
        cfg = cfg_from_file(os.path.join(REPO, "experiments", "cfgs", yml))
        model = create_model(cfg.MODEL)[0]  # on the meta device
        spatial.partition(model, cfg.MODEL.IMAGE_SIZE)
        found |= {m._spatial_rows for m in model.modules() if isinstance(m, (Resize, Reorg))}
    return sorted(found, key=lambda g: (type(g).__name__, g.height, g.out_height))


LAYER_GEOMETRIES = _layer_geometries()


def _layer_id(g):
    kind = "resize" if isinstance(g, spatial.WindowGeometry) else "reorg"
    return f"{kind}-{g.height}-{g.out_height}"


def test_the_four_models_hold_every_new_geometry():
    assert [_layer_id(g) for g in LAYER_GEOMETRIES] == [
        "reorg-26-13", "resize-10-38", "resize-13-26", "resize-19-38", "resize-26-52",
        "resize-38-10", "resize-38-38"]  # FSSD's first source: its rows stay as they are


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("geom", LAYER_GEOMETRIES, ids=_layer_id)
def test_new_layer_row_fetch_equals_the_whole_map(geom, size):
    """(d): each rank's output rows of the banded resize or reorg against the
    layer on the whole map, bit for bit in float32 and bf16; its input rows'
    gradient (the fetched rows' gradients sent back and added) against the
    whole map's, in float32."""
    torch.manual_seed(0)
    width = 7
    if isinstance(geom, spatial.WindowGeometry):
        op, out_w = Resize(), 11
        run = lambda m, x, rows: m(x, (rows, out_w))  # noqa: E731
    else:
        op, out_w = Reorg(2), width // 2
        width = 2 * out_w
        run = lambda m, x, rows: m(x)  # noqa: E731
    x = torch.randn(2, 3, geom.height, width)
    whole = {dt: run(op, x.to(dt), geom.out_height) for dt in (torch.float32, torch.bfloat16)}
    xg = x.clone().requires_grad_()
    probe = torch.randn_like(whole[torch.float32])
    (run(op, xg, geom.out_height) * probe).sum().backward()
    assert whole[torch.float32].shape[2] == geom.out_height
    assert spatial.partition_layer(op, geom.height, geom.out_height) == geom
    ins, outs = (spatial.row_split(n, size) for n in (geom.height, geom.out_height))

    def body(plan):
        a, b = ins[plan.index]
        o0, o1 = outs[plan.index]
        got = {}
        with spatial.active(plan):
            for dt in (torch.bfloat16, torch.float32):
                xs = x[:, :, a:b].to(dt).clone().requires_grad_(dt == torch.float32)
                got[dt] = (run(op, xs, o1 - o0), xs)
        y, xs = got[torch.float32]
        (y * probe[:, :, o0:o1]).sum().backward()
        return {dt: y.detach() for dt, (y, _) in got.items()}, xs.grad

    results = on_threads(size, body)
    for dt, want in whole.items():
        assert torch.equal(torch.cat([r[dt] for r, _ in results], 2), want.detach()), dt
    grad = torch.cat([g for _, g in results], 2)
    err = float((grad - xg.grad).abs().max() / xg.grad.abs().max())
    print(f"{_layer_id(geom)} S={size}: input gradient {err:.2e} of its largest element")
    assert err <= (GRAD_TOL if isinstance(geom, spatial.WindowGeometry) else 0.0)
    assert torch.equal(run(op, x, geom.out_height), whole[torch.float32])  # outside: plain


def test_resize_target_from_another_split_raises():
    """A banded resize asked for a row count other than its band of the
    output (a target taken from a map split otherwise) raises."""
    op = Resize()
    spatial.partition_layer(op, 13, 26)

    def body(plan):
        with spatial.active(plan):
            with pytest.raises(ValueError, match="band of the 26-row output holds 13 rows"):
                op(torch.zeros(1, 1, 7 - plan.index, 5), (12, 10))
        return True

    assert on_threads(2, body) == [True, True]


# -- (e): every FSSD and YOLO yml partitions -----------------------------------------

YMLS = sorted(f for f in os.listdir(os.path.join(REPO, "experiments", "cfgs"))
              if f.startswith(("fssd", "yolo")))


def test_nine_fssd_and_yolo_ymls():
    assert len(YMLS) == 9


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("yml", YMLS)
def test_yml_partitions_on_the_spatial_axis(yml, size):
    """(e): the yml's model on the ``meta`` device (no weight is made)
    partitions at its own image size; every resize and reorg has a route on
    each of the ``size`` ranks that covers the rows its outputs read, and
    the predictors gather."""
    cfg = cfg_from_file(os.path.join(REPO, "experiments", "cfgs", yml))
    cfg.TPU.MESH.SPATIAL = size
    spatial.check_model(cfg.MODEL, size)
    model = create_model(cfg.MODEL)[0]  # on the meta device
    names = list(model.state_dict())
    assert spatial.partition(model, cfg.MODEL.IMAGE_SIZE) > 0
    assert list(model.state_dict()) == names
    new = [m for m in model.modules() if isinstance(m, (Resize, Reorg))]
    assert new and all(hasattr(m, "_spatial_rows") for m in new)
    for m in new:
        g = m._spatial_rows
        outs = spatial.row_split(g.out_height, size)
        for index in range(size):
            r = spatial.route(g, size, index)
            got = sum(e - s for _, s, e in r.pieces)
            if outs[index][0] < outs[index][1]:
                lo, hi = g.reads(*outs[index])
                assert r.top + got + r.bottom == hi - lo
    heads = spatial.predictors(model)
    assert all([c for c in p.modules() if isinstance(c, torch.nn.Conv2d)][-1]._spatial_gather
               for p in heads)


# -- (f): the train CLI under torch.distributed.run ------------------------------------


def test_train_cli_trains_yolo_v3_on_two_bands_then_one_process_test(tmp_path):
    """The port's train CLI (``python -m ssds_tpu_torch.train``; YOLOv3 over
    MobileNetV1-0.25 at 64 px) on 1 x 2 gloo ranks for one epoch with its
    eval: rc 0, one manifest line; then one process loads the checkpoint,
    and its ``test_model`` scores the mAP the ranks' eval printed."""
    cfg_path, exp = _write_cfg(tmp_path, "yolo_v3", epochs=1)
    with open(cfg_path, "a") as f:
        f.write("TPU: {MESH: {DATA: -1, SPATIAL: 2}}\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_addr", "localhost", "--master_port", str(free_port()),
         "-m", "ssds_tpu_torch.train", "--cfg", cfg_path, "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(exp, "checkpoint_list.txt")) as f:
        assert [ln for ln in f.read().splitlines() if ln.strip()] == ["epoch 1:yolo_epoch_1.pth"]
    cfg = cfg_from_file(cfg_path)
    cfg.TPU.MESH.SPATIAL = 1  # one process, whole images
    solver = Solver(cfg, device="cpu")
    try:
        single = solver.test_model()
    finally:
        solver.close()
    assert f"mAP={single:.4f}" in proc.stdout, proc.stdout[-2000:]
