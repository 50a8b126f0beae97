"""Serving export in the port (``ssds_tpu_torch.export``) against the
in-process detector and against the JAX package's artifact.

Models: the JAX export test's tiny SSDLite over ``mobilenet_v1_025`` at 96
px and its tiny YOLOv3 at 64 px (``tests/test_export.py``), float32, and an
FSSD-lite at 96 px in bf16 (its float32 tail after the fusion BN). The
SSDLite's ``PRE_NMS_TOP_N`` is 16 of its 180 priors, so that the
class-agnostic prune, which eager serving takes at a batch of 4 or more,
changes the rows at batch 5.

Checked: a symbolic-batch artifact reloads and serves batches 1, 3 and 5,
never traced, with rows identical to the in-process detector's unpruned
rows (the JAX package's rule for a symbolic batch, ``_static_ge``), and
within the tolerance of ``tests/test_torch_port_detector.py`` (atol 1e-5 on
scores and normalised boxes, rows matched per image and class as sets) of
the JAX package's ``export_detector`` / ``load_exported`` rows for the same
weights, carried by the bridge; a fixed-batch artifact (batch 5 keeps the
prune, as eager serving does) and ``export.json``; the loader and the
export CLI in fresh processes, the loader importing no model module, the
CLI's ``--check`` passing on what it wrote (symbolic and fixed batch) and
``check_exported`` failing on another seed's artifact; the
NMS operator's fake implementation; and the eager path calling the wrapper
while only an export traces the operator, with the same rows either way.

Moving and sharding (``platforms``, ``load_exported(device=)``,
``load_exported_sharded``): ``platforms`` is recorded in ``export.json`` and
checked; a CPU program moved to ``meta`` keeps no tensor and no node on the
CPU; a program loaded with ``device="cpu"`` serves the in-process rows; and
``load_exported_sharded`` over ``["cpu", "cpu"]`` serves the single
program's rows bit for bit at batches 3 and 4 (split 1 + 2 and 2 + 2), for
the float program and an int8 one. The move from the card to the CPU is a
card test (``tests/test_torch_port_cuda.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.detector import ObjectDetector as JaxDetector
from ssds_tpu.export import export_detector as jax_export_detector
from ssds_tpu.export import load_exported as jax_load_exported
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.detector import ObjectDetector, Predict
from ssds_tpu_torch.export import (
    _devices_in,
    check_exported,
    export_detector,
    load_exported,
    load_exported_sharded,
    move_program,
)
from ssds_tpu_torch.ops import postprocess
from ssds_tpu_torch.ops.cuda import nms as cuda_nms
from ssds_tpu_torch.weights import state_dict_from_jax
from test_torch_port_detector import _assert_same_row_sets
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
BATCHES = (1, 3, 5)
KEYS = {"ssds", "nets", "image_size", "num_classes", "batch", "device", "platforms", "input",
        "output"}


def _ssd_lite(cfg):
    cfg.MODEL.update(SSDS="ssd_lite", NETS="mobilenet_v1_025", IMAGE_SIZE=[96, 96], NUM_CLASSES=4,
                     FEATURE_LAYER=[[11, 13], [128, 256]], ASPECT_RATIOS=[[2], [2]],
                     SIZES=[0.3, 0.6, 0.9], HALF_PRECISION=False)
    cfg.POST_PROCESS.update(NUM_CLASSES=4, MAX_DETECTIONS=10, PRE_NMS_TOP_N=16)
    return cfg


def _yolo_v3(cfg):
    cfg.MODEL.update(SSDS="yolo_v3", NETS="mobilenet_v1_025", IMAGE_SIZE=[64, 64], NUM_CLASSES=3,
                     FEATURE_LAYER=[[5, 11, 13], [64, 128, 256]], ASPECT_RATIOS=[[2], [2], [2]],
                     ANCHORS=[[[8, 8]], [[24, 24]], [[48, 48]]], HALF_PRECISION=False)
    cfg.POST_PROCESS.update(NUM_CLASSES=4, MAX_DETECTIONS=10)
    return cfg


def _fssd_lite(cfg):
    cfg.MODEL.update(SSDS="fssd_lite", NETS="mobilenet_v1_025", IMAGE_SIZE=[96, 96], NUM_CLASSES=4,
                     FEATURE_LAYER=[[[5, 11, 13], [64, 128, 256]],
                                    [["", "S", "S"], [128, 128, 128]]],
                     ASPECT_RATIOS=[[2], [2, 3], [2]], SIZES=[0.2, 0.5, 0.8, 0.95],
                     HALF_PRECISION=True)
    cfg.POST_PROCESS.update(NUM_CLASSES=4, MAX_DETECTIONS=10)
    return cfg


MODELS = {"ssd_lite": _ssd_lite, "yolo_v3": _yolo_v3, "fssd_lite": _fssd_lite}


class _Pairs(dict):
    """``pairs[model]``: ``(JAX detector, port detector)``, the port's on the
    JAX detector's seeded variables through the bridge and
    ``RESUME_CHECKPOINT``; each made when first asked for."""

    def __init__(self, tmp_path_factory):
        super().__init__()
        self.tmp = tmp_path_factory

    def __missing__(self, name):
        jcfg = MODELS[name](jax_default_config())
        jdet = JaxDetector(jcfg)
        pth = self.tmp.mktemp(name) / "weights.pth"
        torch.save(state_dict_from_jax(jdet.variables, net=jcfg.MODEL.NETS, ssds=jcfg.MODEL.SSDS,
                                       feature_layer=jcfg.MODEL.FEATURE_LAYER), pth)
        cfg = MODELS[name](default_config())
        cfg.RESUME_CHECKPOINT = str(pth)
        self[name] = (jdet, ObjectDetector(cfg, device="cpu"))
        return self[name]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return _Pairs(tmp_path_factory)


def _images(seed, b, det):
    return np.random.default_rng(seed).integers(0, 256, (b, *det.img_hw, 3), dtype=np.uint8)


def _unpruned(det):
    """The detector's predict function with the class-agnostic prune off."""
    return Predict(det.model, det.means, det.priors,
                   dataclasses.replace(det.post, pre_nms_top_n=0), det.dtype)


@pytest.mark.parametrize("name", list(MODELS))
def test_symbolic_batch_round_trip(pairs, name, tmp_path):
    det = pairs[name][1]
    out = export_detector(det, str(tmp_path / "served"))
    assert sorted(os.listdir(out)) == ["export.json", "predict.pt2"]
    predict, meta = load_exported(out)
    assert set(meta) == KEYS and meta["batch"] == "symbolic" and meta["device"] == "cpu"
    assert meta["image_size"] == list(det.img_hw) and meta["ssds"] == name
    unpruned = _unpruned(det)
    for b in BATCHES:
        x = torch.from_numpy(_images(b, b, det))
        served = predict(x)
        with torch.no_grad():
            want = unpruned(x)
        assert served.shape == (b, want.shape[1], 10, 5) and served.dtype == torch.float32
        assert torch.equal(served, want), (name, b)


def test_symbolic_batch_takes_no_prune_and_fixed_batch_keeps_it(pairs, tmp_path):
    """At batch 5 eager serving prunes to 16 candidates, which changes the
    rows; the symbolic artifact does not prune, a batch-5 artifact does."""
    det = pairs["ssd_lite"][1]
    x = torch.from_numpy(_images(7, 5, det))
    with torch.no_grad():
        pruned, unpruned = det.predictor(x), _unpruned(det)(x)
    assert not torch.equal(pruned, unpruned)
    symbolic, _ = load_exported(export_detector(det, str(tmp_path / "symbolic")))
    assert torch.equal(symbolic(x), unpruned)
    fixed_dir = export_detector(det, str(tmp_path / "fixed"), batch=5)
    with open(os.path.join(fixed_dir, "export.json")) as f:
        meta = json.load(f)
    assert set(meta) == KEYS and meta["batch"] == 5
    fixed, _ = load_exported(fixed_dir)
    assert torch.equal(fixed(x), pruned)


@pytest.mark.parametrize("name", ["ssd_lite", "yolo_v3"])
def test_exported_rows_equal_jax_exported_rows(pairs, name, tmp_path):
    jdet, det = pairs[name]
    predict, _ = load_exported(export_detector(det, str(tmp_path / "torch")))
    jpredict, jmeta = jax_load_exported(jax_export_detector(jdet, str(tmp_path / "jax")))
    assert jmeta["batch"] == "symbolic"
    for b in BATCHES:
        x = _images(10 + b, b, det)
        got = predict(torch.from_numpy(x)).numpy()
        want = np.asarray(jpredict(x))
        assert got.shape == want.shape
        for i in range(b):
            for c in range(got.shape[1]):
                _assert_same_row_sets(got[i, c], want[i, c], ATOL)


LOADER = r"""
import sys, numpy as np, torch
from ssds_tpu_torch.export import load_exported
predict, meta = load_exported(sys.argv[1])
h, w = meta["image_size"]
rows = predict(torch.zeros((2, h, w, 3), dtype=torch.uint8))
print(tuple(rows.shape))
print(sorted(m for m in sys.modules if m.startswith(("ssds_tpu_torch", "ssds_tpu.", "jax"))))
"""

CFG = """
MODEL:
  SSDS: ssd_lite
  NETS: mobilenet_v1_025
  IMAGE_SIZE: [96, 96]
  NUM_CLASSES: 4
  FEATURE_LAYER: [[11, 13], [128, 256]]
  ASPECT_RATIOS: [[2], [2]]
  SIZES: [0.3, 0.6, 0.9]
POST_PROCESS: {NUM_CLASSES: 4, MAX_DETECTIONS: 10}
"""


def test_cli_exports_and_the_loader_imports_no_model_module(tmp_path):
    """``python -m ssds_tpu_torch.export`` writes a symbolic-batch bf16
    artifact; a fresh process loads it with ``load_exported`` and serves it
    with only the registered operators' modules of the port imported (the
    NMS and, for a quantised artifact, the int8 pair)."""
    yml = tmp_path / "tiny.yml"
    yml.write_text(CFG)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = tmp_path / "served"
    proc = subprocess.run([sys.executable, "-m", "ssds_tpu_torch.export", "--cfg", str(yml),
                           "--out", str(out), "--device", "cpu"], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "export.json") as f:
        assert json.load(f)["batch"] == "symbolic"
    proc = subprocess.run([sys.executable, "-c", LOADER, str(out)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    shape, modules = proc.stdout.strip().splitlines()[-2:]
    assert shape == "(2, 4, 10, 5)"
    assert eval(modules) == ["ssds_tpu_torch", "ssds_tpu_torch.export", "ssds_tpu_torch.ops",
                             "ssds_tpu_torch.ops.boxes", "ssds_tpu_torch.ops.cuda",
                             "ssds_tpu_torch.ops.cuda.int8_conv", "ssds_tpu_torch.ops.cuda.nms",
                             "ssds_tpu_torch.ops.nms", "ssds_tpu_torch.ops.quant"]


@pytest.mark.parametrize("batch", [None, 5], ids=["symbolic", "batch5"])
def test_cli_check_in_a_fresh_process(batch, tmp_path):
    """``python -m ssds_tpu_torch.export --check`` reloads what it wrote and
    holds its rows equal to the in-process detector's (unpruned for the
    symbolic batch, pruned at a fixed batch of 5): rc 0 and ``check ok``."""
    yml = tmp_path / "tiny.yml"
    yml.write_text(CFG.replace("MAX_DETECTIONS: 10}", "MAX_DETECTIONS: 10, PRE_NMS_TOP_N: 16}"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "ssds_tpu_torch.export", "--cfg", str(yml),
                           "--out", str(tmp_path / "served"), "--device", "cpu", "--check"]
                          + ([] if batch is None else ["--batch", str(batch)]),
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    b = batch or 2
    assert f"check ok: served == in-process on ({b}, 4, 10, 5)" in proc.stdout, proc.stdout


def test_check_fails_on_another_seeds_artifact(pairs, tmp_path):
    """``check_exported`` passes on the detector's own artifact and raises
    ``AssertionError`` on one exported from another seed's weights."""
    det = pairs["ssd_lite"][1]
    own = export_detector(det, str(tmp_path / "own"))
    assert check_exported(det, own).startswith("check ok")
    other = ObjectDetector(_ssd_lite(default_config()), device="cpu", seed=1)
    with pytest.raises(AssertionError):
        check_exported(det, export_detector(other, str(tmp_path / "other")))


def test_nms_op_fake_implementation_and_cpu_kernel():
    """The fake implementation gives ``[M, N]`` bool without running either
    kernel; the CPU implementation is the plain version."""
    with FakeTensorMode():
        boxes, scores = torch.empty(21, 200, 4), torch.empty(21, 200)
        keep = torch.ops.ssds_tpu_torch.nms_mask(boxes, scores, 0.45)
        assert keep.shape == (21, 200) and keep.dtype == torch.bool
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 0.8, (6, 40, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (6, 40, 2))], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(-np.sort(-rng.uniform(0, 1, (6, 40)), axis=1).astype(np.float32))
    want = cuda_nms.nms_mask_torch(boxes, scores, 0.45)
    assert torch.equal(torch.ops.ssds_tpu_torch.nms_mask(boxes, scores, 0.45), want)
    torch.library.opcheck(torch.ops.ssds_tpu_torch.nms_mask.default, (boxes, scores, 0.45))


def test_eager_detect_calls_the_wrapper_and_export_traces_the_op(pairs):
    """Eager ``detect`` calls ``nms_mask`` directly; with the export flag
    set it calls the operator instead, and the rows are the same."""
    det = pairs["ssd_lite"][1]
    x = torch.from_numpy(_images(3, 3, det))
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return cuda_nms.nms_mask(*args)

    with torch.no_grad(), mock.patch.object(postprocess, "nms_mask", counted):
        eager = det.predictor(x)
        assert len(calls) == 1 and calls[0][0] == 3 * 4  # one batched call, B x C slots
        with mock.patch.object(torch.compiler, "is_exporting", lambda: True):
            through_op = det.predictor(x)
        assert len(calls) == 1
    assert torch.equal(eager, through_op)
    program = torch.export.export(det.predictor, (x,))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "ssds_tpu_torch.nms_mask.default" in targets


# -- platforms, moving and sharding -------------------------------------------


def test_platforms_are_recorded_and_checked(pairs, tmp_path):
    det = pairs["ssd_lite"][1]
    out = export_detector(det, str(tmp_path / "both"), platforms=("cuda", "cpu"))
    with open(os.path.join(out, "export.json")) as f:
        assert json.load(f)["platforms"] == ["cuda", "cpu"]
    _, meta = load_exported(export_detector(det, str(tmp_path / "default")))
    assert meta["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="platforms"):
        export_detector(det, str(tmp_path / "bad"), platforms=("tpu",))
    with pytest.raises(ValueError, match="exported for"):
        load_exported(str(tmp_path / "default"), device="meta")


@pytest.mark.parametrize("name", ["ssd_lite", "yolo_v3"])
def test_a_moved_program_keeps_nothing_on_the_old_device(pairs, name, tmp_path):
    det = pairs[name][1]
    out = export_detector(det, str(tmp_path / "served"))
    program = torch.export.load(os.path.join(out, "predict.pt2"))
    assert _devices_in(program) == {torch.device("cpu")}
    # the trace baked devices into nodes (arange, full, to) as well as the weights
    baked = [n for n in program.graph.nodes if "device" in n.kwargs]
    assert baked
    move_program(program, "meta")
    assert _devices_in(program) == {torch.device("meta")}
    assert all(torch.device(n.kwargs["device"]) == torch.device("meta") for n in baked)
    predict, meta = load_exported(out, device="cpu")
    x = torch.from_numpy(_images(4, 3, det))
    with torch.no_grad():
        assert torch.equal(predict(x), _unpruned(det)(x))
    assert meta["device"] == "cpu"


def _int8_detector():
    det = ObjectDetector(_ssd_lite(default_config()), device="cpu")
    det.quantize_int8()
    return det


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_sharded_rows_equal_one_program(pairs, kind, tmp_path):
    det = pairs["ssd_lite"][1] if kind == "float" else _int8_detector()
    out = export_detector(det, str(tmp_path / kind))
    single, _ = load_exported(out)
    sharded, meta = load_exported_sharded(out, ["cpu", "cpu"])
    assert meta["devices"] == ["cpu", "cpu"] and meta["device"] == "cpu"
    for b in (3, 4):
        x = torch.from_numpy(_images(10 + b, b, det))
        want = single(x)
        assert torch.equal(sharded(x), want), (kind, b)
    assert torch.equal(sharded(x[:1]), single(x[:1]))  # fewer images than devices
    fixed = export_detector(det, str(tmp_path / "fixed"), batch=4)
    with pytest.raises(ValueError, match="symbolic"):
        load_exported_sharded(fixed, ["cpu", "cpu"])
