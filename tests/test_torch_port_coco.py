"""The port's COCO path against the JAX package's.

``ssds_tpu_torch/data/{coco,coco_eval}.py`` are the port's copies of
``ssds_tpu/data/{coco,coco_eval}.py``. On a generated COCO tree
(``ssds_tpu_torch.tools.synth_coco``: COCO 2017's non-contiguous category
ids, crowds, annotations without ``area``, zero-width boxes, images without
annotations, images of 240-640 x 240-480 written as JPEG files so that both
packages decode the same bytes with OpenCV):

- the dataset's ids, targets, crowds, areas and ``img_info`` equal JAX's;
- ``evaluate_detections`` on the same detections gives JAX's AP exactly, all
  12 summary values within 1e-12 (measured: equal) and a byte-identical
  ``detections_results.json``;
- ``load_data(..., 'eval')`` gives JAX's batches bit for bit (the resize is
  the port's numpy, JAX's is OpenCV);
- ``test_model`` on a small SSDLite (MobileNetV1-0.25 at 96 px, 81 classes),
  the JAX solver's initial variables bridged by ``weights.state_dict_from_jax``,
  gives JAX's AP within ``AP_RTOL`` of it;
- ``ssd_lite_mobilenetv2_coco_config()`` equals its yml, and
  ``ssd_vgg16_train_coco.yml`` builds a port model.
"""

import json
import os
from unittest import mock

import cv2
import numpy as np
import pytest
import torch

from ssds_tpu import config as jax_config
from ssds_tpu.data import coco as jax_coco
from ssds_tpu.data import factory as jax_factory
from ssds_tpu.solver import Solver as JaxSolver
from ssds_tpu_torch import config
from ssds_tpu_torch.data import coco, coco_eval, factory
from ssds_tpu_torch.models.builder import create_model, create_priors
from ssds_tpu_torch.solver import Solver
from ssds_tpu_torch.tools import synth_coco
from ssds_tpu_torch.weights import state_dict_from_jax
from test_torch_port_import import _flat
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_model, JAX against the port, the same float32 weights on the CPU: the
# two forwards differ by float32 rounding (~1e-6), which can reorder detections
# whose scores tie to that level; relative to JAX's AP (an untrained model's,
# ~5e-5 here, so an absolute bound would pass an AP of 0); measured 0.0
AP_RTOL = 1e-3

SMALL_CFG = """
MODEL:
  SSDS: ssd_lite
  NETS: mobilenet_v1_025
  IMAGE_SIZE: [96, 96]
  NUM_CLASSES: 81
  FEATURE_LAYER: [[11, 13], [128, 256]]
  ASPECT_RATIOS: [[2, 3], [2, 3]]
  SIZES: [0.2, 0.55, 0.9]
  HALF_PRECISION: False
TEST: {{BATCH_SIZE: 8}}
POST_PROCESS: {{NUM_CLASSES: 81, SCORE_THRESHOLD: 0.01, IOU_THRESHOLD: 0.6, MAX_DETECTIONS: 20}}
DATASET:
  DATASET: coco
  DATASET_DIR: {root}
  TRAIN_SETS: [['2017', 'train']]
  TEST_SETS: [['2017', 'val']]
  NUM_WORKERS: 0
  MAX_GT: 128
EXP_DIR: {exp}
LOG_DIR: {exp}/logs
"""


@pytest.fixture(scope="module")
def coco_tree(tmp_path_factory):
    """8 train and 12 val images, annotations by ``synth_coco`` and the
    images as JPEG files."""
    root = str(tmp_path_factory.mktemp("coco"))
    synth_coco.write_coco(root, seed=5, n_train=8, n_val=12)
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, f"{split}2017"))
        with open(os.path.join(root, "annotations", f"instances_{split}2017.json")) as f:
            for img in json.load(f)["images"]:
                cv2.imwrite(os.path.join(root, f"{split}2017", img["file_name"]),
                            synth_coco.sample(5, img["id"])[0])
    return root


def test_synthetic_tree_has_what_coco_asks_for(coco_tree):
    with open(os.path.join(coco_tree, "annotations", "instances_val2017.json")) as f:
        data = json.load(f)
    anns = data["annotations"]
    assert len(data["categories"]) == 80 and max(c["id"] for c in data["categories"]) == 90
    assert any(a["iscrowd"] for a in anns) and any("area" not in a for a in anns)
    assert any(a["bbox"][2] == 0 for a in anns)
    annotated = {a["image_id"] for a in anns}
    assert any(img["id"] not in annotated for img in data["images"])
    assert len({(img["height"], img["width"]) for img in data["images"]}) == len(data["images"])


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_equals_jax(coco_tree, split):
    sets = [["2017", split]]
    ours = coco.COCODetection(coco_tree, sets)
    theirs = jax_coco.COCODetection(coco_tree, sets)
    assert ours.ids == theirs.ids
    assert ours.cat_ids == theirs.cat_ids and ours.classes == theirs.classes
    assert ours.cat_to_contiguous == theirs.cat_to_contiguous
    assert ours.img_info == theirs.img_info and ours.num_classes == theirs.num_classes == 80
    for table in ("annotations", "crowds", "crowd_areas", "gt_areas"):
        got, want = getattr(ours, table), getattr(theirs, table)
        assert sorted(got) == sorted(want)
        for iid in want:
            assert got[iid].dtype == want[iid].dtype, table
            np.testing.assert_array_equal(got[iid], want[iid], err_msg=f"{table} {iid}")
    for i in range(len(ours)):
        for g, w in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(ours.pull_image(i), theirs.pull_image(i))
        assert ours.pull_anno(i)[0] == theirs.pull_anno(i)[0]
        got, want = ours.pull_img_anno(i), theirs.pull_img_anno(i)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]


def _detections(ds, seed):
    """The GT jittered (and its crowds), false positives and a few dropped,
    as ``all_boxes[class][image]``."""
    rng = np.random.default_rng(seed)
    n = len(ds)
    all_boxes = [[[] for _ in range(n)] for _ in range(ds.num_classes + 1)]
    for i, (_, iid) in enumerate(ds.ids):
        gt = np.concatenate([ds.annotations[iid], ds.crowds[iid]])
        h, w = ds.img_info[iid]
        for x1, y1, x2, y2, label in gt:
            if rng.uniform() < 0.15:
                continue  # a miss
            jit = rng.normal(0, 0.06 * max(x2 - x1, y2 - y1), 4)
            all_boxes[int(label) + 1][i].append([x1 + jit[0], y1 + jit[1], x2 + jit[2],
                                                 y2 + jit[3], rng.uniform(0.3, 1.0)])
        for _ in range(int(rng.integers(0, 6))):
            x, y = rng.uniform(0, w - 20), rng.uniform(0, h - 20)
            s = rng.uniform(8, 150)
            all_boxes[int(rng.integers(1, 81))][i].append([x, y, x + s, y + s,
                                                           rng.uniform(0, 0.7)])
    return [[np.asarray(b, np.float32).reshape(-1, 5) for b in cls] for cls in all_boxes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_detections_equal_to_jax(coco_tree, tmp_path, capsys, seed):
    sets = [["2017", "val"]]
    ours, theirs = coco.COCODetection(coco_tree, sets), jax_coco.COCODetection(coco_tree, sets)
    all_boxes = _detections(ours, seed)
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "ours"))
    printed = capsys.readouterr().out.splitlines()
    jax_stats = []
    evaluate = jax_coco._coco_eval.evaluate
    with mock.patch.object(jax_coco._coco_eval, "evaluate",
                           lambda *a, **k: jax_stats.append(evaluate(*a, **k)) or jax_stats[-1]):
        want = theirs.evaluate_detections(all_boxes, str(tmp_path / "theirs"))
    assert 0.0 < got < 1.0
    assert got == want
    assert len(printed) == 12 and printed == capsys.readouterr().out.splitlines()
    assert sorted(ours.last_stats) == sorted(jax_stats[0])
    for key, value in jax_stats[0].items():
        assert abs(ours.last_stats[key] - value) <= 1e-12, key
    name = "detections_results.json"
    with open(tmp_path / "ours" / name, "rb") as f, open(tmp_path / "theirs" / name, "rb") as g:
        assert f.read() == g.read()


def test_coco_eval_fast_paths_equal_the_loops():
    """The port's two vectorised loops (no-GT pairs, the precision envelope)
    against the JAX module on many detections and few GT."""
    from ssds_tpu.data import coco_eval as jax_coco_eval

    rng = np.random.default_rng(9)
    gts, dts = {}, {}
    for iid in range(6):
        for c in range(4):
            if rng.uniform() < 0.5:
                b = rng.uniform(0, 200, (int(rng.integers(1, 4)), 2))
                boxes = np.hstack([b, b + rng.uniform(5, 120, b.shape)])
                crowd = rng.uniform(size=len(boxes)) < 0.2
                gts[(iid, c)] = (boxes, crowd, rng.uniform(100, 20000, len(boxes)))
            d = rng.uniform(0, 200, (int(rng.integers(0, 120)), 2))
            dts[(iid, c)] = np.hstack([d, d + rng.uniform(5, 120, d.shape),
                                       rng.uniform(0, 1, (len(d), 1))])
    got = coco_eval.evaluate(gts, dts, list(range(6)), list(range(4)))
    want = jax_coco_eval.evaluate(gts, dts, list(range(6)), list(range(4)))
    assert got == want and got.summary_lines() == want.summary_lines()


def _cfgs(root, exp):
    path = os.path.join(exp, "cfg.yml")
    os.makedirs(exp, exist_ok=True)
    with open(path, "w") as f:
        f.write(SMALL_CFG.format(root=root, exp=exp))
    return jax_config.cfg_from_file(path), config.cfg_from_file(path)


def test_load_data_eval_batches_equal_jax(coco_tree, tmp_path):
    jcfg, tcfg = _cfgs(coco_tree, str(tmp_path))
    ours = factory.load_data(tcfg.DATASET, "eval", image_size=(96, 96), batch_size=5)
    theirs = jax_factory.load_data(jcfg.DATASET, "eval", image_size=(96, 96), batch_size=5)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3  # 12 images, the last batch wrapped
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_test_model_ap_equals_jax(coco_tree, tmp_path, one_torch_thread):  # noqa: F811
    jcfg, tcfg = _cfgs(coco_tree, str(tmp_path / "exp"))
    js = JaxSolver(jcfg)
    want = js.test_model()
    pth = str(tmp_path / "jax_init.pth")
    torch.save(state_dict_from_jax({"params": js.params, "batch_stats": js.batch_stats},
                                   net=tcfg.MODEL.NETS), pth)
    tcfg.RESUME_CHECKPOINT = pth
    tcfg.EXP_DIR = str(tmp_path / "exp_port")
    ts = Solver(tcfg, device="cpu", seed=1)
    try:
        got = ts.test_model()
    finally:
        ts.close()
    print(f"COCO test_model AP: port {got!r}, JAX {want!r}")
    assert 0.0 < want <= 1.0
    assert abs(got - want) <= AP_RTOL * want


def test_written_out_coco_config_equals_its_yml():
    path = os.path.join(REPO, "experiments/cfgs/ssd_lite_mobilenetv2_train_coco.yml")
    assert _flat(config.ssd_lite_mobilenetv2_coco_config()) == _flat(config.cfg_from_file(path))


def test_vgg16_coco_yml_builds_a_port_model():
    from ssds_tpu.models import builder as jax_builder

    path = os.path.join(REPO, "experiments/cfgs/ssd_vgg16_train_coco.yml")
    cfg = config.cfg_from_file(path)
    model, fmaps = create_model(cfg.MODEL)
    priors = create_priors(cfg.MODEL, fmaps)
    jcfg = jax_config.cfg_from_file(path)
    _, jfmaps = jax_builder.create_model(jcfg.MODEL)
    np.testing.assert_array_equal(priors, jax_builder.create_priors(jcfg.MODEL, jfmaps))
    assert model.num_classes == 81 and priors.shape == (8732, 4)
    assert [c.out_channels for c in model.conf] == [n * 81 for n in (4, 6, 6, 6, 4, 4)]
