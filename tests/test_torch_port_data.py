"""The port's data pipeline and VOC eval against the JAX package's copies.

The port keeps its own copies of ``ssds_tpu/data/{augment,voc,voc_eval,
factory}.py`` (the machine with the card has no jax, so the port imports
nothing of ``ssds_tpu``). These tests hold each copy against its original on
the same inputs: batches, padding, shards and truncation counts equal;
preprocessed images and targets bit-equal, on the eval path and, under the
same ``random`` / ``np.random`` seeds, on the train path (both packages with
their native crop samplers, which run the same C++ on the same seeds, and
both with the sampler switched off, running the same Python loop); per-class
AP and mAP equal on a synthetic VOC tree.
"""

import contextlib
import os
import random
import threading
from unittest import mock

import numpy as np
import pytest

from ssds_tpu.data import augment as jax_augment
from ssds_tpu.data import factory as jax_factory
from ssds_tpu.data import native as jax_native
from ssds_tpu.data import voc as jax_voc
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.data import augment, factory, native, voc
from ssds_tpu_torch.data.voc_eval import voc_ap
from ssds_tpu_torch.tools import synth_voc
from test_multiclass_map_cli import make_multiclass_voc


class _Samples:
    """A map-style dataset of (4x4 uint8 image, targets, (h, w)); image i's
    first pixel holds i, and some images carry more GT than MAX_GT or none."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            img = np.full((4, 4, 3), i % 256, np.uint8)
            k = int(rng.integers(0, 7))
            if k == 0:
                t = np.zeros((1, 5), np.float32)  # preproc's "no GT" sentinel
            else:
                t = np.hstack([rng.uniform(0, 1, (k, 4)), rng.integers(0, 20, (k, 1))])
            self.items.append((img, t.astype(np.float32), (100 + i, 200 + i)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        out.append([{k: v.copy() for k, v in b.items()} for b in loader])
        out.append((loader.gt_dropped_last_epoch, loader.gt_max_seen))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
            continue
        assert len(g) == len(w)
        for bg, bw in zip(g, w):
            assert sorted(bg) == sorted(bw)
            for k in bw:
                assert bg[k].dtype == bw[k].dtype, k
                np.testing.assert_array_equal(bg[k], bw[k], err_msg=k)


def test_detection_collate_and_truncation_equal_jax():
    ds = _Samples(9, seed=1)
    samples = [ds[i] for i in range(9)]
    for max_gt in (1, 3, 8):
        got = factory.detection_collate(samples, max_gt)
        want = jax_factory.detection_collate(samples, max_gt)
        _assert_same([[got]], [[want]])
        assert factory.truncation_stats(samples, max_gt) == \
            jax_factory.truncation_stats(samples, max_gt)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=True, drop_last=True),     # train
    dict(batch_size=4, shuffle=False, drop_last=False),   # eval: the last batch wraps
    dict(batch_size=8, shuffle=False, drop_last=False),   # a remainder under half a batch
    dict(batch_size=3, shuffle=True, drop_last=True, shard_id=1, num_shards=2),
], ids=["train", "eval", "eval_wrap_twice", "shard"])
@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax(kw, workers):
    ds = _Samples(13)
    ours = factory.DetectionLoader(ds, max_gt=3, num_workers=workers, seed=5, **kw)
    theirs = jax_factory.DetectionLoader(ds, max_gt=3, num_workers=0, seed=5, **kw)
    try:
        assert len(ours) == len(theirs)
        _assert_same(_batches(ours), _batches(theirs))
    finally:
        ours.close()
    assert ours._pool is None


class _BigSamples:
    """Batches of ~2 MB, more than a pipe holds: a worker writing one blocks
    until the pool reads it."""

    def __len__(self):
        return 64

    def __getitem__(self, i):
        return np.full((300, 300, 3), i, np.uint8), np.array([[1, 1, 5, 5, 1]], np.float32)


def test_a_partly_read_loader_closes():
    """A loader with workers read for one batch, then closed (as a caller
    that takes one batch does), ends its workers: ``Pool.terminate`` with a
    batch still being written into the result pipe deadlocked (``chip_smoke.py``
    phase 16b, which takes one batch, hung there; on the CPU 1 ``close`` in
    a few dozen did). Each ``close`` gets 60 s in a thread."""
    for _ in range(12):
        loader = factory.DetectionLoader(_BigSamples(), batch_size=8, max_gt=4, shuffle=True,
                                         drop_last=True, num_workers=4)
        first = next(iter(loader))
        assert first["images"].shape == (8, 300, 300, 3)
        closing = threading.Thread(target=loader.close, daemon=True)
        closing.start()
        closing.join(60)
        assert not closing.is_alive(), "DetectionLoader.close hung"
        assert loader._pool is None and not loader._inflight


def test_loader_warns_once_on_truncation(capsys):
    ds = _Samples(13)
    loader = factory.DetectionLoader(ds, batch_size=4, max_gt=2, shuffle=False,
                                     drop_last=False, num_workers=0)
    list(loader)
    list(loader)
    err = capsys.readouterr().err
    assert err.count("DATASET.MAX_GT=2 dropped") == 1


def test_eval_preproc_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    for hw in ((120, 160), (64, 64), (300, 299)):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        t = np.array([[5, 6, 50, 40, 3], [10, 12, 60, 63, 7]], np.float32)
        for targets in (t, np.zeros((0, 5), np.float32)):
            got = augment.preproc((64, 64), (104, 117, 123), -1)(img, targets)
            want = jax_augment.preproc((64, 64), (104, 117, 123), -1)(img, targets)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(augment.preproc_for_test(img, (64, 64), (104, 117, 123)),
                                      jax_augment.preproc_for_test(img, (64, 64), (104, 117, 123)))


@pytest.mark.parametrize("sampler", ["python_loop", "native"])
@pytest.mark.parametrize("size", [(96, 96), (300, 300)])
def test_train_preproc_bit_equal_to_jax_under_the_same_seeds(size, sampler):
    rng = np.random.default_rng(1)
    cases = []
    for _ in range(40):
        h, w = int(rng.integers(80, 200)), int(rng.integers(80, 200))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(0, 4))
        xy = rng.uniform(0, 0.6, (k, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.4, (k, 2)) * (w, h)
        cases.append((img, np.hstack([xy, xy + wh, rng.integers(0, 20, (k, 1))]).astype(np.float32)))

    def run(pre):
        random.seed(7)
        np.random.seed(7)
        return [pre(img, t) for img, t in cases]

    with contextlib.ExitStack() as stack:
        if sampler == "python_loop":
            stack.enter_context(mock.patch.object(jax_native, "available", lambda: False))
            stack.enter_context(mock.patch.object(native, "available", lambda: False))
        else:
            assert jax_native.available()
        launches = native.launches
        want = run(jax_augment.preproc(size, (104, 117, 123), 0.6))
        got = run(augment.preproc(size, (104, 117, 123), 0.6))
    assert (native.launches > launches) == (sampler == "native")
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi.shape == (*size, 3) and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)


def test_expand_equal_to_jax_under_the_same_seed():
    img = np.random.default_rng(2).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    boxes = np.array([[5, 6, 30, 40], [20, 10, 60, 45]], np.float32)
    for s in range(5):
        random.seed(s)
        want = jax_augment._expand(img, boxes, (104, 117, 123), 0.9)
        random.seed(s)
        got = augment._expand(img, boxes, (104, 117, 123), 0.9)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc") / "VOCdevkit")
    make_multiclass_voc(root, n_images=12, seed=3)
    return root


def test_voc_dataset_equal_to_jax(voc_tree):
    sets = [["2007", "test"]]
    ours = voc.VOCDetection(voc_tree, sets, preproc=augment.preproc((64, 64), (104, 117, 123), -1))
    theirs = jax_voc.VOCDetection(voc_tree, sets,
                                  preproc=jax_augment.preproc((64, 64), (104, 117, 123), -1))
    assert ours.ids == theirs.ids and len(ours) == 12
    for i in range(len(ours)):
        for g, w in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(ours.pull_image(i), theirs.pull_image(i))
        assert ours.pull_anno(i)[0] == theirs.pull_anno(i)[0]
        np.testing.assert_array_equal(ours.pull_anno(i)[1], theirs.pull_anno(i)[1])


def test_evaluate_detections_map_equal_to_jax(voc_tree, tmp_path):
    sets = [["2007", "test"]]
    ours = voc.VOCDetection(voc_tree, sets)
    theirs = jax_voc.VOCDetection(voc_tree, sets)
    rng = np.random.default_rng(4)
    n = len(ours)
    all_boxes = [[[] for _ in range(n)] for _ in range(21)]
    for i in range(n):
        gt = ours.pull_anno(i)[1]
        for x1, y1, x2, y2, label in gt:  # the GT, jittered, plus false positives
            jit = rng.normal(0, 6, 4)
            all_boxes[int(label) + 1][i].append([x1 + jit[0], y1 + jit[1], x2 + jit[2], y2 + jit[3],
                                                 rng.uniform(0.2, 1.0)])
        for _ in range(2):
            x, y = rng.uniform(0, 150, 2)
            all_boxes[int(rng.integers(1, 6))][i].append([x, y, x + 30, y + 30,
                                                          rng.uniform(0, 0.6)])
    all_boxes = [[np.asarray(b, np.float32) for b in cls] for cls in all_boxes]
    got = ours.evaluate_detections(all_boxes, str(tmp_path / "ours"))
    want = theirs.evaluate_detections(all_boxes, str(tmp_path / "theirs"))
    assert 0.0 < got < 1.0
    assert got == want
    for cls in voc.VOC_CLASSES[:5]:
        name = f"results/det_test_{cls}.txt"
        with open(tmp_path / "ours" / name) as f, open(tmp_path / "theirs" / name) as g:
            assert f.read() == g.read()


def test_voc_ap_both_metrics():
    rec = np.array([0.1, 0.4, 0.4, 0.8])
    prec = np.array([1.0, 0.8, 0.6, 0.5])
    assert voc_ap(rec, prec, True) == pytest.approx((1 + 1 + 0.8 * 3 + 0.5 * 4) / 11)
    assert voc_ap(rec, prec, False) == pytest.approx(0.1 * 1 + 0.3 * 0.8 + 0.4 * 0.5)


def test_synthetic_voc_in_memory(tmp_path):
    """The card's data: annotations on disk, images drawn from the seed; the
    drawn boxes are the annotated ones, through the real VOC path."""
    root = str(tmp_path / "VOCdevkit")
    synth_voc.write_voc(root, seed=3, n_trainval=4, n_test=2, size=64)
    dcfg = default_config().DATASET
    dcfg.DATASET_DIR, dcfg.PROB, dcfg.NUM_WORKERS = root, -1, 0
    dcfg.TRAIN_SETS, dcfg.TEST_SETS = [["2007", "trainval"]], [["2007", "test"]]
    with mock.patch.dict(factory.dataset_map, {"voc": synth_voc.in_memory_voc(3, 64)}):
        loader = factory.load_data(dcfg, "test", image_size=(64, 64), batch_size=2)
    assert len(loader.dataset) == 2
    for i in range(2):
        img, target, hw = loader.dataset[i]
        want_img, objects = synth_voc.sample(3, 4 + i, 64)
        np.testing.assert_array_equal(img, want_img)
        assert hw == (64, 64) and len(target) == len(objects)
        for row, (name, x1, y1, x2, y2) in zip(target, objects):
            assert voc.VOC_CLASSES[int(row[4])] == name
            np.testing.assert_allclose(row[:4] * 64, [x1 - 1, y1 - 1, x2 - 1, y2 - 1])
        # the box drawn last lies on top: filled with its class colour
        _, x1, y1, x2, y2 = objects[-1]
        assert (img[y1 - 1:y2, x1 - 1:x2] == synth_voc.CLASS_COLOURS[int(target[-1, 4])]).all()
