"""``ssds_tpu_torch.utils.visualize`` against ``ssds_tpu.utils.visualize``, and
the port's ``Solver.visualize_epoch`` against the JAX package's.

Every function, given the same inputs, writes the same images, tags and
histograms as the JAX package's, bit for bit, through recording writers on
both sides. The two shapes the JAX package draws with OpenCV are drawn in
numpy by the port (the card's machine has no OpenCV): the rectangle
(thickness 1) and the filled radius-1 circle equal ``cv2``'s pixel for pixel
over boxes on, across and beyond the image's edges. ``visualize_epoch`` on the
tiny SSDLite of ``tests/test_solver_e2e.py`` writes the JAX Solver's tags:
its images, and one gradient histogram a parameter, the parameters named
through the weight bridge (``ssds_tpu_torch.weights.port_name``).
"""

import cv2
import numpy as np
import pytest

import ssds_tpu.utils.visualize as jviz
import ssds_tpu_torch.utils.visualize as tviz
from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.solver import Solver as JaxSolver
from ssds_tpu_torch.config import cfg_from_file, default_config
from ssds_tpu_torch.models.builder import create_model, create_priors
from ssds_tpu_torch.ops.anchors import num_anchors_per_cell
from ssds_tpu_torch.solver import Solver
from ssds_tpu_torch.weights import port_name
from test_solver_e2e import CFG_TEMPLATE, make_voc
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401


class Recorder:
    """A summary writer that keeps every image and histogram, in order."""

    def __init__(self):
        self.items = []

    def add_image(self, tag, img, step):
        self.items.append(("image", tag, np.array(img), step))

    def add_histogram(self, tag, values, step):
        self.items.append(("histogram", tag, np.array(values), step))

    def add_scalar(self, tag, value, step):
        pass


def _same(a, b):
    assert [i[:2] + (i[3],) for i in a.items] == [i[:2] + (i[3],) for i in b.items]
    for x, y in zip(a.items, b.items):
        assert x[2].dtype == y[2].dtype and np.array_equal(x[2], y[2]), x[1]


@pytest.mark.parametrize("hw", [(1, 1), (5, 9), (12, 7)])
def test_numpy_rectangle_and_dot_equal_cv2(hw):
    """Every corner pair in a window reaching 4 pixels past each edge, and
    every centre in it, on a random image, against ``cv2``."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w)
    xs, ys = range(-4, w + 4), range(-4, h + 4)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    color = (255, 160, 7)
    for x0 in xs:
        for y0 in ys:
            a, b = base.copy(), base.copy()
            cv2.circle(a, (x0, y0), 1, color, -1)
            tviz.dot(b, (x0, y0), color)
            assert np.array_equal(a, b), ("dot", x0, y0)
            for x1 in xs[::2]:
                for y1 in ys[::3]:
                    a, b = base.copy(), base.copy()
                    cv2.rectangle(a, (x0, y0), (x1, y1), color, 1)
                    tviz.rectangle(b, (x0, y0), (x1, y1), color)
                    assert np.array_equal(a, b), ("rectangle", x0, y0, x1, y1)
    # far outside, and a float image
    for p1, p2 in (((-1000, -5), (2000, 3)), ((-9, -9), (-2, -3)), ((w + 3, 0), (w + 9, h))):
        a, b = base.astype(np.float32), base.astype(np.float32)
        cv2.rectangle(a, p1, p2, color, 1)
        tviz.rectangle(b, p1, p2, color)
        assert np.array_equal(a, b), (p1, p2)


def _priors_and_shapes():
    """The tiny SSDLite's priors, feature maps and anchors a cell."""
    cfg = default_config()
    cfg.MODEL.update(SSDS="ssd_lite", NETS="mobilenet_v1_025", IMAGE_SIZE=[96, 96],
                     FEATURE_LAYER=[[11, 13], [128, 256]], ASPECT_RATIOS=[[2], [2, 3]],
                     SIZES=[0.3, 0.6, 0.9])
    fmaps = create_model(cfg.MODEL)[1]
    return (create_priors(cfg.MODEL, fmaps), fmaps,
            num_anchors_per_cell(tuple(tuple(a) for a in cfg.MODEL.ASPECT_RATIOS)))


def test_functions_equal_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    boxes = np.concatenate([rng.uniform(-0.2, 0.7, (9, 2)), rng.uniform(0.3, 1.3, (9, 2))], 1)
    assert np.array_equal(tviz.draw_boxes(img, boxes), jviz.draw_boxes(img, boxes))
    assert np.array_equal(tviz.draw_boxes(img.astype(np.float32) - 100, boxes, (1, 2, 3)),
                          jviz.draw_boxes(img.astype(np.float32) - 100, boxes, (1, 2, 3)))

    priors, fmaps, per_cell = _priors_and_shapes()
    assert tviz.level_slices(fmaps, per_cell) == jviz.level_slices(fmaps, per_cell)
    a, b = Recorder(), Recorder()
    for viz, rec in ((tviz, a), (jviz, b)):
        viz.viz_prior_box(rec, priors, (96, 96), 3, feature_maps=fmaps, anchors_per_cell=per_cell)
        viz.viz_prior_box(rec, priors, (96, 80), 4)
        batches = [{"images": rng_images(s), "boxes": rng_boxes(s), "valid": rng_valid(s)}
                   for s in range(2)]
        viz.viz_samples(rec, batches, 5, max_images=3)
        maps = [np.random.default_rng(7).normal(size=(2, s, s, c)).astype(np.float32)
                for s, c in ((12, 70), (6, 3), (1, 5))]
        maps.append(np.zeros((1, 2, 2, 4), np.float32))  # a constant map
        viz.viz_feature_maps(rec, maps, 6)
        viz.viz_grads(rec, {("base", "0", "weight"): maps[1][0], ("conf", "bias"): maps[2]}, 7)
    assert len(a.items) == 4 + 3 + 8 + 2  # priors (3 + 1), samples, maps, gradients
    _same(a, b)


def rng_images(seed):
    return np.random.default_rng(seed).integers(0, 256, (4, 24, 32, 3), dtype=np.uint8)


def rng_boxes(seed):
    r = np.random.default_rng(seed + 10)
    return np.concatenate([r.uniform(0, 0.5, (4, 3, 2)), r.uniform(0.5, 1.1, (4, 3, 2))], 2)


def rng_valid(seed):
    return np.random.default_rng(seed + 20).uniform(size=(4, 3)) < 0.7


def test_visualize_epoch_writes_jax_tags(tmp_path):
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    make_voc(root, n_images=8)
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        f.write(CFG_TEMPLATE.format(root=root, exp=exp, epochs=1, ckpt_epochs=1, prob=-1)
                # inline loading: no fork of a process that runs JAX's threads
                .replace("NUM_WORKERS: 2", "NUM_WORKERS: 0"))
    jcfg, tcfg = jax_cfg_from_file(path), cfg_from_file(path)
    jsolver = JaxSolver(jcfg)
    jsolver.writer = want = Recorder()
    jsolver.visualize_epoch(2)
    got = Recorder()
    solver = Solver(tcfg, device="cpu", writer=got)
    try:
        solver.visualize_epoch(2)
    finally:
        solver.close()
    images = [i for i in got.items if i[0] == "image"]
    assert [i[1] for i in images] == [i[1] for i in want.items if i[0] == "image"]
    # the priors and the samples are the same pixels (the feature maps come
    # from each package's own random weights)
    for x, y in zip(images, want.items):
        if x[1].startswith(("priors/", "samples/")):
            assert np.array_equal(x[2], y[2]), x[1]
    net = tcfg.MODEL.NETS
    want_hist = sorted(
        "grads/" + port_name(i[1][len("grads/"):], net, ssds=tcfg.MODEL.SSDS).replace(".", "/")
        for i in want.items if i[0] == "histogram")
    got_hist = sorted(i[1] for i in got.items if i[0] == "histogram")
    assert got_hist == want_hist
    n_params = len(list(solver.model.parameters()))
    assert len(got_hist) == n_params and all(i[3] == 2 for i in got.items)
