"""The serving slice as a whole: the port's ObjectDetector against the JAX one.

SSD-VGG16 (all 35 base layers at full width) at a 64x64 input with three
sources (conv4_3 8x8, conv7 4x4, one 'S' extra block 2x2: 376 priors), in
float32. The JAX detector's own seeded ``variables`` are written as a
``.pth`` through ``state_dict_from_jax`` and loaded by the port's detector
through ``RESUME_CHECKPOINT``, its real entry path. Images are uint8 from a
numpy seed.

Tolerance: ``atol = 1e-5`` on scores and on normalised box coordinates
(times the image size for pixel boxes). XLA's and PyTorch's CPU convolutions
sum in different orders; through the 15 convs of VGG16 and the heads ``loc``
ends up within ~3e-6 and the softmax within ~1e-6 (measured), and decode
scales ``loc`` by at most ``0.2 * exp(0.2 * loc)``.

Row order: two candidates of one class whose scores differ by less than
that noise may swap places in the dense rows, so rows are compared per
(image, class) as sets, matched one to one within the tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.detector import ObjectDetector as JaxDetector
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.weights import state_dict_from_jax

ATOL = 1e-5
HW = 64


def _small(cfg):
    cfg.MODEL.IMAGE_SIZE = [HW, HW]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    cfg.MODEL.HALF_PRECISION = False
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jdet = JaxDetector(_small(jax_default_config()))
    pth = tmp_path_factory.mktemp("weights") / "ssd_vgg16_64.pth"
    torch.save(state_dict_from_jax(jdet.variables), pth)
    cfg = _small(default_config())
    cfg.RESUME_CHECKPOINT = str(pth)
    return jdet, ObjectDetector(cfg, device="cpu")


def _images(seed, n, hw=(HW, HW)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _assert_same_row_sets(got, want, atol):
    """``[N, D]`` rows equal as sets: each matched once within ``atol``."""
    assert got.shape == want.shape, (got.shape, want.shape)
    free = np.ones(len(want), bool)
    for row in got:
        close = free & (np.abs(want - row) <= atol).all(-1)
        assert close.any(), f"no match for row {row}"
        free[np.argmax(close)] = False


def test_forward_equals_jax(pair):
    jdet, det = pair
    x = _images(0, 4)

    @jax.jit
    def jax_forward(variables, img):
        return jdet.model.apply(variables, img.astype(np.float32) - jdet._means, phase="eval")

    want_loc, want_conf = (np.asarray(a) for a in jax_forward(jdet.variables, x))
    got_loc, got_conf = (a.numpy() for a in det.forward(torch.from_numpy(x)))
    assert got_loc.shape == want_loc.shape == (4, 376, 4)
    assert got_conf.shape == want_conf.shape == (4, 376, 21)
    np.testing.assert_allclose(got_loc, want_loc, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_conf, want_conf, rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [1, 4])
def test_dense_rows_equal_jax(pair, batch):
    jdet, det = pair
    x = _images(batch, batch)
    want = np.asarray(jdet._predict(jdet.variables, x))
    got = det.detect_rows(x).numpy()
    assert got.shape == want.shape == (batch, 21, 100, 5)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0)
    for b in range(batch):
        for c in range(21):
            _assert_same_row_sets(got[b, c], want[b, c], ATOL)


def _rows(boxes, labels, scores):
    return np.concatenate([labels[:, None].astype(np.float32) * 10, scores[:, None], boxes], 1)


@pytest.mark.parametrize("hw", [(HW, HW), (80, 96)])  # (80, 96) is resized with cv2
def test_predict_equals_jax(pair, hw):
    jdet, det = pair
    img = _images(11, 1, hw)[0]
    want = jdet.predict(img, threshold=0.05)
    got = det.predict(img, threshold=0.05)
    assert len(got[0]) > 0
    _assert_same_row_sets(_rows(*got), _rows(*want), ATOL * max(hw))
    (_, _, _), times = det.predict(img, threshold=0.05, check_time=True)
    assert set(times) == {"preprocess", "forward_detect", "postfilter", "total"}
    assert all(t >= 0 for t in times.values())


def test_predict_batch_equals_jax(pair):
    jdet, det = pair
    imgs = list(_images(21, 4))
    want = jdet.predict_batch(imgs, threshold=0.05)
    got = det.predict_batch(imgs, threshold=0.05)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g[0]) > 0
        _assert_same_row_sets(_rows(*g), _rows(*w), ATOL * HW)
        assert (np.diff(g[2]) <= 0).all()  # score-descending


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="no GPU"):
        ObjectDetector(_small(default_config()), device="cuda")


def test_demo_time_mode_runs_on_the_cpu(tmp_path, capsys):
    """``python -m ssds_tpu_torch.demo -t time`` on the small config: 110
    requests, the per-stage dict and the latency summary line."""
    from ssds_tpu_torch import demo

    yml = tmp_path / "small.yml"
    yml.write_text("MODEL:\n  IMAGE_SIZE: [64, 64]\n"
                   "  FEATURE_LAYER: [[22, 34, 'S'], [512, 1024, 512]]\n"
                   "  ASPECT_RATIOS: [[2], [2, 3], [2, 3]]\n  HALF_PRECISION: False\n")
    demo.demo(["--cfg", str(yml), "-t", "time", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "forward_detect" in out
    assert "p50=" in out and "(100 requests, device cpu)" in out
