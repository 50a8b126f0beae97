"""YOLOv2 and YOLOv3 over DarkNet and MobileNetV1-0.25, served by the port's
``ObjectDetector`` (CPU), against the JAX package's ``'eval'`` phase.

The variables are ``tests/test_torch_port_yolo_models.py``'s (random,
:func:`~test_torch_port_yolo_models._tame`), carried in a ``.pth`` written
by the bridge; the images are seeded uint8. The JAX forward of each model and
dtype is made once for the module. Compared: the decoded boxes and scores
(the raw outputs, ``forward(..., phase="train")``, decoded give them);
the port's ``detect_decoded`` on JAX's decoded outputs against JAX's
``detect_decoded`` (equal rows); in float32 the detector's own rows; and
YOLOv2's reorg route, which a ``pixel_unshuffle`` in its place takes away
from JAX's forward.

Tolerances, with what was measured: float32, boxes within atol 2e-5 and
scores within 1e-6 (:data:`F32_TOL`; measured 9.5e-7 and 4.8e-7 at most over
the four models); bf16, each output no further from JAX's float32 forward
than twice JAX's own bf16 forward (``torch_port_heads.served_forward_against_jax``'s
rule; measured, port against JAX, boxes 0.0094 / 0.0100 and scores 0.0046 /
0.0045 at most, on YOLOv3-DarkNet53).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssds_tpu.ops import postprocess as jpost
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.models.heads import yolo as tyolo
from ssds_tpu_torch.ops import postprocess as tpost
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_yolo_models import DARKNET_V2, DARKNET_V3, MBV1_V2, MBV1_V3, _pair
from torch_port_heads import bridge

F32_TOL = (2e-5, 1e-6)
MODELS = {"v3_darknet53": DARKNET_V3, "v2_darknet19": DARKNET_V2, "v3_mbv1_025": MBV1_V3,
          "v2_mbv1_025": MBV1_V2}
IMAGES = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _model(name):
    return _pair(MODELS[name])


@functools.lru_cache(maxsize=None)
def _jax_eval(name, half):
    """JAX's ``'eval'`` outputs on :data:`IMAGES`: the mean subtracted in
    float32, then the cast."""
    jmodel, variables, _, _, tcfg = _model(name)
    means = np.asarray(tcfg.DATASET.PIXEL_MEANS, np.float32)
    dt = jnp.bfloat16 if half else jnp.float32
    fwd = jax.jit(lambda v, img: jmodel.apply(v, (img.astype(jnp.float32) - means).astype(dt),
                                              phase="eval", train=False))
    return tuple(np.asarray(a) for a in fwd(variables, IMAGES))


def _detector(name, half, tmp_path):
    _, variables, _, _, tcfg = _model(name)
    tcfg = copy.deepcopy(tcfg)
    tcfg.MODEL.HALF_PRECISION = half
    pth = tmp_path / "yolo.pth"
    torch.save(bridge(variables, tcfg.MODEL), pth)
    tcfg.RESUME_CHECKPOINT = str(pth)
    return ObjectDetector(tcfg, device="cpu")


def _forward_errors(name, det, half):
    """The detector's outputs against JAX's, by :data:`F32_TOL` in float32
    and by the bf16 rule; returns the errors for printing."""
    got = [a.numpy() for a in det.forward(torch.from_numpy(IMAGES))]
    want = _jax_eval(name, half)
    assert all(g.shape == w.shape and g.dtype == w.dtype == np.float32 for g, w in zip(got, want))
    if not half:
        for g, w, tol in zip(got, want, F32_TOL):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        return [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    ref = _jax_eval(name, False)
    out = []
    for g, w, r in zip(got, want, ref):
        port_err, jax_err = float(np.abs(g - r).max()), float(np.abs(w - r).max())
        assert port_err <= 2 * jax_err, (port_err, jax_err)
        out.append((port_err, jax_err))
    return out


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(MODELS))
def test_yolo_detector_forward_and_rows_equal_jax(name, half, tmp_path):
    det = _detector(name, half, tmp_path)
    assert det.priors is None and det.model.conf0.weight.dtype == (torch.bfloat16 if half
                                                                    else torch.float32)
    print(name, half, "boxes, scores:", _forward_errors(name, det, half))
    raw = det.forward(torch.from_numpy(IMAGES), phase="train")
    for a, b in zip(det.model.decode(raw, (64, 64)), det.forward(torch.from_numpy(IMAGES))):
        assert torch.equal(a, b)
    boxes, scores = _jax_eval(name, half)
    k = det.model.num_boxes(det.feature_maps)
    assert boxes.shape == (2, k, 4) and scores.shape == (2, k, det.cfg.MODEL.NUM_CLASSES)
    post = tpost.PostProcessConfig.from_cfg(det.cfg.POST_PROCESS)
    want = np.asarray(jax.jit(jpost.detect_decoded, static_argnums=2)(
        boxes, scores, jpost.PostProcessConfig(**vars(post))))
    got = tpost.detect_decoded(torch.tensor(boxes), torch.tensor(scores), post)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1:, :, 0] > 0).any()
    if not half:
        np.testing.assert_allclose(det.detect_rows(IMAGES).numpy(), want, rtol=0,
                                   atol=F32_TOL[0])


def test_reorg_route_fails_with_pixel_unshuffle(tmp_path, monkeypatch):
    """YOLOv2's route through a ``pixel_unshuffle`` reorg leaves JAX's forward."""
    det = _detector("v2_darknet19", False, tmp_path)
    _forward_errors("v2_darknet19", det, False)
    monkeypatch.setattr(tyolo, "space_to_depth", lambda t, b: F.pixel_unshuffle(t, b))
    with pytest.raises(AssertionError):
        _forward_errors("v2_darknet19", det, False)
