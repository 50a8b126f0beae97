"""Serving SSDLite: the port's ObjectDetector against the JAX one, float32 and bf16.

SSDLite over MobileNetV2-0.25 at 64 px (maps 4/2/1/1/1/1, 144 priors) with
random variables (every BN's running statistics too,
``tests/test_torch_port_mobilenet.py::lite_pair``), given to the JAX model
and to the port's detector through a ``.pth`` written by
``state_dict_from_jax`` and loaded as ``RESUME_CHECKPOINT``. The eval forward
on uint8 images from a numpy seed, ``MODEL.HALF_PRECISION`` off and on; the
JAX side is the forward of ``ssds_tpu.detector.ObjectDetector`` (the mean
subtracted in float32, then the bf16 cast).

Both run BatchNorm in bf16 serving the same way: the bf16 input
minus the float32 running mean is float32, normalised in float32 and rounded
to bf16 once (``ssds_tpu_torch/detector.py``). Tolerances: float32, loc
within atol 2e-5 and the softmax within 1e-5 (measured 1.4e-6 and 6e-8: sums in
other orders, as in ``tests/test_torch_port_mobilenet_widths.py``); bf16,
loc within atol 3e-2 and the softmax within 5e-3 (measured 7.8e-3 and
9.4e-4): each of ~40 bf16 layers rounds its
output to 2^-8 relative, and where the two frameworks round a convolution's
sum or its bias add differs; the float32 rounding of the normalisation
itself sits far below that.
"""

import jax
import numpy as np
import pytest
import torch

from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.models.layers import BatchNorm
from ssds_tpu_torch.weights import state_dict_from_jax
from test_torch_port_mobilenet import lite_configs, lite_pair, one_torch_thread  # noqa: F401

NET, HW = "mobilenet_v2_025", 64
TOL = {False: (2e-5, 1e-5), True: (3e-2, 5e-3)}


@pytest.mark.parametrize("half", [False, True], ids=["float32", "bf16"])
def test_lite_detector_forward_equals_jax(half, tmp_path):
    jmodel, variables, _, _ = lite_pair(NET, HW, seed=21)
    _, cfg = lite_configs(NET, HW)
    cfg.MODEL.HALF_PRECISION = half
    pth = tmp_path / "lite.pth"
    torch.save(state_dict_from_jax(variables, net=NET), pth)
    cfg.RESUME_CHECKPOINT = str(pth)
    det = ObjectDetector(cfg, device="cpu")
    bns = [m for m in det.model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 60 and all(m.running_var.dtype == torch.float32 for m in bns)
    assert det.model.base[0][0].weight.dtype == (torch.bfloat16 if half else torch.float32)

    x = np.random.default_rng(half).integers(0, 256, (4, HW, HW, 3), dtype=np.uint8)

    means = np.asarray(cfg.DATASET.PIXEL_MEANS, np.float32)

    @jax.jit
    def jax_forward(variables, img):
        x = img.astype(np.float32) - means
        return jmodel.apply(variables, x.astype(jax.numpy.bfloat16) if half else x,
                            phase="eval", train=False)

    want_loc, want_conf = (np.asarray(a) for a in jax_forward(variables, x))
    got_loc, got_conf = (a.numpy() for a in det.forward(torch.from_numpy(x)))
    assert got_loc.shape == want_loc.shape == (4, 144, 4)
    assert got_loc.dtype == want_loc.dtype == np.float32
    loc_tol, conf_tol = TOL[half]
    print(f"half={half}: loc max|d| {np.abs(got_loc - want_loc).max():.2e}, "
          f"conf max|d| {np.abs(got_conf - want_conf).max():.2e}")
    np.testing.assert_allclose(got_loc, want_loc, rtol=0, atol=loc_tol)
    np.testing.assert_allclose(got_conf, want_conf, rtol=0, atol=conf_tol)
    rows = det.detect_rows(x)
    assert rows.shape == (4, 21, 100, 5) and torch.isfinite(rows).all()
