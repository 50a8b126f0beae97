"""SSDLite forward of every MobileNet width in the port against the JAX package.

The four MobileNetV1 widths here, the four V2 widths in
``tests/test_torch_port_mobilenet_v2_widths.py`` (two files, so that
pytest-xdist runs them side by side). Each of the eight backbones under the
SSDLite yml of its family, at 64 px (maps 4/2/1/1/1/1), with random
variables (BN statistics too, ``tests/test_torch_port_mobilenet.py::lite_pair``)
carried by the bridge, on one float32 batch of 4 images:

- eval phase (running statistics): loc within rtol 1e-4 / atol 2e-5 and the
  softmax within atol 1e-5 (measured at most 1.7e-6 and 1.5e-7). About 40
  convolutions deep, each summing up to 1280 products in another order in
  XLA's and PyTorch's CPU convolutions;
- train phase (batch statistics): the raw ``(loc, conf)`` within atol 0.1
  (|loc| up to 2.2; measured at most 3.5e-2) and the updated running
  statistics within 1.5e-2 of each one's largest value (measured 4.7e-3).
  That wide, because each train-mode BN divides by the spread of as few as
  4 values at the 1x1 maps, which magnifies rounding: the port's own
  float32 output lies up to 1.3e-2 from its float64 output. The sharp check
  of train mode is in float64 (``tests/test_torch_port_lite_train.py``) and
  block by block (``tests/test_torch_port_bn_layers.py``); this one would
  still see a running variance blended unbiased (4/3 of the biased at
  n = 4, 3 % of the statistic) or a wrong momentum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ssds_tpu_torch.weights import port_name
from test_torch_port_mobilenet import lite_pair, one_torch_thread  # noqa: F401

WIDTHS = ("", "_075", "_050", "_025")
IMAGE = 64


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("net", [f"mobilenet_v1{w}" for w in WIDTHS])
def test_ssd_lite_forward_equals_jax(net):
    check_forward(net, seed=WIDTHS.index(net[len("mobilenet_v1"):]))


def check_forward(net, seed):
    jmodel, variables, tmodel, _ = lite_pair(net, IMAGE, seed=seed)
    x = np.random.default_rng(7).normal(0, 50, (4, IMAGE, IMAGE, 3)).astype(np.float32)

    want_loc, want_conf = (np.asarray(a) for a in jax.jit(
        lambda v, x: jmodel.apply(v, x, phase="eval"))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got_loc, got_conf = (a.numpy() for a in tmodel.eval()(_nchw(x), phase="eval"))
    assert got_loc.shape == want_loc.shape == (4, (16 + 4 + 1 + 1 + 1 + 1) * 6, 4)
    np.testing.assert_allclose(got_loc, want_loc, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got_conf, want_conf, rtol=0, atol=1e-5)

    (want_loc, want_conf), mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, phase="train", train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    tmodel.train()
    with torch.no_grad():
        got_loc, got_conf = (a.numpy() for a in tmodel(_nchw(x), phase="train"))
    np.testing.assert_allclose(got_loc, np.asarray(want_loc), rtol=0, atol=0.1)
    np.testing.assert_allclose(got_conf, np.asarray(want_conf), rtol=0, atol=0.1)
    ours = tmodel.state_dict()
    flat = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))
    assert len(flat) == sum(k.endswith(("running_mean", "running_var")) for k in ours)
    for path, want in flat.items():
        name = port_name("/".join(path), net)
        err = np.abs(ours[name].numpy() - want).max() / np.abs(want).max()
        assert err <= 1.5e-2, (name, err)
        if name.endswith("running_mean"):
            assert int(ours[name[:-len("running_mean")] + "num_batches_tracked"]) == 1, name
