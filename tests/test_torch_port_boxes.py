"""The port's box math against ``ssds_tpu.ops.boxes``, in float32.

Tolerance: rtol 1e-6 / atol 1e-7, a few float32 ulps. The port runs the
JAX package's operations in the same order, but XLA on the CPU may contract
a multiply-add into one FMA (encode, decode) or fuse the log/exp chains,
which moves the last bit. Min/max/clamp-only results are compared exactly.
Zero-area boxes (x2 == x1, and a fully degenerate all-zero box) are in
every set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu.ops import boxes as jb
from ssds_tpu_torch.ops import boxes as tb

RTOL, ATOL = 1e-6, 1e-7


def _corner(rng, n):
    xy = rng.uniform(0.0, 0.7, (n, 2))
    wh = rng.uniform(0.01, 0.3, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[::5, 2] = b[::5, 0]  # zero width
    b[3] = 0.0  # all-zero box
    return b


def _inputs(name):
    rng = np.random.default_rng(len(name))
    a, b = _corner(rng, 13), _corner(rng, 9)
    priors = np.array(jb.center_size(jnp.asarray(_corner(rng, 13) + 0.05)))
    if name in ("point_form",):
        return (np.abs(a),)
    if name in ("center_size", "area"):
        return (a,)
    if name in ("intersect", "jaccard"):
        return a, b
    if name == "iou_pairwise":
        return a, _corner(rng, 13)
    if name == "encode":
        return a, priors
    if name == "decode":
        return rng.normal(0, 1.0, (2, 13, 4)).astype(np.float32), priors
    if name == "log_sum_exp":
        return (rng.normal(0, 5.0, (4, 7, 21)).astype(np.float32),)
    raise KeyError(name)


EXACT = {"point_form", "center_size", "intersect", "area"}


@pytest.mark.parametrize("name", ["point_form", "center_size", "intersect", "area",
                                  "jaccard", "iou_pairwise", "encode", "decode",
                                  "log_sum_exp"])
def test_box_math_matches_jax(name):
    args = _inputs(name)
    want = np.asarray(getattr(jb, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tb, name)(*(torch.from_numpy(x) for x in args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_degenerate_boxes_have_zero_iou():
    z = torch.zeros((2, 4))
    assert torch.equal(tb.jaccard(z, z), torch.zeros((2, 2)))
    assert torch.equal(tb.iou_pairwise(z, z), torch.zeros(2))
