"""The port's NMS (plain version and kernel wrapper) against the JAX package.

Every comparison is EXACT: a keep mask is a set of decisions, and the port
computes each IoU with the JAX package's float32 operations in the same
order, so there is no tolerance to state. Inputs are made with numpy from a
seed and handed to both sides.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ssds_tpu.ops import nms as jnms
from ssds_tpu.ops.pallas.nms import nms_mask_pallas
from ssds_tpu_torch.ops import nms as tnms
from ssds_tpu_torch.ops.cuda import nms as cuda_nms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = tnms.NEG_INF


def _sorted_set(rng, m, n, lo=0.05, hi=0.4, invalid_tail=True, levels=0):
    """[m, n] score-descending candidate slots; a random tail of each row is
    invalid (threshold-filtered padding). ``levels`` quantises the scores so
    that many are tied."""
    cxcy = rng.uniform(0.2, 0.8, (m, n, 2))
    wh = rng.uniform(lo, hi, (m, n, 2))
    boxes = np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1).astype(np.float32)
    raw = rng.uniform(0.01, 1.0, (m, n))
    if levels:
        raw = np.round(raw * levels) / levels + 0.01
    scores = -np.sort(-raw.astype(np.float32), axis=-1, kind="stable")
    if invalid_tail:
        for i in range(m):
            scores[i, rng.integers(n // 2, n + 1):] = NEG_INF
    return boxes, np.ascontiguousarray(scores, dtype=np.float32)


def _case(name):
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        return _sorted_set(rng, 6, 128)
    if name == "dense_overlap":  # heavy overlap: long suppression chains
        b, s = _sorted_set(rng, 4, 96, lo=0.3, hi=0.5)
        return b, s
    if name == "tied_scores":
        return _sorted_set(rng, 5, 64, levels=6)
    if name == "all_invalid_row":
        b, s = _sorted_set(rng, 3, 40)
        s[1] = NEG_INF
        return b, s
    if name == "zero_area":  # degenerate boxes: union 0 -> IoU 0
        b, s = _sorted_set(rng, 3, 48)
        b[:, ::3, 2:] = b[:, ::3, :2]
        b[:, 1, :] = 0.0
        return b, s
    if name == "slots_5_n_1":
        return _sorted_set(rng, 5, 1, invalid_tail=False)
    if name == "slots_3_n_37":
        return _sorted_set(rng, 3, 37)
    raise KeyError(name)


CASES = ["random", "dense_overlap", "tied_scores", "all_invalid_row", "zero_area",
         "slots_5_n_1", "slots_3_n_37"]
REFERENCES = ["vmap_sorted_nms", "sorted_nms_tiled", "pallas_interpret", "numpy_oracle"]


def _reference(ref, boxes, scores, thr):
    if ref == "vmap_sorted_nms":
        return np.asarray(jax.vmap(lambda b, s: jnms.sorted_nms(b, s, thr))(
            jnp.asarray(boxes), jnp.asarray(scores)))
    if ref == "sorted_nms_tiled":
        return np.asarray(jnms.sorted_nms_tiled(jnp.asarray(boxes), jnp.asarray(scores), thr))
    if ref == "pallas_interpret":
        return np.asarray(nms_mask_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr,
                                          interpret=True))
    out = np.zeros(scores.shape, bool)
    for i in range(scores.shape[0]):
        valid = np.nonzero(scores[i] > NEG_INF / 2)[0]  # a prefix: rows are sorted
        kept = oracle.nms(boxes[i, valid], scores[i, valid], thr, top_k=len(valid))
        out[i, valid[kept]] = True
    return out


@pytest.mark.parametrize("thr", [0.45, 0.6])
@pytest.mark.parametrize("ref", REFERENCES)
@pytest.mark.parametrize("case", CASES)
def test_nms_mask_torch_equals_jax(case, ref, thr):
    boxes, scores = _case(case)
    want = _reference(ref, boxes, scores, thr)
    got = tnms.nms_mask_torch(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "all_invalid_row":
        assert not got[1].any()


@pytest.mark.parametrize("case", ["random", "tied_scores", "zero_area"])
def test_greedy_nms_equals_jax(case):
    """The argmax-per-step oracle over UNSORTED scores: same picks, same order."""
    boxes, scores = _case(case)
    perm = np.random.default_rng(3).permutation(scores.shape[1])
    b, s = boxes[0, perm], scores[0, perm]
    want = [np.asarray(x) for x in jnms.greedy_nms(jnp.asarray(b), jnp.asarray(s), 0.5, 50)]
    got = [x.numpy() for x in tnms.greedy_nms(torch.from_numpy(b), torch.from_numpy(s), 0.5, 50)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sorted_nms_single_slot_equals_jax():
    boxes, scores = _case("random")
    want = np.asarray(jnms.sorted_nms(jnp.asarray(boxes[2]), jnp.asarray(scores[2]), 0.5))
    got = tnms.sorted_nms(torch.from_numpy(boxes[2]), torch.from_numpy(scores[2]), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    boxes, scores = (torch.from_numpy(a) for a in _case("random"))
    before = cuda_nms.nms_mask.launches
    got = cuda_nms.nms_mask(boxes, scores, 0.6)
    assert cuda_nms.nms_mask.launches == before == 0
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), tnms.nms_mask_torch(boxes, scores, 0.6).numpy())


def test_wrapper_refuses_a_non_cpu_non_cuda_tensor():
    """Only a CPU tensor takes the plain version; anything else must reach
    the kernel or raise — here a meta tensor, which cannot be launched on."""
    boxes = torch.empty((2, 8, 4), device="meta")
    scores = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_nms.nms_mask(boxes, scores, 0.5)


def test_cuda_module_imports_and_serves_cpu_without_nvcc(tmp_path):
    """With no nvcc anywhere the kernel module still imports and the CPU
    path still runs; asking for the build raises, naming nvcc."""
    code = (
        "import torch\n"
        "from ssds_tpu_torch.ops.cuda import nms, _build\n"
        "b = torch.rand(2, 5, 4); b[..., 2:] += b[..., :2]\n"
        "s = torch.sort(torch.rand(2, 5), descending=True).values\n"
        "assert nms.nms_mask(b, s, 0.5).shape == (2, 5)\n"
        "try:\n"
        "    _build.load()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('no-nvcc-ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_PATH",)}
    env["PATH"] = os.path.dirname(sys.executable)
    env["CUDA_HOME"] = str(tmp_path)  # no bin/nvcc here
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no-nvcc-ok" in proc.stdout

