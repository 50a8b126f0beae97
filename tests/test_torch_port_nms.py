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
from ssds_tpu_torch.ops.boxes import jaccard
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



# -- the kernel's algorithm and launch plan, emulated on the CPU -------------

EMU_N = [1, 31, 32, 33, 200, 512]
EMU_KINDS = ["random", "tied_scores", "dense_overlap", "full"]


def _emu_case(n, kind):
    """Three slots with zero-area boxes; slot 1 all invalid; an invalid tail
    in each slot but for "full"."""
    rng = np.random.default_rng([n, EMU_KINDS.index(kind)])
    lo, hi = (0.3, 0.5) if kind == "dense_overlap" else (0.05, 0.4)
    boxes, scores = _sorted_set(rng, 3, n, lo, hi, invalid_tail=kind != "full",
                                levels=6 if kind == "tied_scores" else 0)
    boxes[:, ::5, 2:] = boxes[:, ::5, :2]
    scores[1] = NEG_INF
    return boxes, scores


@pytest.mark.parametrize("thr", [0.45, 0.6])
@pytest.mark.parametrize("kind", EMU_KINDS)
@pytest.mark.parametrize("n", EMU_N)
def test_kernel_emulation_equals_plain_and_pallas(n, kind, thr):
    """Upper-triangle words, phase 2 a word at a time with the diagonal block
    resolved bit by bit: bit-identical to the plain version and to the Pallas
    kernel in interpret mode. Words the kernel never writes hold poison in the
    emulation, so a read of one would show."""
    boxes, scores = _emu_case(n, kind)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = cuda_nms.nms_mask_emulated(bt, st, thr).numpy()
    np.testing.assert_array_equal(got, tnms.nms_mask_torch(bt, st, thr).numpy())
    np.testing.assert_array_equal(got, _reference("pallas_interpret", boxes, scores, thr))
    assert not got[1].any()


@pytest.mark.parametrize("n", [33, 200])
def test_suppression_words_are_the_plain_upper_triangle(n):
    """Phase 1 writes exactly the words at or right of each valid row's
    diagonal tile, below n_eff, and they hold the plain version's bits."""
    boxes, scores = (torch.from_numpy(a) for a in _emu_case(n, "random"))
    sup, valid, n_eff = cuda_nms.suppression_words(boxes, scores, 0.5)
    lay = cuda_nms.slot_layout(n)
    assert sup.shape == (3, lay.words, lay.rows)
    plain = (jaccard(boxes, boxes) > 0.5) & (torch.arange(n)[None, :] > torch.arange(n)[:, None])
    is_valid = scores > NEG_INF / 2
    for s in range(scores.shape[0]):
        ne = int(n_eff[s])
        assert ne == (int(is_valid[s].nonzero().max()) + 1 if is_valid[s].any() else 0)
        for w in range(lay.words):
            bits = sum(int(b) << t for t, b in enumerate(is_valid[s, 32 * w:32 * w + 32]))
            assert int(valid[s, w]) == bits
        for c in range(lay.words):
            for i in range(lay.rows):
                word = int(sup[s, c, i])
                if i < ne and i // 32 <= c < -(-ne // 32):
                    cols = plain[s, i, 32 * c:min(32 * c + 32, ne)]
                    assert word == sum(int(b) << t for t, b in enumerate(cols))
                else:
                    assert word == 0xFFFFFFFF  # never written, never applied


def test_slot_layout_is_sized_by_n():
    assert cuda_nms.slot_layout(200) == (7, 224, 225, 10816)  # ~10.6 KB a slot at N = 200
    assert cuda_nms.slot_layout(512) == (16, 512, 513, 43136)  # odd stride: 32 banks
    assert cuda_nms.slot_layout(1).bytes == 784


@pytest.mark.parametrize("n", EMU_N)
@pytest.mark.parametrize("m", [1, 21, 672, 673])
def test_launch_plan_covers_each_slot_once_and_fits(m, n):
    plan = cuda_nms.launch_plan(m, n)
    clusters = [[cuda_nms.block_slots(m, plan, b) for b in range(first, first + plan.cluster)]
                for first in range(0, plan.blocks, plan.cluster)]
    assert all(len(set(c)) == 1 for c in clusters)  # a cluster's blocks share their slots
    assert [s for c in clusters for s in c[0]] == list(range(m))
    assert 1 <= plan.slots <= cuda_nms.MAX_SLOTS and plan.threads // 32 >= plan.slots
    assert plan.smem == cuda_nms.HEADER_BYTES + plan.slots * cuda_nms.slot_layout(n).bytes
    assert plan.smem <= cuda_nms.MAX_SMEM  # 227 KB
    per_sm = cuda_nms.SM_SMEM // (plan.smem + cuda_nms.BLOCK_RESERVE)
    if m <= cuda_nms.H100_SMS:  # a cluster of 16-warp blocks a slot, the grid in one wave
        assert plan.slots == 1 and plan.threads == 512 and plan.cluster > 1
        assert plan.blocks == m * plan.cluster <= 2 * cuda_nms.H100_SMS
    elif m <= 2 * cuda_nms.H100_SMS:
        assert (plan.slots, plan.threads, plan.blocks, plan.cluster) == (1, 512, m, 1)
    else:
        assert plan.slots > 1
        fit = (cuda_nms.MAX_SMEM - cuda_nms.HEADER_BYTES) // cuda_nms.slot_layout(n).bytes
        assert plan.blocks <= min(per_sm, 2) * cuda_nms.H100_SMS or plan.slots == fit


@pytest.mark.parametrize("m,n,want", [
    (1, 200, (1, 512, 2, 10944, 2)),       # one slot: a cluster of 2 blocks
    (21, 200, (1, 512, 42, 10944, 2)),     # batch 1: 2 blocks of 16 warps a slot
    (84, 200, (1, 512, 168, 10944, 2)),    # batch 4
    (200, 200, (1, 512, 200, 10944, 1)),   # a block a slot
    (672, 200, (3, 512, 224, 32576, 1)),   # batch 32: two blocks an SM, one wave
    (673, 200, (3, 512, 225, 32576, 1)),   # ragged last block
    (300, 512, (2, 512, 150, 86400, 1)),   # > 48 KB of dynamic shared memory
    (672, 512, (5, 512, 135, 215808, 1)),  # one block an SM; the block's memory caps it
], ids=str)
def test_launch_plan_regimes(m, n, want):
    assert tuple(cuda_nms.launch_plan(m, n)) == want


@pytest.mark.parametrize("n_effs", [[200], [0], [1, 33, 0, 200, 64, 511, 32, 31]], ids=str)
def test_block_tiles_cover_each_upper_triangle_tile_once(n_effs):
    tiles = cuda_nms.block_tiles(n_effs)
    want = [(s, r, c) for s, ne in enumerate(n_effs)
            for r in range(-(-ne // 32)) for c in range(-(-ne // 32)) if c >= r]
    assert sorted(tiles) == sorted(want) and len(set(tiles)) == len(tiles)


@pytest.mark.parametrize("m,n", [(1, 512), (21, 200), (84, 200), (672, 200)], ids=str)
def test_every_tile_has_one_warp(m, n):
    """Warp g of block q in the cluster takes tiles g + q * warps, stepping by
    warps * cluster: together, each tile once."""
    plan = cuda_nms.launch_plan(m, n)
    warps, total = plan.threads // 32, len(cuda_nms.block_tiles([n] * plan.slots))
    taken = [k for q in range(plan.cluster) for g in range(warps)
             for k in range(g + q * warps, total, warps * plan.cluster)]
    assert sorted(taken) == list(range(total))
    assert all(cuda_nms.tile_owner(k, plan)[0] < plan.cluster for k in taken)
    for q in range(plan.cluster):
        for g in range(warps):
            ks = range(g + q * warps, total, warps * plan.cluster)
            assert all(cuda_nms.tile_owner(k, plan) == (q, g) for k in ks)
