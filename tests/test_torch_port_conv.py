"""The 3x3 stem conv and the dot probes: the port's plain versions and CPU
wrappers against the Pallas prototype run unmodified in TPU interpret mode
(``tools/pallas_conv_bench.py::pallas_conv``, ``tools/pallas_conv_bisect.py``
``k_dot`` / ``k_dot3d``) and against ``xla_conv``.

Tolerance (``ssds_tpu_torch.ops.conv.RTOL, ATOL`` = 2^-7, 1e-4): one bf16 ulp.
Both sides sum the same float32 products in different orders and round
once to bf16, so an output can land one ulp apart.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ssds_tpu_torch.ops.conv import ATOL, RTOL, conv3x3_rows_torch, dy_stack, vconv3_torch
from ssds_tpu_torch.ops.cuda.conv import conv3x3_rows, smem_bytes, vconv3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def assert_within_ulp(got, want, what):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    msg = f"{what}: max |d| {diff.max().item():.3e}, {int((diff > 0).sum())} of {diff.numel()} differ"
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=msg)


@pytest.mark.parametrize("b,h,w,cin,cout,th", [(2, 20, 16, 8, 8, 10), (1, 30, 12, 16, 24, 10),
                                               (1, 20, 16, 16, 16, 20)])
def test_conv_matches_pallas_conv_and_xla_conv(b, h, w, cin, cout, th):
    tool = load_tool("pallas_conv_bench")
    rng = np.random.default_rng(h * 100 + cout)
    x = jnp.asarray(rng.normal(0, 1, (b, h, w, cin)), jnp.bfloat16)
    wt = jnp.asarray(rng.normal(0, 0.05, (3, 3, cin, cout)), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        pallas = to_torch(tool.pallas_conv(x, wt, th=th))
    xla = to_torch(jax.jit(tool.xla_conv)(x, wt))
    xt, wtt = to_torch(x), to_torch(wt)
    for name, got in (("plain", conv3x3_rows_torch(xt, wtt)), ("wrapper", conv3x3_rows(xt, wtt))):
        assert got.shape == (b, h, w, cout) and got.dtype == torch.bfloat16
        assert_within_ulp(got, pallas, f"{name} vs pallas_conv")
        assert_within_ulp(got, xla, f"{name} vs xla_conv")


def test_dy_stack_is_pallas_conv_weight_layout():
    """``dy_stack`` equals ``pallas_conv_bench.py:76`` exactly, and each of its
    slices is the 3x1 conv of one column of taps: the conv is the sum over dx
    of ``vconv3_torch`` on the input shifted by dx (float32, no rounding)."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.05, (3, 3, 8, 12)).astype(np.float32)
    want = np.asarray(jnp.asarray(w).transpose(1, 0, 2, 3).reshape(3, 3 * 8, 12))
    got = dy_stack(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)

    x = torch.from_numpy(rng.normal(0, 1, (2, 9, 11, 8)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))  # H and W by one on each side
    cols = sum(vconv3_torch(xp[:, :, dx:dx + 11], got[dx]) for dx in range(3))
    torch.testing.assert_close(cols, conv3x3_rows_torch(x, torch.from_numpy(w)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,kernel", [("dot", "k_dot"), ("dot3d", "k_dot3d")])
def test_vconv3_matches_pallas_dot_probes(name, kernel, monkeypatch):
    """At W, C = 16, 8 (module globals shrunk; H stays 300 and TH 30)."""
    tool = load_tool("pallas_conv_bisect")
    monkeypatch.setattr(tool, "W", 16)
    monkeypatch.setattr(tool, "C", 8)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (2, 302, 16, 8)), jnp.bfloat16)
    wd = jnp.asarray(rng.normal(0, 0.05, (3, 24, 8)), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out = tool.run_case(name, getattr(tool, kernel), (tool.TH, 16, 8), x, wd)
    assert out is not None, f"the Pallas probe {name} failed in interpret mode"
    want = to_torch(out)
    xt, wd0 = to_torch(x), to_torch(wd)[0]
    for what, got in (("plain", vconv3_torch(xt, wd0)), ("wrapper", vconv3(xt, wd0))):
        assert got.shape == (2, 300, 16, 8) and got.dtype == torch.bfloat16
        assert_within_ulp(got, want, f"{what} vs {kernel}")


def test_plain_versions_refuse_bad_shapes_and_smem_fits_the_tiles():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3x3_rows_torch(x, torch.zeros((3, 3, 4, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        vconv3_torch(x, torch.zeros((16, 8), dtype=torch.bfloat16))
    # the stem's Cin = 64 fits a block with every tile of the sweep, for both kernels
    from ssds_tpu_torch.ops.cuda.conv import MAX_SMEM, TILES
    for tile in TILES:
        assert smem_bytes(64, 3, tile) <= MAX_SMEM and smem_bytes(64, 1, tile) <= MAX_SMEM
    assert smem_bytes(64, 3, (8, 1)) == 199936
