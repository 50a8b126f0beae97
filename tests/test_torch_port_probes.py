"""The 17 stencil probes of the conv prototype: the port's plain version against
the Pallas kernels, run unmodified in TPU interpret mode on the CPU.

The probe tools keep their sizes in module globals (``TH, W, C`` and ``B``);
the tests shrink ``W, C, B`` to 16, 8, 2 with ``monkeypatch``. ``H`` stays 300
(the grids are ``300 // TH``) and ``TH`` stays 30.

Tolerance: none. Both sides add bf16 arrays one operation at a time, each add
rounded to bf16, in the same order, so outputs are compared bit for bit.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ssds_tpu_torch.ops.cuda.stencil import row_stencil
from ssds_tpu_torch.ops.stencil import PROBES, TOOL_W, row_stencil_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, W, C = 2, 16, 8

BISECT = {"copy": "k_copy", "pad": "k_pad", "cat": "k_cat", "reshape": "k_reshape"}
BISECT2 = {"pad_w": "k_pad_w", "pad_h": "k_pad_h", "cat_lane": "k_cat_lane",
           "cat_lane_same": "k_cat_lane_same", "add_shifted": "k_add_shifted",
           "w_shift_slice": "k_w_shift_slice"}
BISECT3 = {"pad_nodma": "g_pad_nodma", "dma_add": "g_dma_add", "dma_pad": "g_dma_pad",
           "dma_pad_read": "g_dma_pad_read", "dma_cat": "g_dma_cat"}


def load_tool(name, monkeypatch):
    """``tools/<name>.py`` loaded by path, its size globals shrunk."""
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "W", W)
    monkeypatch.setattr(mod, "C", C)
    if hasattr(mod, "B"):
        monkeypatch.setattr(mod, "B", B)
    return mod


def resized(probe):
    """The probe with the tool's module globals B, W, C shrunk (H stays)."""
    b = B if probe.shape[0] > 1 else 1
    return dataclasses.replace(probe, shape=(b, probe.shape[1], W + probe.shape[2] - TOOL_W, C))


def to_torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def grid_input(seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 1, (B, 302, W, C)), jnp.bfloat16)


def run_bisect3(mod, kernel, x, dma):
    """``pallas_conv_bisect3.run_grid``'s call (:17-31), returning the output."""
    th = mod.TH
    if dma:
        in_specs = [pl.BlockSpec(memory_space=pl.ANY)]
        scratch = [pltpu.VMEM((th + 2, W, C), jnp.bfloat16), pltpu.SemaphoreType.DMA(())]
    else:
        in_specs = [pl.BlockSpec((1, th, W, C), lambda i, j: (i, j, 0, 0))]
        scratch = []
    return pl.pallas_call(
        kernel, grid=(x.shape[0], 300 // th), in_specs=in_specs,
        out_specs=pl.BlockSpec((1, th, W, C), lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], 300, W, C), jnp.bfloat16),
        scratch_shapes=scratch)(x)


def run_elem_halo(mod, x):
    """``pallas_elem_halo_probe.main``'s call (:43-52), returning the output."""
    th = mod.TH
    return pl.pallas_call(
        mod.kern, grid=(x.shape[0], 300 // th),
        in_specs=[pl.BlockSpec((pl.Element(1), pl.Element(th + 2), pl.Element(W), pl.Element(C)),
                               lambda i, j: (i, j * th, 0, 0))],
        out_specs=pl.BlockSpec((1, th, W, C), lambda i, j: (i, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], 300, W, C), jnp.bfloat16))(x)


def pallas_probe(name, monkeypatch):
    """(input, output) of the probe's Pallas kernel, as torch bf16 ``[B, H, W, C]``."""
    probe = resized(PROBES[name])
    with pltpu.force_tpu_interpret_mode():
        if name in BISECT:
            mod = load_tool("pallas_conv_bisect", monkeypatch)
            x = grid_input()
            out = mod.run_case(name, getattr(mod, BISECT[name]), (mod.TH, W, C), x)
        elif name in BISECT2:
            mod = load_tool("pallas_conv_bisect2", monkeypatch)
            in_shape = probe.shape[1:]
            # run_case draws its input itself: the same numpy calls give the same array
            x = jnp.asarray(np.random.default_rng(0).normal(0, 1, in_shape), jnp.bfloat16)
            out = mod.run_case(name, getattr(mod, BISECT2[name]), in_shape,
                               (probe.out_rows, probe.out_cols, C))
            x, out = x[None], None if out is None else out[None]
        elif name in BISECT3:
            mod = load_tool("pallas_conv_bisect3", monkeypatch)
            x = grid_input()
            out = run_bisect3(mod, getattr(mod, BISECT3[name]), x, dma=name != "pad_nodma")
        else:
            assert name == "elem_halo"
            mod = load_tool("pallas_elem_halo_probe", monkeypatch)
            x = grid_input()
            out = run_elem_halo(mod, x)
    assert out is not None, f"the Pallas probe {name} failed in interpret mode"
    return to_torch(x), to_torch(out)


@pytest.mark.parametrize("name", sorted(set(PROBES) - {"roll_w"}))
def test_probe_bit_identical_to_pallas(name, monkeypatch):
    probe = resized(PROBES[name])
    x, want = pallas_probe(name, monkeypatch)
    assert tuple(x.shape) == probe.shape
    args = (probe.terms, probe.out_rows, probe.out_cols, probe.wmode)
    got = row_stencil_torch(x, *args)
    assert got.shape == want.shape == (probe.shape[0], probe.out_rows, probe.out_cols, C)
    assert torch.equal(got, want)
    assert torch.equal(row_stencil(x, *args), want)  # the wrapper on the CPU


def test_roll_w_equals_the_jnp_expression():
    """``pltpu.roll`` with a negative shift raises in interpret mode on this jax,
    so ``k_roll_w`` is held against the expression it stands for."""
    probe = resized(PROBES["roll_w"])
    x = jnp.asarray(np.random.default_rng(0).normal(0, 1, probe.shape[1:]), jnp.bfloat16)
    xm = x[0:probe.out_rows]
    want = to_torch(xm + jnp.roll(xm, 1, 1) + jnp.roll(xm, -1, 1))[None]
    args = (probe.terms, probe.out_rows, probe.out_cols, probe.wmode)
    got = row_stencil_torch(to_torch(x)[None], *args)
    assert got.shape == (1, probe.out_rows, W, C)
    assert torch.equal(got, want)
    assert torch.equal(row_stencil(to_torch(x)[None], *args), want)


def test_pltpu_roll_direction_is_jnp_roll():
    """Pins the direction ``roll_w``'s terms assume: ``pltpu.roll(x, 1, 1) == jnp.roll(x, 1, 1)``."""
    x = jnp.asarray(np.random.default_rng(1).normal(0, 1, (8, W, 128)), jnp.float32)

    def kern(x_ref, o_ref):
        o_ref[:] = pltpu.roll(x_ref[:], 1, 1)

    with pltpu.force_tpu_interpret_mode():
        got = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype))(x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(jnp.roll(x, 1, 1)))


def test_probe_table_sizes():
    """Every probe at the tools' sizes, and the stencil's refusals."""
    assert len(PROBES) == 17
    for name, probe in PROBES.items():
        assert probe.shape[2:] in ((TOOL_W, 64), (TOOL_W + 2, 64)), name
        assert probe.out_cols == TOOL_W, name
        if probe.shape[0] == 4:
            assert probe.shape[1] == 302 and probe.out_rows == 300, name
    x = torch.zeros((1, 4, 6, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows"):
        row_stencil_torch(x, ((0, 0), (3, 0)), 2, 6)
    with pytest.raises(ValueError, match="columns"):
        row_stencil_torch(x, ((0, -1),), 4, 6, "valid")
    with pytest.raises(ValueError, match="wmode"):
        row_stencil_torch(x, ((0, 0),), 4, 6, "reflect")
