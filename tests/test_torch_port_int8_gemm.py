"""The int8 conv as a GEMM, on the CPU: the bench's ``torch._int_mm``
yardstick (``ssds_tpu_torch/tools/int8_bench.py``) and the launch plans of the
int8 kernels (``ssds_tpu_torch/ops/cuda/int8_conv.py``).

The yardstick's accumulators (the NHWC input itself for a 1x1 stride-1
conv, else its im2col, times the packed weights, through ``torch._int_mm``)
equal the plain conv's (``int8_conv_torch``) and JAX's ``int8_conv``
(``ssds_tpu/quant.py:70``) exactly: integer sums, no tolerance. The plans are
pure functions of the shapes, checked over every int8 conv of SSD300-VGG16,
the bench's extra shapes and the card tests' odd shapes: a legal ``wgmma``
N, a copy width that divides Cp, tiles that cover the output without one
past Cout, and a ``quantize_act`` tile that fills its block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssds_tpu import quant as jq
from ssds_tpu_torch import quant as tq
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.detector import create_model
from ssds_tpu_torch.ops.cuda import int8_conv as ci
from ssds_tpu_torch.ops.quant import conv_out_size, int8_conv_torch, padded_channels
from ssds_tpu_torch.tools import int8_bench as ib
from test_torch_port_cuda import INT8_ODD_SHAPES

# Every int8 conv of SSD300-VGG16 (the default config with MODEL.QUANT:
# int8) with the map it reads, in call order; held against the model below.
SSD300_INT8_SHAPES = [ib.ConvShape(*s) for s in (
    ("base.0", 3, 64, (3, 3), (1, 1), (1, 1), (1, 1), (300, 300), True, False),
    ("base.2", 64, 64, (3, 3), (1, 1), (1, 1), (1, 1), (300, 300), True, False),
    ("base.5", 64, 128, (3, 3), (1, 1), (1, 1), (1, 1), (150, 150), True, False),
    ("base.7", 128, 128, (3, 3), (1, 1), (1, 1), (1, 1), (150, 150), True, False),
    ("base.10", 128, 256, (3, 3), (1, 1), (1, 1), (1, 1), (75, 75), True, False),
    ("base.12", 256, 256, (3, 3), (1, 1), (1, 1), (1, 1), (75, 75), True, False),
    ("base.14", 256, 256, (3, 3), (1, 1), (1, 1), (1, 1), (75, 75), True, False),
    ("base.17", 256, 512, (3, 3), (1, 1), (1, 1), (1, 1), (38, 38), True, False),
    ("base.19", 512, 512, (3, 3), (1, 1), (1, 1), (1, 1), (38, 38), True, False),
    ("base.21", 512, 512, (3, 3), (1, 1), (1, 1), (1, 1), (38, 38), True, False),
    ("base.24", 512, 512, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True, False),
    ("base.26", 512, 512, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True, False),
    ("base.28", 512, 512, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True, False),
    ("base.31", 512, 1024, (3, 3), (1, 1), (6, 6), (6, 6), (19, 19), True, False),
    ("base.33", 1024, 1024, (1, 1), (1, 1), (0, 0), (1, 1), (19, 19), True, False),
    ("extras.0", 1024, 256, (1, 1), (1, 1), (0, 0), (1, 1), (19, 19), True, True),
    ("extras.1", 256, 512, (3, 3), (2, 2), (1, 1), (1, 1), (19, 19), True, True),
    ("extras.2", 512, 128, (1, 1), (1, 1), (0, 0), (1, 1), (10, 10), True, True),
    ("extras.3", 128, 256, (3, 3), (2, 2), (1, 1), (1, 1), (10, 10), True, True),
    ("extras.4", 256, 128, (1, 1), (1, 1), (0, 0), (1, 1), (5, 5), True, True),
    ("extras.5", 128, 256, (3, 3), (1, 1), (0, 0), (1, 1), (5, 5), True, True),
    ("extras.6", 256, 128, (1, 1), (1, 1), (0, 0), (1, 1), (3, 3), True, True),
    ("extras.7", 128, 256, (3, 3), (1, 1), (0, 0), (1, 1), (3, 3), True, True),
    ("loc.0", 512, 16, (3, 3), (1, 1), (1, 1), (1, 1), (38, 38), True, False),
    ("conf.0", 512, 84, (3, 3), (1, 1), (1, 1), (1, 1), (38, 38), True, False),
    ("loc.1", 1024, 24, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True, False),
    ("conf.1", 1024, 126, (3, 3), (1, 1), (1, 1), (1, 1), (19, 19), True, False),
    ("loc.2", 512, 24, (3, 3), (1, 1), (1, 1), (1, 1), (10, 10), True, False),
    ("conf.2", 512, 126, (3, 3), (1, 1), (1, 1), (1, 1), (10, 10), True, False),
    ("loc.3", 256, 24, (3, 3), (1, 1), (1, 1), (1, 1), (5, 5), True, False),
    ("conf.3", 256, 126, (3, 3), (1, 1), (1, 1), (1, 1), (5, 5), True, False),
    ("loc.4", 256, 16, (3, 3), (1, 1), (1, 1), (1, 1), (3, 3), True, False),
    ("conf.4", 256, 84, (3, 3), (1, 1), (1, 1), (1, 1), (3, 3), True, False),
    ("loc.5", 256, 16, (3, 3), (1, 1), (1, 1), (1, 1), (1, 1), True, False),
    ("conf.5", 256, 84, (3, 3), (1, 1), (1, 1), (1, 1), (1, 1), True, False),
)]
ALL_SHAPES = (SSD300_INT8_SHAPES + list(ib.EXTRA_SHAPES)
              + [ib.ConvShape(*s) for s in INT8_ODD_SHAPES])
BATCHES = (1, 3, 32)  # the bench's and the card tests' batches
# every N that PTX allows for an 8-bit wgmma m64nNk32 (CUTLASS's
# SM90_64xNx32_S32S8S8_SS_TN atoms list the same)
WGMMA_S8_N = (8, 16, 24, 32) + tuple(range(48, 257, 16))


def test_ssd300_shape_table_is_the_models_int8_convs():
    """The table above is SSD300-VGG16's quantised conv set with the maps
    they read: the float model on the meta device (shapes, no arithmetic),
    its convs chosen by the quantisation plan."""
    with torch.device("meta"):
        model, _ = create_model(default_config().MODEL)
    model.eval()
    convs = tq.candidate_convs(model)
    maps = {}
    for name, conv in convs.items():
        conv.register_forward_pre_hook(
            lambda _m, args, name=name: maps.__setitem__(name, tuple(args[0].shape[2:])))
    with torch.no_grad():
        model(torch.zeros((1, 3, 300, 300), device="meta"), phase="eval")
    names = [n for unit in tq.plan(model, {n: 1.0 for n in maps}) for n in unit]
    found = [ib.ConvShape(n, c.in_channels, c.out_channels, tuple(c.kernel_size),
                          tuple(c.stride), tuple(c.padding), tuple(c.dilation), maps[n],
                          c.bias is not None, bool(c.relu))
             for n, c in ((n, convs[n]) for n in names)]
    assert found == SSD300_INT8_SHAPES


# the cases: a 1x1 read directly, a 3x3 with padding, stride 2,
# dilation 6, Cp = 4 (3 input channels) and Cp = 24
YARDSTICK = [
    ("1x1_direct", 64, 24, (1, 1), (1, 1), (0, 0), (1, 1), (5, 7)),
    ("3x3_pad", 16, 40, (3, 3), (1, 1), (1, 1), (1, 1), (9, 8)),
    ("3x3_s2", 32, 16, (3, 3), (2, 2), (1, 1), (1, 1), (11, 10)),
    ("3x3_dil6", 8, 8, (3, 3), (1, 1), (6, 6), (6, 6), (19, 19)),
    ("cp4", 3, 64, (3, 3), (1, 1), (1, 1), (1, 1), (12, 12)),
    ("cp24", 24, 84, (3, 3), (1, 1), (1, 1), (1, 1), (6, 5)),
]


@pytest.mark.parametrize("case", YARDSTICK, ids=lambda c: c[0])
def test_int_mm_yardstick_equals_plain_and_jax_accumulators(case):
    _, cin, cout, k, s, p, d, hw = case
    rng = np.random.default_rng(0)
    cp = padded_channels(cin)
    x = np.zeros((2, *hw, cp), np.int8)
    x[..., :cin] = rng.integers(-127, 128, (2, *hw, cin))
    w = rng.integers(-127, 128, (cout, *k, cin)).astype(np.int8)
    xq = torch.from_numpy(x)
    wq = torch.nn.functional.pad(torch.from_numpy(w), (0, cp - cin)).contiguous()
    got = ib.int_mm_acc(xq, wq, s, p, d)
    want = int8_conv_torch(xq, wq, s, p, d)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    jax_acc = jq.int8_conv(jnp.asarray(x[..., :cin]), jnp.asarray(w.transpose(1, 2, 3, 0)),
                           stride=s, padding=((p[0], p[0]), (p[1], p[1])), dilation=d)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(jax_acc))
    a, b = ib.int_mm_operands(xq, wq, s, p, d)
    ho, wo = (conv_out_size(hw[i], k[i], s[i], p[i], d[i]) for i in (0, 1))
    assert a.shape[0] == max(2 * ho * wo, 17) and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    assert b.stride() == (1, b.shape[0])  # the weights' rows, transposed: column-major
    if case[0] == "1x1_direct":  # the NHWC input itself, not a copy
        assert a.data_ptr() == xq.data_ptr()


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: s.name)
def test_conv_plan_is_legal_and_covers_the_output(shape):
    cp = padded_channels(shape.cin)
    kh, kw = shape.kernel
    ho, wo = (conv_out_size(shape.hw[i], shape.kernel[i], shape.stride[i], shape.padding[i],
                            shape.dilation[i]) for i in (0, 1))
    for batch in BATCHES:
        plan = ci.conv_plan(batch, ho, wo, cp, shape.cout, kh, kw)
        assert plan == ci.conv_plan(batch, ho, wo, cp, shape.cout, kh, kw)  # pure
        assert plan.bn in ci.CONV_BN and plan.bn in WGMMA_S8_N
        assert plan.vec in (4, 8, 16) and cp % plan.vec == 0
        assert plan.vec == 16 or cp % (2 * plan.vec)  # the widest that divides Cp
        m = batch * ho * wo
        assert (plan.m_tiles - 1) * ci.CONV_BM < m <= plan.m_tiles * ci.CONV_BM
        # N tiles cover Cout and none lies wholly past it; the last one's
        # channels past Cout take zero weights and are not stored
        assert (plan.n_tiles - 1) * plan.bn < shape.cout <= plan.n_tiles * plan.bn
        assert shape.cout > 128 or plan.n_tiles == 1  # one tile holds a narrow Cout
        assert plan.k_stages * ci.CONV_BK >= kh * kw * cp > (plan.k_stages - 1) * ci.CONV_BK
        assert plan.grid == plan.m_tiles * plan.n_tiles < 2 ** 31


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: s.name)
def test_quantize_plan_fills_its_block_and_covers_the_input(shape):
    cp = padded_channels(shape.cin)
    h, w = shape.hw
    for batch in BATCHES:
        plan = ci.quantize_plan(batch, shape.cin, h, w)
        assert plan.ct in (4, 8, 16, 32, 64) and plan.ct * plan.pixels == ci.QA_TILE
        assert plan.ct >= min(cp, 64) and (plan.ct == 4 or plan.ct // 2 < cp)  # the least tile
        assert plan.store in (4, 8, 16) and cp % plan.store == 0 and plan.store <= plan.ct
        ptiles, ctiles, b = plan.grid
        assert b == batch and (ptiles - 1) * plan.pixels < h * w <= ptiles * plan.pixels
        assert (ctiles - 1) * plan.ct < cp <= ctiles * plan.ct and ctiles <= 65535
