"""The port's BatchNorm blocks against flax's: ``ConvBNReLU``, ``SepConvBNReLU``,
``InvertedResidual`` (``ssds_tpu/models/layers.py:543-654``).

Each block gets the same random weights and running statistics on both sides
(made with numpy, carried by ``ssds_tpu_torch.weights.port_name``) and the
same input, and runs in eval mode (running statistics) and in train mode
(batch statistics, which also updates the running buffers). Train mode also
compares the gradients of ``sum(out * cotangent)`` for the input and every
parameter.

Tolerances (float32): outputs and gradients within rtol 1e-5 / atol 1e-5.
The convolutions sum at most 9 x 16 products in other orders (~1e-7
relative), and the batch variance differs in how it is formed: flax takes
``E[x^2] - E[x]^2``, torch the two-pass ``E[(x - E[x])^2]``, so flax's loses
~1e-7 of ``E[x^2]``, i.e. ~1e-6 of the variance on these inputs (mean
comparable to the spread). The running buffers: rtol 1e-6 / atol 1e-7,
the same variance through one more blend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from ssds_tpu.models import layers as jl
from ssds_tpu_torch.models import layers as tl
from ssds_tpu_torch.weights import port_name

RTOL, ATOL = 1e-5, 1e-5
STATS_RTOL, STATS_ATOL = 1e-6, 1e-7


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _random_variables(shapes, rng):
    """Every leaf of a flax variable tree random: kernels at ~1/sqrt(fan_in),
    BN scales and variances in [0.5, 1.5], biases and means around 0."""
    out = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = rng.normal(0, 0.2, s.shape)
        out[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _port_state(variables, net):
    """The block's flax paths as if it were backbone layer 0 of ``net``, named
    by the bridge, then ``base.0.`` taken off."""
    sd = {}
    for col in ("params", "batch_stats"):
        for path, v in traverse_util.flatten_dict(variables[col]).items():
            name = port_name("base_layers_0/" + "/".join(path), net)
            arr = v.transpose(3, 2, 0, 1) if path[-1] == "kernel" else v
            sd[name[len("base.0."):]] = torch.from_numpy(np.array(arr, np.float32))
            if path[-1] == "mean":
                sd[name[len("base.0."):-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(0)
    return sd


# (id, flax block, port block, input channels, net naming)
CASES = [
    ("conv_bn_relu", lambda: jl.ConvBNReLU(16, kernel=3, stride=2, padding=1),
     lambda: tl.ConvBNReLU(8, 16, 3, stride=2, padding=1), 8, "mobilenet_v1"),
    ("conv_bn_relu6_1x1", lambda: jl.ConvBNReLU(12, kernel=1, padding=0, act="relu6"),
     lambda: tl.ConvBNReLU(8, 12, 1, padding=0, act="relu6"), 8, "mobilenet_v2"),
    ("conv_bn_none", lambda: jl.ConvBNReLU(8, kernel=3, padding=1, act="none"),
     lambda: tl.ConvBNReLU(8, 8, 3, padding=1, act="none"), 8, "mobilenet_v1"),
    ("depthwise_relu6_s2", lambda: jl.ConvBNReLU(8, kernel=3, stride=2, padding=1, groups=8,
                                                 act="relu6"),
     lambda: tl.ConvBNReLU(8, 8, 3, stride=2, padding=1, groups=8, act="relu6"), 8,
     "mobilenet_v2"),
    ("depthwise_relu", lambda: jl.ConvBNReLU(8, kernel=3, padding=1, groups=8),
     lambda: tl.ConvBNReLU(8, 8, 3, padding=1, groups=8), 8, "mobilenet_v1"),
    ("sep_conv_s2", lambda: jl.SepConvBNReLU(16, stride=2, padding=1),
     lambda: tl.SepConvBNReLU(8, 16, stride=2, padding=1), 8, "mobilenet_v1"),
    ("sep_conv_pad0", lambda: jl.SepConvBNReLU(16, stride=1, padding=0),
     lambda: tl.SepConvBNReLU(8, 16, stride=1, padding=0), 8, "mobilenet_v1"),
    ("inverted_residual_res", lambda: jl.InvertedResidual(8, stride=1, expand_ratio=6),
     lambda: tl.InvertedResidual(8, 8, stride=1, expand_ratio=6), 8, "mobilenet_v2"),
    ("inverted_residual_s2", lambda: jl.InvertedResidual(16, stride=2, expand_ratio=6),
     lambda: tl.InvertedResidual(8, 16, stride=2, expand_ratio=6), 8, "mobilenet_v2"),
    ("inverted_residual_t1", lambda: jl.InvertedResidual(16, stride=1, expand_ratio=1),
     lambda: tl.InvertedResidual(8, 16, stride=1, expand_ratio=1), 8, "mobilenet_v2"),
]


def _pair(case, seed):
    _, make_j, make_t, cin, net = case
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (4, 7, 7, cin)).astype(np.float32)
    jblock = make_j()
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rng)
    tblock = make_t()
    tblock.load_state_dict(_port_state(variables, net), strict=True)
    return jblock, variables, tblock, x, rng


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_eval_mode_equals_flax(case):
    jblock, variables, tblock, x, _ = _pair(case, 0)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = _nhwc(tblock.eval()(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_block_train_mode_equals_flax(case):
    """Batch statistics: the output, the gradients and the updated buffers."""
    jblock, variables, tblock, x, rng = _pair(case, 1)

    def f(params, x):
        return jblock.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])

    want, mut = f(variables["params"], jnp.asarray(x))
    want = np.asarray(want)
    cot = rng.normal(0, 1, want.shape).astype(np.float32)
    _, pull = jax.vjp(lambda p, x: f(p, x)[0], variables["params"], jnp.asarray(x))
    g_params, g_x = pull(jnp.asarray(cot))

    tblock.train()
    xt = _nchw(x).requires_grad_()
    out = tblock(xt)
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(out), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(g_x), rtol=RTOL, atol=ATOL)
    want_grads = _port_state({"params": jax.tree_util.tree_map(np.asarray, g_params),
                              "batch_stats": {}}, case[4])
    for name, p in tblock.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    new_stats = _port_state({"params": {}, "batch_stats": jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"])}, case[4])
    buffers = dict(tblock.named_buffers())
    for name, want_stat in new_stats.items():
        if name.endswith("num_batches_tracked"):
            assert int(buffers[name]) == 1, name
            continue
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=name)


def test_stock_batchnorm_update_differs_by_n_over_n_minus_1():
    """torch's own BatchNorm2d blends the UNBIASED batch variance; the port's
    and flax's blend the biased one: (stock - 0.9) / (port - 0.9) = n/(n-1)
    for a fresh layer (running variance 1). rtol 1e-5: a ratio of two float32
    blends of the same variance."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(1.0, 3.0, (2, 5, 3, 3)).astype(np.float32))
    n = 2 * 3 * 3
    port, stock = tl.BatchNorm(5), torch.nn.BatchNorm2d(5, momentum=0.1, eps=1e-5)
    port.train()(x)
    stock.train()(x)
    ratio = (stock.running_var - 0.9) / (port.running_var - 0.9)
    np.testing.assert_allclose(ratio.numpy(), np.full(5, n / (n - 1)), rtol=1e-5)
    biased = x.permute(1, 0, 2, 3).reshape(5, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(port.running_var.numpy(), (0.9 + 0.1 * biased).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(), stock.running_mean.numpy(), rtol=1e-6)


def test_batchnorm_keeps_bf16_and_computes_in_float32():
    """A bf16 input comes out bf16 in both modes, normalised in float32 and
    rounded once (flax's ``dtype=x.dtype`` BatchNorm): within one bf16 ulp
    (2^-8 relative) of the float32 layer's output on the same bf16 values."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (4, 6, 5, 5)).astype(np.float32)).bfloat16()
    bn = tl.BatchNorm(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.running_var.uniform_(0.5, 1.5)
        bn.running_mean.normal_()
    for train in (False, True):
        bn.train(train)
        with torch.no_grad():
            y, y32 = bn(x), bn(x.float())
        assert y.dtype == torch.bfloat16
        torch.testing.assert_close(y.float(), y32, rtol=2 ** -8, atol=1e-6)
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
