"""The port's float32 and bf16 SSDLite train steps against the JAX package's
step of the same type, with every BatchNorm on its running statistics.

With batch statistics the step's backward is ill-conditioned (the bf16
update of either package lies more than the largest update from the
float64 one; ``tests/test_torch_port_lite_train_lowp.py``), so nothing
could hold the bf16 backward there. On running statistics (JAX's model
applied with ``train=False``, the port's BatchNorms kept in eval mode) the
same step is well-conditioned, and the port's bf16 step, the cast of every
convolution and its backward included, is held directly against JAX's.

Limits, for each of two steps: the losses' relative error and the largest
update error over the largest update (:func:`test_torch_port_lite_train.errors`).
Float32: 1e-6 and 1e-4 (measured 9.6e-8, 8.1e-6; then 1.4e-7, 4.8e-6). Bf16:
2e-3 and 0.5 (measured 2.0e-4, 0.27; then 3.8e-4, 0.23; JAX's own bf16 step
lies 0.32 and 0.24 from float64; the largest error sits at the first
convolution's weight, whose gradient sums bf16 products over every pixel).
A state left unchanged reads an update error of 1.0, and the port's step on
half the batch reads losses 0.23 and updates 1.23 (float32) or 1.31 (bf16):
the test checks that the half batch fails.
"""

import pytest

from test_torch_port_lite_train import _batch, errors, jax_steps, port_steps
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

LIMITS = {"float32": (1e-6, 1e-4), "bf16": (2e-3, 0.5)}


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_lite_train_steps_equal_jax_on_running_statistics(dtype):
    loss_limit, update_limit = LIMITS[dtype]
    jax = jax_steps(dtype, frozen=True)
    for step, (loss, upd, stat) in enumerate(errors(port_steps(dtype, frozen=True), jax), 1):
        print(f"{dtype} step {step}: loss {loss:.2e}, update {upd:.2e}")
        assert loss < loss_limit and upd < update_limit, (dtype, step, loss, upd)
        assert stat == 0.0
    half = {k: v[:2] for k, v in _batch().items()}
    loss, upd, _ = errors(port_steps(dtype, frozen=True, batch=half), jax)[0]
    print(f"{dtype} half batch, step 1: loss {loss:.2e}, update {upd:.2e}")
    assert loss > loss_limit and upd > update_limit
