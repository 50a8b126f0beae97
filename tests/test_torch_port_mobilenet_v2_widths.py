"""SSDLite forward of the four MobileNetV2 widths in the port against the
JAX package; the check and its tolerances are
``tests/test_torch_port_mobilenet_widths.py::check_forward``."""

import pytest

from test_torch_port_mobilenet import one_torch_thread  # noqa: F401
from test_torch_port_mobilenet_widths import WIDTHS, check_forward


@pytest.mark.parametrize("net", [f"mobilenet_v2{w}" for w in WIDTHS])
def test_ssd_lite_forward_equals_jax(net):
    check_forward(net, seed=4 + WIDTHS.index(net[len("mobilenet_v2"):]))
