"""Host against device augmentation at the mAP level through the port's CLIs
(``slow``): ``ssds_tpu_torch.tools.aug_map_parity.run_one`` on the CPU, the
JAX package's protocol and bars (``tests/test_device_aug_map_parity.py``):
the 5-class generated VOC trained 120 epochs with the LR step at 90, once
with the host's augmentation and once with ``DATASET.DEVICE_AUG``; both mAPs
at least 0.95, their difference at most 0.05."""

import time

import pytest

pytestmark = pytest.mark.slow


def test_host_and_device_aug_reach_equivalent_map_through_the_port(tmp_path):
    from ssds_tpu_torch.tools.aug_map_parity import run_one

    epochs, lr_step = 120, 90
    t0 = time.perf_counter()
    map_host = run_one(False, str(tmp_path), epochs, lr_step, device="cpu")
    map_dev = run_one(True, str(tmp_path), epochs, lr_step, device="cpu")
    print(f"port aug mAP parity: host {map_host:.4f}, device {map_dev:.4f}, "
          f"{time.perf_counter() - t0:.0f} s")
    assert map_host >= 0.95, f"host-aug mAP {map_host}"
    assert map_dev >= 0.95, f"device-aug mAP {map_dev}"
    assert abs(map_host - map_dev) <= 0.05, (map_host, map_dev)
