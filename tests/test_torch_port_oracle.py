"""The 5-class mAP oracle through the port's CLIs (``slow``).

The same generated 5-class, 100-image VOC (``make_multiclass_voc``) and the
same config (SSDLite over MobileNetV1-0.25 at 96 px, 50 epochs, LR step at
35) as the JAX package's oracle (``tests/test_multiclass_map_cli.py``), run
through ``python -m ssds_tpu_torch.train --device cpu`` and then
``python -m ssds_tpu_torch.test --device cpu``: the mAP the test CLI prints
must reach 0.9.
"""

import os
import subprocess
import sys

import pytest

from test_multiclass_map_cli import CFG, make_multiclass_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(module, cfg_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", module, "--cfg", cfg_path, "--device", "cpu"],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=3600)


@pytest.mark.slow
def test_multiclass_map_through_the_port_cli_chain(tmp_path):
    root, exp = str(tmp_path / "VOCdevkit"), str(tmp_path / "exp")
    make_multiclass_voc(root, n_images=100)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, exp=exp, epochs=50, lr_step=35))

    train = _cli("ssds_tpu_torch.train", cfg_path)
    assert train.returncode == 0, train.stdout[-3000:] + train.stderr[-3000:]
    test = _cli("ssds_tpu_torch.test", cfg_path)
    assert test.returncode == 0, test.stdout[-3000:] + test.stderr[-3000:]
    line = [ln for ln in test.stdout.splitlines() if ln.startswith("test: mAP=")]
    assert line, test.stdout[-3000:]
    m_ap = float(line[-1].split("mAP=")[1])
    print(f"port CLI oracle: mAP={m_ap:.4f}")
    assert m_ap >= 0.9, f"the port's CLI chain reached only mAP={m_ap}"
