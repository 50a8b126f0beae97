"""The 5-class mAP oracle through the port's CLIs (``slow``), VOC and COCO.

The same generated 5-class, 100-image VOC (``make_multiclass_voc``) and COCO
(``make_multiclass_coco``: the same scenes as COCO JSON, 192 px images
resized to 96) and the same configs (SSDLite over MobileNetV1-0.25 at 96 px,
50 epochs, LR step at 35) as the JAX package's oracle
(``tests/test_multiclass_map_cli.py``), run through ``python -m
ssds_tpu_torch.train --device cpu`` and then ``python -m ssds_tpu_torch.test
--device cpu``. The bars are JAX's: the VOC mAP the test CLI prints must
reach 0.9; on COCO, AP50 0.9 and AP@[.50:.95] 0.5 (the port's COCOeval).
"""

import os
import subprocess
import sys

import pytest

from test_multiclass_map_cli import CFG, CFG_COCO, make_multiclass_coco, make_multiclass_voc

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


@pytest.mark.slow
def test_multiclass_coco_ap_through_the_port_cli_chain(tmp_path):
    root, exp = str(tmp_path / "coco"), str(tmp_path / "exp")
    make_multiclass_coco(root, n_images=100)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        f.write(CFG_COCO.format(root=root, exp=exp, epochs=50, lr_step=35))

    train = _cli("ssds_tpu_torch.train", cfg_path)
    assert train.returncode == 0, train.stdout[-3000:] + train.stderr[-3000:]
    test = _cli("ssds_tpu_torch.test", cfg_path)
    assert test.returncode == 0, test.stdout[-3000:] + test.stderr[-3000:]
    line = [ln for ln in test.stdout.splitlines() if ln.startswith("test: mAP=")]
    assert line, test.stdout[-3000:]
    ap = float(line[-1].split("mAP=")[1])
    ap50 = [ln for ln in test.stdout.splitlines() if "IoU=0.50 " in ln and "(AP)" in ln]
    assert ap50, test.stdout[-3000:]
    ap50 = float(ap50[-1].rsplit("=", 1)[1])
    print(f"port COCO CLI oracle: AP={ap:.4f} AP50={ap50:.4f}")
    assert ap50 >= 0.9, f"the port's COCO CLI chain reached AP50={ap50} (AP={ap})"
    assert ap >= 0.5, f"the port's COCO CLI chain reached AP={ap}"
