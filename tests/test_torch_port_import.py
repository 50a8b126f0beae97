"""The port imports no JAX, and its config and anchors equal the JAX package's."""

import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import ssds_tpu_torch
from ssds_tpu import config as jcfg
from ssds_tpu.ops import anchors as janchors
from ssds_tpu_torch import config as tcfg
from ssds_tpu_torch.models.builder import create_model, create_priors
from ssds_tpu_torch.ops import anchors as tanchors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
import sys
for m in {mods!r}:
    __import__(m)
# the GPU machine has no jax, flax, PyYAML or OpenCV: none may load on import
bad = sorted(m for m in ("jax", "flax", "ssds_tpu", "yaml", "cv2") if m in sys.modules)
assert not bad, f"importing the port loaded {{bad}}"
print("port-import-clean:", len({mods!r}), "modules")
"""


def test_port_imports_no_jax_flax_yaml_or_cv2():
    mods = ["ssds_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ssds_tpu_torch.__path__, prefix="ssds_tpu_torch.")]
    for needed in ("ssds_tpu_torch.detector", "ssds_tpu_torch.ops.postprocess",
                   "ssds_tpu_torch.models.builder", "ssds_tpu_torch.ops.cuda.nms",
                   "ssds_tpu_torch.ops.conv", "ssds_tpu_torch.ops.stencil",
                   "ssds_tpu_torch.ops.cuda.conv", "ssds_tpu_torch.ops.cuda.stencil",
                   "ssds_tpu_torch.tools.conv_bench", "ssds_tpu_torch.tools.conv_probes"):
        assert needed in mods
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHECK.format(mods=mods)], env=env,
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "port-import-clean:" in proc.stdout


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def test_default_config_equals_jax_key_by_key():
    want, got = _flat(jcfg.default_config()), _flat(tcfg.default_config())
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "experiments/cfgs/*.yml"))),
                         ids=os.path.basename)
def test_cfg_from_file_equals_jax(path):
    assert _flat(tcfg.cfg_from_file(path)) == _flat(jcfg.cfg_from_file(path))


def _small_cfg():
    cfg = tcfg.default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    return cfg


@pytest.mark.parametrize("which", ["ssd300", "small_64px", "explicit_sizes_steps"])
def test_anchors_bit_equal_to_jax(which):
    cfg = tcfg.default_config() if which == "ssd300" else _small_cfg()
    if which == "explicit_sizes_steps":
        cfg.MODEL.SIZES = [0.1, 0.3, 0.6, 0.9]
        cfg.MODEL.STEPS = [8, 16, 32]
        cfg.MODEL.CLIP = False
    _, fmaps = create_model(cfg.MODEL)
    got = create_priors(cfg.MODEL, fmaps)
    want = janchors.generate_anchors(janchors.AnchorConfig(
        image_size=tuple(cfg.MODEL.IMAGE_SIZE), feature_maps=tuple(fmaps),
        aspect_ratios=tuple(tuple(a) for a in cfg.MODEL.ASPECT_RATIOS),
        sizes=tuple(cfg.MODEL.SIZES), steps=tuple(cfg.MODEL.STEPS),
        clip=bool(cfg.MODEL.CLIP)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tanchors.num_anchors_per_cell(cfg.MODEL.ASPECT_RATIOS) == \
        janchors.num_anchors_per_cell(cfg.MODEL.ASPECT_RATIOS)
    if which == "ssd300":
        assert got.shape == (8732, 4)
