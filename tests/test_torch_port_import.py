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
# the GPU machine has no jax, flax, PyYAML, OpenCV or TensorBoard: none may load on import
bad = sorted(m for m in ("jax", "flax", "ssds_tpu", "yaml", "cv2", "tensorboard", "tensorboardX")
             if m in sys.modules)
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
                   "ssds_tpu_torch.tools.conv_bench", "ssds_tpu_torch.tools.conv_probes",
                   "ssds_tpu_torch.ops.matching", "ssds_tpu_torch.ops.losses",
                   "ssds_tpu_torch.checkpoint", "ssds_tpu_torch.solver",
                   "ssds_tpu_torch.data.augment", "ssds_tpu_torch.data.voc_eval",
                   "ssds_tpu_torch.data.voc", "ssds_tpu_torch.data.factory",
                   "ssds_tpu_torch.train", "ssds_tpu_torch.test",
                   "ssds_tpu_torch.profile_training", "ssds_tpu_torch.tools.synth_voc",
                   "ssds_tpu_torch.models.backbones.mobilenet",
                   "ssds_tpu_torch.models.heads.ssd_lite", "ssds_tpu_torch.tools.step_parity",
                   "ssds_tpu_torch.data.coco", "ssds_tpu_torch.data.coco_eval",
                   "ssds_tpu_torch.data.image_ops", "ssds_tpu_torch.data.native",
                   "ssds_tpu_torch.tools.synth_coco", "ssds_tpu_torch.models.heads.fssd",
                   "ssds_tpu_torch.models.heads.fssd_lite", "ssds_tpu_torch.models.heads.rfb",
                   "ssds_tpu_torch.models.heads.rfb_lite", "ssds_tpu_torch.ops.yolo",
                   "ssds_tpu_torch.models.heads.yolo", "ssds_tpu_torch.models.backbones.darknet",
                   "ssds_tpu_torch.models.backbones.resnet", "ssds_tpu_torch.export",
                   "ssds_tpu_torch.quant", "ssds_tpu_torch.ops.quant",
                   "ssds_tpu_torch.ops.cuda.int8_conv", "ssds_tpu_torch.ops.augment_device",
                   "ssds_tpu_torch.tools.int8_bench", "ssds_tpu_torch.parallel.sharding",
                   "ssds_tpu_torch.parallel.spatial",
                   "ssds_tpu_torch.utils.profiler", "ssds_tpu_torch.utils.timer",
                   "ssds_tpu_torch.utils.visualize", "ssds_tpu_torch.utils.summary",
                   "ssds_tpu_torch.demo", "ssds_tpu_torch.tools.parity_check",
                   "ssds_tpu_torch.tools.aug_map_parity"):
        assert needed in mods
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CHECK.format(mods=mods)], env=env,
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "port-import-clean:" in proc.stdout


def _imports_in_functions(path, module):
    """``[(enclosing function, line)]`` of every import of ``module`` in ``path``."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else func
            if isinstance(child, ast.Import) and any(
                    a.name.split(".")[0] == module for a in child.names):
                found.append((func, child.lineno))
            elif isinstance(child, ast.ImportFrom) and (child.module or "").split(".")[0] == module:
                found.append((func, child.lineno))
            visit(child, name)

    visit(tree, None)
    return found


def test_only_the_image_read_hooks_import_cv2_and_only_cfg_loading_imports_yaml():
    """OpenCV only inside the VOC and COCO datasets' ``_read_image`` (JPEG
    decoding), the parity harness's ``_read_image`` (its ``--image``) and the
    demo's ``_cv2`` (its image, video and camera modes);
    PyYAML only inside ``cfg_from_file`` / ``cfg_from_list``; the
    augmentation and the detector do not name OpenCV at all."""
    sources = sorted(glob.glob(os.path.join(REPO, "ssds_tpu_torch", "**", "*.py"), recursive=True))
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    cv2_sites, yaml_sites = [], []
    for path in sources:
        rel = os.path.relpath(path, REPO)
        cv2_sites += [(rel, func) for func, _ in _imports_in_functions(path, "cv2")]
        yaml_sites += [(rel, func) for func, _ in _imports_in_functions(path, "yaml")]
    assert sorted(cv2_sites) == [("ssds_tpu_torch/data/coco.py", "_read_image"),
                                 ("ssds_tpu_torch/data/voc.py", "_read_image"),
                                 ("ssds_tpu_torch/demo.py", "_cv2"),
                                 ("ssds_tpu_torch/tools/parity_check.py", "_read_image")]
    assert sorted(yaml_sites) == [("ssds_tpu_torch/config.py", "cfg_from_file"),
                                  ("ssds_tpu_torch/config.py", "cfg_from_list")]
    for rel in ("ssds_tpu_torch/data/augment.py", "ssds_tpu_torch/detector.py"):
        with open(os.path.join(REPO, rel)) as f:
            assert "cv2" not in f.read(), rel


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


def test_chip_smoke_main_binds_kind_once():
    """``chip_smoke.main`` prints ``kind`` (the card's name) in its last line:
    no loop, comprehension or assignment in ``main`` may bind that name again
    (a phase's loop over model kinds did, twice)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    bound = []
    for node in ast.walk(main):
        targets = ([node.target] if isinstance(node, (ast.For, ast.comprehension))
                   else node.targets if isinstance(node, ast.Assign) else [])
        bound += [node.lineno if hasattr(node, "lineno") else None for t in targets
                  for n in ast.walk(t) if isinstance(n, ast.Name) and n.id == "kind"]
    assert len(bound) == 1, f"main binds `kind` at lines {bound}"
