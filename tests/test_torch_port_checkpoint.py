"""The port's checkpoints: format, manifest, atomic save, scoped graft, and
the scope vocabulary against the JAX package's on every SSD300 parameter."""

import functools
import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from ssds_tpu import checkpoint as jax_ckpt
from ssds_tpu.config import default_config as jax_default_config
from ssds_tpu.models import builder as jbuilder
from ssds_tpu_torch import checkpoint as ckpt
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.detector import ObjectDetector
from ssds_tpu_torch.weights import port_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=1)
def ssd300_flax_paths():
    """Every parameter path of the JAX package's SSD300-VGG16 (shapes only)."""
    jcfg = jax_default_config()
    jcfg.MODEL.S2D_STEM = 0
    jmodel, _ = jbuilder.create_model(jcfg.MODEL)
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 300, 300, 3)), phase="train"),
                            jax.random.PRNGKey(0))
    return tuple(tuple(str(p) for p in k)
                 for k in traverse_util.flatten_dict(shapes["params"]))


def config_scopes():
    """Every TRAINABLE_SCOPE and RESUME_SCOPE of the defaults and the
    experiment configs, a scope matching nothing, and single words."""
    scopes = {default_config().TRAIN.TRAINABLE_SCOPE, "", "bogus_scope_word_zzz",
              "base", "norm", "extras", "loc", "conf", "loc,conf"}
    for path in glob.glob(os.path.join(REPO, "experiments/cfgs/*.yml")):
        with open(path) as f:
            train = (yaml.safe_load(f) or {}).get("TRAIN", {})
        scopes.update(str(train[k]) for k in ("TRAINABLE_SCOPE", "RESUME_SCOPE") if k in train)
    return sorted(scopes)


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"base.0.weight": torch.randn(4, 3, 3, 3, generator=g),
            "base.0.bias": torch.randn(4, generator=g),
            "norm.weight": torch.randn(4, generator=g),
            "extras.1.weight": torch.randn(2, 4, 1, 1, generator=g),
            "loc.0.weight": torch.randn(8, 4, 3, 3, generator=g),
            "conf.0.bias": torch.randn(6, generator=g)}


@pytest.mark.parametrize("scope", config_scopes())
def test_path_in_scope_equals_jax_on_every_ssd300_param(scope):
    paths = ssd300_flax_paths()
    assert len(paths) == 71  # 15 VGG + 8 extra convs, 6 loc + 6 conf heads, the L2Norm scale
    for path in paths:
        name = port_name("/".join(path))
        assert ckpt.path_in_scope(name, scope) == jax_ckpt.path_in_scope(path, scope), \
            (scope, path, name)


def test_round_trip_manifest_and_graft(tmp_path):
    sd = _tiny_state(0)
    p3 = ckpt.save_checkpoint(str(tmp_path), "t", 3, sd)
    p7 = ckpt.save_checkpoint(str(tmp_path), "t", 7, _tiny_state(1))
    assert os.path.basename(p3) == "t_epoch_3.pth"
    with open(tmp_path / ckpt.MANIFEST) as f:
        assert f.read() == "epoch 3:t_epoch_3.pth\nepoch 7:t_epoch_7.pth\n"
    assert ckpt.find_previous(str(tmp_path)) == ([3, 7], [p3, p7])
    raw = torch.load(p3, weights_only=True)
    assert set(raw) == {"state_dict", "epoch"} and raw["epoch"] == 3

    fresh = {k: torch.zeros_like(v) for k, v in sd.items()}
    back = ckpt.resume_checkpoint(fresh, p3)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    grafted = ckpt.resume_checkpoint(fresh, p3, "base,norm")
    for k in sd:
        want = sd[k] if k.split(".")[0] in ("base", "norm") else fresh[k]
        assert torch.equal(grafted[k], want), k


def test_resume_takes_keys_in_both_and_matching_shapes(tmp_path, capsys):
    sd = _tiny_state(0)
    theirs = dict(sd)
    theirs["extra.thing"] = torch.ones(2)
    theirs["loc.0.weight"] = torch.ones(9, 4, 3, 3)  # another shape
    del theirs["conf.0.bias"]
    # a bare state dict with DataParallel prefixes, as ssds.pytorch saves one
    path = tmp_path / "ref.pth"
    torch.save({"module." + k: v for k, v in theirs.items()}, path)
    fresh = {k: torch.zeros_like(v) for k, v in sd.items()}
    out = ckpt.resume_checkpoint(fresh, str(path))
    assert torch.equal(out["base.0.weight"], sd["base.0.weight"])
    assert torch.equal(out["loc.0.weight"], fresh["loc.0.weight"])
    assert torch.equal(out["conf.0.bias"], fresh["conf.0.bias"])
    said = capsys.readouterr().out
    assert "2 checkpoint keys unresolved" in said and "1 model keys not in checkpoint" in said
    assert "loaded 4/6" in said


def test_torn_save_is_never_listed(tmp_path):
    sd = _tiny_state(0)
    ckpt.save_checkpoint(str(tmp_path), "t", 1, sd)
    with mock.patch.object(torch, "save", side_effect=OSError("disk full")):
        with pytest.raises(OSError):
            ckpt.save_checkpoint(str(tmp_path), "t", 2, sd)
    assert os.path.exists(tmp_path / "t_epoch_2.pth.tmp")
    assert not os.path.exists(tmp_path / "t_epoch_2.pth")
    # a manifest line whose file is gone is skipped too
    with open(tmp_path / ckpt.MANIFEST, "a") as f:
        f.write("epoch 5:t_epoch_5.pth\n")
    epochs, paths = ckpt.find_previous(str(tmp_path))
    assert epochs == [1] and paths == [str(tmp_path / "t_epoch_1.pth")]
    assert ckpt.find_previous(str(tmp_path / "nowhere")) is False


def test_async_checkpointer_copies_then_writes(tmp_path):
    sd = {k: v.clone() for k, v in _tiny_state(0).items()}
    want = {k: v.clone() for k, v in sd.items()}
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path), "a", 1, sd)
    for v in sd.values():  # the next training step overwrites the weights
        v.add_(1.0)
    writer.close()
    got = ckpt.load_state_dict_file(str(tmp_path / "a_epoch_1.pth"))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not writer._worker.is_alive()

    failing = ckpt.AsyncCheckpointer()
    with mock.patch.object(ckpt, "save_checkpoint", side_effect=OSError("disk full")):
        failing.save(str(tmp_path), "b", 1, sd)
        with pytest.raises(RuntimeError, match="checkpoint write failed"):
            failing.wait()
    failing._error = None
    failing.close()


def test_object_detector_loads_the_checkpoint(tmp_path):
    cfg = default_config()
    cfg.MODEL.IMAGE_SIZE = [64, 64]
    cfg.MODEL.FEATURE_LAYER = [[22, 34, "S"], [512, 1024, 512]]
    cfg.MODEL.ASPECT_RATIOS = [[2], [2, 3], [2, 3]]
    cfg.MODEL.HALF_PRECISION = False
    src = ObjectDetector(cfg, device="cpu", seed=3)
    path = ckpt.save_checkpoint(str(tmp_path), "d", 4, src.model.state_dict())
    cfg.RESUME_CHECKPOINT = path
    det = ObjectDetector(cfg, device="cpu", seed=9)
    for (k, a), b in zip(src.model.state_dict().items(), det.model.state_dict().values()):
        assert torch.equal(a, b), k
    img = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    assert torch.equal(src.detect_rows(img), det.detect_rows(img))
