"""The port's mAP-parity harness (``ssds_tpu_torch.tools.parity_check``)
against the JAX package's (``tools/parity_check.py``).

Model: SSDLite over MobileNetV1-0.25 at 96 px, float32
(``tests/test_solver_e2e.py::CFG_TEMPLATE``, ``PROB -1``, no loader workers:
the JAX package runs in this process). Checked:

- the acceptance table and tolerance equal JAX's; each row's written-out
  config (``config.YML_MAKERS``, read where PyYAML is missing) equal to its
  yml;
- stage 1 against JAX's: a reference-layout ``.pth`` fabricated from seeded
  JAX variables (``tests/test_torch_import_families.py::_export_sd`` with
  the port's names, :func:`v1_key`: ``ssd_lite_key`` names the base as
  MobileNetV2's and the predictors' pointwise convs ``.3``, which JAX's
  lenient importer takes and the port's audit reports) goes through
  JAX's ``stage_import`` and the port's; the audit is healthy and the
  port's state dict is bit for bit ``weights.state_dict_from_jax`` of JAX's
  imported variables; a renamed key, a changed shape, ``module.`` prefixes
  and a bare dict;
- stage 3 against JAX's ``stage_map``: one ``.pth`` scored by both on the
  same ``make_voc`` tree (8 JPEGs), seeded weights and a model the port's
  Solver trained to saturation, within ``MAP_TOLERANCE``; without OpenCV the
  stage stops and names it;
- stage 2 on a fake reference checkout written here (its
  ``create_model`` returns the port's model): 0 for ``loc`` and ``conf``, a
  non-zero max|d| with one weight perturbed inside the fake, ``SKIP`` for an
  empty directory;
- the CLI in fresh processes on the CPU: ``--selftest``, ``--when-data
  --table-only`` with and without PyYAML, ``--when-data`` (the round-trip
  oracle), and a full run on a trained checkpoint.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from ssds_tpu.config import cfg_from_file as jax_cfg_from_file
from ssds_tpu.models.builder import create_model as jax_create_model
from ssds_tpu.models.builder import init_model as jax_init_model
from ssds_tpu_torch import config as tconfig
from ssds_tpu_torch.checkpoint import audit_state_dict, load_state_dict_file
from ssds_tpu_torch.models.builder import create_model, init_model
from ssds_tpu_torch.tools import parity_check as pc
from ssds_tpu_torch.weights import state_dict_from_jax
from test_solver_e2e import CFG_TEMPLATE, make_voc
from test_torch_import_families import _export_sd, ssd_lite_key
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "tools"))
import parity_check as jax_pc  # noqa: E402  (the JAX package's tools/parity_check.py)

TRAIN_EPOCHS = 80  # the port's oracle's epochs: mAP 1.0 on make_voc's 8 images


def _cfg_text(root, exp, epochs=1):
    return CFG_TEMPLATE.format(root=root, exp=exp, epochs=epochs, ckpt_epochs=epochs,
                               prob=-1).replace("NUM_WORKERS: 2", "NUM_WORKERS: 0")


def v1_key(path):
    """``ssd_lite_key`` with the names of the port's SSDLite over MobileNetV1
    (the reference's layout as the port loads it): a ``conv_dw`` base block
    is a plain Sequential, ``base.{i}.{k}``, and a predictor's pointwise conv
    is ``{loc,conf}.{k}.2``, after the depthwise conv and its ReLU."""
    key = ssd_lite_key(path)
    if key.startswith("base."):
        return key.replace(".conv.", ".", 1)
    return key[:-2] + ".2" if key.startswith(("loc.", "conf.")) and key.endswith(".3") else key


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``make_voc``'s 8 JPEGs (train and test the same), the config file."""
    tmp = tmp_path_factory.mktemp("voc")
    root = str(tmp / "VOCdevkit")
    make_voc(root, n_images=8)
    path = tmp / "cfg.yml"
    path.write_text(_cfg_text(root, str(tmp / "exp"), TRAIN_EPOCHS))
    return str(path)


@pytest.fixture(scope="module")
def fabricated(tree, tmp_path_factory):
    """``(pth, JAX variables)``: seeded JAX variables (BatchNorm statistics
    moved off their init) saved in the reference's layout."""
    jcfg = jax_cfg_from_file(tree)
    model, _ = jax_create_model(jcfg.MODEL)
    variables = jax_init_model(model, jcfg.MODEL, jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape).astype(np.float32), variables)
    pth = str(tmp_path_factory.mktemp("fab") / "fabricated.pth")
    torch.save({"state_dict": _export_sd(variables, v1_key)}, pth)
    return pth, variables


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """A ``.pth`` of the port's Solver trained on ``tree`` to saturation."""
    from ssds_tpu_torch.solver import Solver

    cfg = pc.load_cfg(tree)
    cfg.EXP_DIR = str(tmp_path_factory.mktemp("exp"))
    cfg.LOG_DIR = os.path.join(cfg.EXP_DIR, "logs")
    solver = Solver(cfg, device="cpu")
    try:
        solver.train_model()
        direct = solver.test_model()
    finally:
        solver.close()
    pth = os.path.join(cfg.EXP_DIR, "trained.pth")
    torch.save({"state_dict": solver.model.state_dict()}, pth)
    return pth, direct


# -- the table ------------------------------------------------------------------------


def test_acceptance_table_and_tolerance_equal_jax():
    assert pc.MAP_TOLERANCE == jax_pc.MAP_TOLERANCE == 0.001
    assert pc.ACCEPTANCE == jax_pc.ACCEPTANCE
    assert sorted(tconfig.YML_MAKERS) == sorted(row[0] for row in pc.ACCEPTANCE)


@pytest.mark.parametrize("yml", [row[0] for row in pc.ACCEPTANCE])
def test_row_maker_equals_its_yml(yml):
    """The config a row is built from without PyYAML is its yml's, key for
    key and type for type."""
    made = tconfig.YML_MAKERS[yml]()
    read = tconfig.cfg_from_file(os.path.join(REPO, "experiments", "cfgs", yml))
    assert made == read

    def types(t):
        return {k: types(v) if isinstance(v, dict) else type(v) for k, v in t.items()}

    assert types(made) == types(read)


# -- stage 1 ----------------------------------------------------------------------------


def test_stage1_equals_jax_import(tree, fabricated):
    """The same ``.pth`` through JAX's ``stage_import`` and the port's
    stage 1: healthy, and the port's weights are the bridge's of JAX's
    imported variables, bit for bit."""
    pth, variables = fabricated
    _, _, imported = jax_pc.stage_import(jax_cfg_from_file(tree), pth)
    tcfg = pc.load_cfg(tree)
    sd, audit = pc.stage_import(tcfg, pth)
    assert audit.healthy and len(audit.matched) == 152
    want = state_dict_from_jax(imported, net=tcfg.MODEL.NETS, ssds=tcfg.MODEL.SSDS,
                               feature_layer=tcfg.MODEL.FEATURE_LAYER)
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    # and JAX's import placed every tensor where it came from
    flat, got = traverse_util.flatten_dict(variables), traverse_util.flatten_dict(imported)
    assert sorted(flat) == sorted(got)
    assert all(np.array_equal(np.asarray(got[p]), a) for p, a in flat.items())


def _fault(sd, fault):
    sd = dict(sd)
    if fault == "renamed":
        sd["base.0.0.kernel"] = sd.pop("base.0.0.weight")
    elif fault == "shape":
        sd["conf.0.2.weight"] = sd["conf.0.2.weight"][:-1]
    elif fault == "module_prefix":
        return {"state_dict": {"module." + k: v for k, v in sd.items()}}
    return sd if fault == "bare_dict" else {"state_dict": sd}


FAULTS = {  # fault -> (missing, unexpected, shape-mismatched)
    "renamed": (1, 1, 0), "shape": (0, 0, 1), "module_prefix": (0, 0, 0), "bare_dict": (0, 0, 0),
    "ssd_lite_key": (138, 138, 0)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_stage1_reports_each_group(fault, tree, fabricated, tmp_path, capsys):
    """A renamed key is 1 missing and 1 unexpected, a changed shape 1
    shape-mismatched (both unhealthy, the rest loaded and the partial load
    printed); ``module.`` prefixes and a bare dict are healthy.
    ``ssd_lite_key``'s own names (MobileNetV2's ``base.{i}.conv.{k}`` for
    the 13 ``conv_dw`` blocks' 10 tensors, ``{loc,conf}.{k}.3`` for the 4
    pointwise convs' 2), which JAX's importer takes, miss 138."""
    pth, variables = fabricated
    sd = load_state_dict_file(pth)
    bad = str(tmp_path / "bad.pth")
    torch.save({"state_dict": _export_sd(variables, ssd_lite_key)} if fault == "ssd_lite_key"
               else _fault(sd, fault), bad)
    tcfg = pc.load_cfg(tree)
    got, audit = pc.stage_import(tcfg, bad)
    missing, unexpected, shape = FAULTS[fault]
    assert (len(audit.missing), len(audit.unexpected), len(audit.shape_mismatched)) == (
        missing, unexpected, shape)
    assert audit.healthy == (missing + unexpected + shape == 0)
    out = capsys.readouterr().out
    assert ("UNHEALTHY: partial load" in out) != audit.healthy
    assert f"missing: {missing}" in out and f"shape_mismatched: {shape}" in out
    for k in audit.matched:
        assert torch.equal(got[k], sd[k]), k
    assert audit == audit_state_dict(init_model(create_model(tcfg.MODEL)[0]).state_dict(),
                                     load_state_dict_file(bad))


# -- stage 3 ----------------------------------------------------------------------------


def _jax_map(tree, pth, tmp_path):
    jcfg = jax_cfg_from_file(tree)
    jcfg.EXP_DIR, jcfg.LOG_DIR = str(tmp_path / "jax_exp"), str(tmp_path / "jax_exp" / "logs")
    _, _, imported = jax_pc.stage_import(jcfg, pth)
    return jax_pc.stage_map(jcfg, imported)


@pytest.mark.parametrize("weights", ["seeded", "trained"])
def test_stage3_equals_jax_stage_map(weights, tree, fabricated, trained, tmp_path):
    """One ``.pth`` scored by JAX's ``stage_map`` and the port's stage 3 on
    the same JPEG tree: within ``MAP_TOLERANCE``; the trained model's mAP is
    its Solver's before saving (1.0)."""
    pth = fabricated[0] if weights == "seeded" else trained[0]
    sd, audit = pc.stage_import(pc.load_cfg(tree), pth)
    assert audit.healthy
    m_port = pc.stage_map(pc.load_cfg(tree), sd, "cpu")
    m_jax = _jax_map(tree, pth, tmp_path)
    print(f"{weights}: port stage 3 mAP {m_port:.4f}, JAX stage_map {m_jax:.4f}")
    assert abs(m_port - m_jax) <= pc.MAP_TOLERANCE
    if weights == "trained":
        assert m_port == pytest.approx(trained[1], abs=pc.MAP_TOLERANCE) and m_port >= 0.99


def test_stage3_without_opencv_stops_and_names_it(tree, fabricated, monkeypatch):
    sd, _ = pc.stage_import(pc.load_cfg(tree), fabricated[0])
    monkeypatch.setitem(sys.modules, "cv2", None)  # as on a machine without OpenCV
    with pytest.raises(SystemExit, match="image decoder cv2 .OpenCV. is not installed"):
        pc.stage_map(pc.load_cfg(tree), sd, "cpu")
    with pytest.raises(SystemExit, match="needs OpenCV"):
        pc._read_image("any.jpg")


def test_stage3_skips_an_absent_dataset(tree, fabricated, tmp_path, capsys):
    cfg = pc.load_cfg(tree)
    cfg.DATASET.DATASET_DIR = str(tmp_path / "absent")
    assert pc.stage_map(cfg, {}, "cpu") is None
    assert "SKIP: dataset directory absent" in capsys.readouterr().out


# -- stage 2 ----------------------------------------------------------------------------

FAKE_BUILDER = r'''
import torch
from ssds_tpu_torch.models.builder import create_model as _create, init_model

PERTURB = {perturb}


def create_model(model_cfg):
    model, fmaps = _create(model_cfg)
    model = init_model(model, seed=5)
    if PERTURB:  # one weight moved after whatever the caller loads
        def hook(module, args):
            if not getattr(module, "_moved", False):
                with torch.no_grad():
                    module.base[0][0].weight[0, 0, 0, 0] += 0.5
                module._moved = True
        model.register_forward_pre_hook(hook)
    return model, fmaps
'''

FAKE_CONFIG = r'''
from ssds_tpu_torch.config import cfg_from_file as _read

cfg = None


def cfg_from_file(path):
    global cfg
    cfg = _read(path)
'''


def _fake_checkout(root, perturb):
    for d in ("lib", "lib/modeling", "lib/utils"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
        open(os.path.join(root, d, "__init__.py"), "w").close()
    with open(os.path.join(root, "lib/modeling/model_builder.py"), "w") as f:
        f.write(FAKE_BUILDER.format(perturb=perturb))
    with open(os.path.join(root, "lib/utils/config_parse.py"), "w") as f:
        f.write(FAKE_CONFIG)
    return root


@pytest.mark.parametrize("case", ["equal", "perturbed", "empty", "no_modules"])
def test_stage2_on_a_fake_reference(case, tree, fabricated, tmp_path, capsys):
    pth = fabricated[0]
    cfg = pc.load_cfg(tree)
    sd, _ = pc.stage_import(cfg, pth)
    ref = str(tmp_path / "reference")
    os.makedirs(ref)
    if case in ("equal", "perturbed"):
        _fake_checkout(ref, case == "perturbed")
    elif case == "no_modules":
        open(os.path.join(ref, "README"), "w").close()
    table = pc.stage_activation_diff(cfg, tree, pth, ref, sd)
    out = capsys.readouterr().out
    if case == "empty":
        assert table is None and "SKIP: reference checkout absent or empty" in out
    elif case == "no_modules":
        assert table is None and "SKIP: cannot import the reference's modules" in out
    elif case == "equal":
        assert sorted(table) == ["conf", "loc"]
        assert all(t[0] == 0.0 and t[2] > 0 for t in table.values()), table
        assert "loc: max|d|=0.000e+00" in out and "conf: max|d|=0.000e+00" in out
    else:
        assert all(t[0] > 0 for t in table.values()), table
    assert not any(m == "lib" or m.startswith("lib.") for m in sys.modules)


# -- the CLI in fresh processes ---------------------------------------------------------

NO_YAML = ("import runpy, sys; sys.modules['yaml'] = None; sys.argv[0] = 'parity_check'; "
           "runpy.run_module('ssds_tpu_torch.tools.parity_check', run_name='__main__')")


def _cli(*args, no_yaml=False, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = ([sys.executable, "-c", NO_YAML] if no_yaml else
           [sys.executable, "-m", "ssds_tpu_torch.tools.parity_check"])
    return subprocess.run(cmd + list(args), env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_selftest(tree):
    proc = _cli("--selftest", "--cfg", tree, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "healthy: all 152 matched" in proc.stdout and "selftest OK" in proc.stdout


@pytest.mark.parametrize("no_yaml", [False, True], ids=["yml", "no_yaml"])
def test_cli_table_builds_six_rows(no_yaml):
    proc = _cli("--when-data", "--table-only", "--device", "cpu", no_yaml=no_yaml)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [ln for ln in proc.stdout.splitlines() if ln.startswith("   ok   ")]
    assert [ln.split()[1].rstrip(":") for ln in rows] == [r[0] for r in pc.ACCEPTANCE]
    assert all(("(no PyYAML)" in ln) == no_yaml for ln in rows)
    assert proc.stdout.count("run: python -m ssds_tpu_torch.tools.parity_check --cfg") == 6
    assert "when-data dry run OK" in proc.stdout


def test_cli_when_data_runs_the_round_trip_oracle():
    proc = _cli("--when-data", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if "round-trip: direct mAP" in ln]
    assert line, proc.stdout[-3000:]
    direct, imported = (float(w.rstrip(",")) for w in np.array(line[-1].split())[[3, 5]])
    print(line[-1])
    assert imported >= 0.99 and abs(imported - direct) <= pc.MAP_TOLERANCE


def test_cli_full_run_on_a_trained_checkpoint(tree, trained, tmp_path):
    """Stages 1-3 (stage 2 skipped: no reference checkout) on the trained
    ``.pth`` with ``module.`` prefixes: healthy, its mAP, rc 0."""
    sd = load_state_dict_file(trained[0])
    pth = str(tmp_path / "prefixed.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, pth)
    proc = _cli("--cfg", tree, "--pth", pth, "--reference", str(tmp_path / "none"),
                "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "healthy: all 152 matched" in proc.stdout and "SKIP" in proc.stdout
    assert f"mAP = {trained[1]:.4f}" in proc.stdout and "parity OK" in proc.stdout
