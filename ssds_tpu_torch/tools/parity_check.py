"""The mAP-parity harness: one command per acceptance row, for the day a
reference checkpoint and its dataset are at hand.

The port's counterpart of the repository's ``tools/parity_check.py``.
``BASELINE.json``'s bar is "VOC07 mAP within 0.1 points of the PyTorch
reference"; this tool audits a reference ``.pth`` against the port's model,
compares the two models' outputs, and scores the weights:

    python -m ssds_tpu_torch.tools.parity_check --cfg experiments/cfgs/ssd_vgg16_train_voc.yml \\
        --pth /path/to/ssd_vgg16_voc.pth [--data /path/to/VOCdevkit] \\
        [--reference DIR] [--image /path/to/test.jpg] [--device cuda|cpu]

``--cfg`` takes a yml, or the same tree as JSON on a machine without PyYAML.
Stages (each prints ``SKIP`` when its input is absent):

1. **Import audit**: the ``.pth`` read with
   :func:`ssds_tpu_torch.checkpoint.load_state_dict_file` (``{"state_dict":
   ...}`` or a bare dict, ``module.`` prefixes removed) against the port's
   model of the config: matched, missing, unexpected and shape-mismatched
   keys (:func:`~ssds_tpu_torch.checkpoint.audit_state_dict`; BatchNorm's
   ``num_batches_tracked`` in no group). Healthy: all matched, the other
   three empty; the port's modules keep the reference's names, so nothing
   is matched loosely. A healthy file is loaded with
   ``load_state_dict(strict=True)``; an unhealthy one is loaded where it
   matches and the partial load is printed.
2. **Activation diff** (``--reference``: a readable ssds.pytorch checkout):
   the reference model from the same config through its own
   ``lib.utils.config_parse.cfg_from_file`` and
   ``lib.modeling.model_builder.create_model``, the same ``.pth`` loaded,
   both models run in float32 on the CPU on the same mean-subtracted NCHW input (a
   seeded uniform image, or ``--image``, which needs OpenCV to decode) with
   ``phase="train"``; max|d|, mean|d| and the reference's scale of each
   output (``loc`` and ``conf``).
3. **mAP** (``--data`` overrides ``DATASET.DATASET_DIR``): ``Solver(cfg,
   device).test_model()`` with the audited weights (``EXP_DIR`` a fresh
   directory, so no checkpoint there replaces them and no stale annotation
   cache is read), against the row's expected mAP and :data:`MAP_TOLERANCE`.
   The port's datasets decode JPEGs with OpenCV: where it is missing, the
   stage stops with an error that names it.

    python -m ssds_tpu_torch.tools.parity_check --selftest [--cfg CFG] [--device cpu]

proves stages 1 and 3 with no artifact and no OpenCV: a seeded port model
of ``--cfg`` (default SSD300-VGG16) saved as ``{"state_dict": ...}`` (the
reference's layout) and a synthetic VOC drawn in memory
(:mod:`ssds_tpu_torch.tools.synth_voc`); it prints ``selftest OK``.

    python -m ssds_tpu_torch.tools.parity_check --when-data [--table-only] [--device cpu]

builds every row of :data:`ACCEPTANCE` at full width (from its yml, or from
:data:`ssds_tpu_torch.config.YML_MAKERS` where PyYAML is missing) and prints
its command, expected mAP and tolerance; without ``--table-only`` it then
runs the round-trip oracle (:func:`roundtrip_oracle`): a tiny model trained
to saturation, saved as a ``.pth``, audited and scored again, its mAP at
least 0.99 and within :data:`MAP_TOLERANCE` of the mAP before saving.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import os
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

# The acceptance table: BASELINE.json's five architectures and SSD512, each
# with the expected FRACTIONAL mAP (0.772 == 77.2 %: the source papers'
# numbers, BASELINE.md), its protocol and source. The bar "within 0.1 mAP
# points of the reference" is 0.001 on this scale. The day a reference
# checkpoint appears, its own published number comes first.
MAP_TOLERANCE = 0.001

ACCEPTANCE = [
    # (cfg under experiments/cfgs, expected fractional mAP, eval protocol, source)
    ("ssd_vgg16_train_voc.yml", 0.772, "VOC07 test",
     "SSD paper arXiv:1512.02325 (BASELINE.md)"),
    ("ssd_vgg16_train_voc_512.yml", 0.798, "VOC07 test",
     "SSD paper arXiv:1512.02325 (BASELINE.md)"),
    ("fssd_vgg16_train_voc.yml", 0.788, "VOC07 test",
     "FSSD paper arXiv:1712.00960 (BASELINE.md)"),
    ("rfb_vgg16_train_voc.yml", 0.805, "VOC07 test",
     "RFB paper arXiv:1711.07767 (BASELINE.md)"),
    ("ssd_lite_mobilenetv2_train_coco.yml", 0.221, "COCO val AP@[.5:.95]",
     "MobileNetV2 paper arXiv:1801.04381 (SSDLite row; no BASELINE.md row "
     "— reference README zoo unreadable offline)"),
    ("yolo_v3_darknet_53_train_coco.yml", 0.553, "COCO val AP@0.5 (416)",
     "YOLOv3 paper arXiv:1804.02767 (no BASELINE.md row)"),
]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG_DIR = os.path.join(REPO, "experiments", "cfgs")
SHOW = 5  # names printed of each audit group
ORACLE_MAP = 0.99  # the round-trip oracle's floor


def load_cfg(path: str):
    """A config file (yml, or JSON) over the defaults, with no checkpoint to
    resume."""
    from ssds_tpu_torch.config import cfg_from_file

    cfg = cfg_from_file(path)
    cfg.RESUME_CHECKPOINT = ""
    return cfg


def have_yaml() -> bool:
    return importlib.util.find_spec("yaml") is not None


def row_of(cfg_path: str):
    """The :data:`ACCEPTANCE` row of a config file (by its name, a JSON file
    by its stem), or None."""
    stem = os.path.splitext(os.path.basename(cfg_path))[0]
    return next((row for row in ACCEPTANCE if row[0][:-4] == stem), None)


def _read_image(path: str) -> np.ndarray:
    """HWC BGR uint8 image at ``path``; needs OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"--image {path}: decoding an image needs OpenCV (cv2), which is not "
                         f"installed ({e})") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise SystemExit(f"--image {path}: cannot read the image")
    return img


# -- stage 1 ----------------------------------------------------------------------


def stage_import(cfg, pth: str):
    """Audit ``pth`` against the port's model of ``cfg``; returns ``(state
    dict, audit)``: the model's state dict (CPU, float32) after the load."""
    from ssds_tpu_torch.checkpoint import audit_state_dict, load_state_dict_file
    from ssds_tpu_torch.models.builder import create_model, init_model

    print(f"== stage 1: import audit: {pth}")
    model = init_model(create_model(cfg.MODEL)[0])
    want = model.state_dict()
    ckpt = load_state_dict_file(pth)
    audit = audit_state_dict(want, ckpt)
    n_model = len(audit.matched) + len(audit.missing) + len(audit.shape_mismatched)
    print(f"   {cfg.MODEL.SSDS}/{cfg.MODEL.NETS}: {n_model} model tensors, "
          f"{len(audit.matched) + len(audit.unexpected) + len(audit.shape_mismatched)} in the "
          "file (num_batches_tracked not counted)")
    for group in audit._fields:
        names = getattr(audit, group)
        shown = ", ".join(names[:SHOW]) + (", ..." if len(names) > SHOW else "")
        print(f"   {group}: {len(names)}" + (f" ({shown})" if names else ""))
    sd = dict(want)
    for k in audit.matched:
        sd[k] = ckpt[k].to(want[k].dtype)
    model.load_state_dict(sd, strict=True)
    if audit.healthy:
        print(f"   healthy: all {len(audit.matched)} matched, loaded with strict=True")
    else:
        print(f"   UNHEALTHY: partial load, {len(audit.matched)} of {n_model} model tensors "
              "from the file; the rest keep the seeded init")
    return model.state_dict(), audit


# -- stage 2 ----------------------------------------------------------------------


@contextlib.contextmanager
def _reference_on_path(reference: str):
    """``reference`` first on ``sys.path``, and no ``lib`` package of another
    checkout in ``sys.modules``, for the block."""
    stale = lambda: [m for m in sys.modules if m == "lib" or m.startswith("lib.")]  # noqa: E731
    for m in stale():
        del sys.modules[m]
    sys.path.insert(0, reference)
    try:
        yield
    finally:
        sys.path.remove(reference)
        for m in stale():
            del sys.modules[m]


def _outputs(out):
    out = list(out) if isinstance(out, (tuple, list)) else [out]
    names = ["loc", "conf"] if len(out) == 2 else [f"out{i}" for i in range(len(out))]
    return list(zip(names, out))


def stage_activation_diff(cfg, cfg_path: str, pth: str, reference: str, state_dict,
                          image: str = None):
    """The port's model (``state_dict``) against the reference's, both in
    float32 on the CPU (no device's rounding in the diff); returns
    ``{output: (max|d|, mean|d|, reference scale)}`` (``None`` for a shape
    mismatch), or None when skipped."""
    from ssds_tpu_torch.checkpoint import load_state_dict_file
    from ssds_tpu_torch.data.image_ops import resize_linear
    from ssds_tpu_torch.models.builder import create_model, init_model

    print(f"== stage 2: activation diff against the reference at {reference}")
    if not os.path.isdir(reference) or not os.listdir(reference):
        print("   SKIP: reference checkout absent or empty")
        return None
    with _reference_on_path(reference):
        try:
            from lib.modeling.model_builder import create_model as ref_create_model
            from lib.utils import config_parse
        except Exception as e:  # a diagnostic stage: report and go on
            print(f"   SKIP: cannot import the reference's modules: {type(e).__name__}: {e}")
            return None
        config_parse.cfg_from_file(cfg_path)
        ref_model = ref_create_model(config_parse.cfg.MODEL)[0]
    ref_model.load_state_dict(load_state_dict_file(pth), strict=False)
    ref_model.eval()

    h, w = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    if image:  # resized as cv2.resize's INTER_LINEAR does
        img = resize_linear(_read_image(image), (h, w)).astype(np.float32)
    else:
        img = np.random.default_rng(0).uniform(0, 255, (h, w, 3)).astype(np.float32)
    x = torch.from_numpy((img - np.asarray(cfg.DATASET.PIXEL_MEANS, np.float32))
                         .transpose(2, 0, 1)[None].copy())

    ours = init_model(create_model(cfg.MODEL)[0])
    ours.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        mine = _outputs(ours(x, phase="train"))
        theirs = [t.float() for _, t in _outputs(ref_model(x, phase="train"))]
    table = {}
    for (name, o), t in zip(mine, theirs):
        if o.shape != t.shape:
            print(f"   {name}: SHAPE MISMATCH ours={tuple(o.shape)} ref={tuple(t.shape)}")
            table[name] = None
            continue
        d = (o - t).abs()
        table[name] = (d.max().item(), d.mean().item(), t.abs().mean().item())
        print(f"   {name}: max|d|={table[name][0]:.3e} mean|d|={table[name][1]:.3e} "
              f"(ref scale {table[name][2]:.3e})")
    return table


# -- stage 3 ----------------------------------------------------------------------


def _check_decodable(dataset, root: str):
    """Stop (non-zero) unless the test set holds images this machine can
    decode."""
    if len(dataset) == 0:
        raise SystemExit(f"stage 3: the test sets at {root} hold no image")
    try:
        dataset.pull_image(0)
    except ImportError as e:
        raise SystemExit(f"stage 3: cannot decode the test images at {root}: the image decoder "
                         f"{e.name or 'cv2'} (OpenCV) is not installed ({e})") from e


def stage_map(cfg, state_dict, device="cuda"):
    """mAP of ``state_dict`` over ``cfg``'s TEST_SETS through
    ``Solver.test_model``; None when the dataset directory is absent."""
    from ssds_tpu_torch.solver import Solver

    root = cfg.DATASET.DATASET_DIR
    print(f"== stage 3: mAP over TEST_SETS at {root}")
    if not os.path.isdir(root):
        print("   SKIP: dataset directory absent")
        return None
    with tempfile.TemporaryDirectory(prefix="parity_map_") as exp:
        cfg = copy.deepcopy(cfg)
        cfg.update(EXP_DIR=exp, LOG_DIR=os.path.join(exp, "logs"), RESUME_CHECKPOINT="")
        solver = Solver(cfg, device=device)
        try:
            _check_decodable(solver.get_loader("test").dataset, root)
            solver.model.load_state_dict(state_dict, strict=True)
            m_ap = float(solver.test_model())
        finally:
            solver.close()
    print(f"   mAP = {m_ap:.4f}")
    return m_ap


def verdict(cfg_path: str, m_ap) -> bool:
    """Print the mAP against the config's :data:`ACCEPTANCE` row; True when
    it is within :data:`MAP_TOLERANCE` (or there is no row or no mAP)."""
    if m_ap is None:
        return True
    row = row_of(cfg_path)
    if row is None:
        print(f"   no acceptance row for {os.path.basename(cfg_path)}")
        return True
    yml, expected, protocol, source = row
    ok = abs(m_ap - expected) <= MAP_TOLERANCE
    print(f"   {yml}: mAP {m_ap:.4f} against the expected {protocol} mAP {expected:.3f} "
          f"+/- {MAP_TOLERANCE} [{source}]: {'within' if ok else 'OUTSIDE'}")
    return ok


# -- the self-test, the table and the oracle -----------------------------------------


def _synthetic_voc_cfg(cfg, root: str):
    cfg = copy.deepcopy(cfg)
    cfg.DATASET.update(DATASET="voc", DATASET_DIR=root, TRAIN_SETS=[["2007", "trainval"]],
                       TEST_SETS=[["2007", "test"]], PROB=-1)
    return cfg


def selftest(cfg_path: str = None, device="cuda", seed: int = 0, n_test: int = 8):
    """Stages 1 and 3 on a seeded port model of ``cfg_path`` (default
    SSD300-VGG16) saved in the reference's layout and a synthetic VOC drawn
    in memory; raises unless the audit is healthy and the mAP in [0, 1].
    Returns the mAP."""
    from ssds_tpu_torch.config import default_config
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.models.builder import create_model, init_model
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    cfg = load_cfg(cfg_path) if cfg_path else default_config()
    size = int(cfg.MODEL.IMAGE_SIZE[0])
    with tempfile.TemporaryDirectory(prefix="parity_selftest_") as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        write_voc(root, seed, 0, n_test, size)
        cfg = _synthetic_voc_cfg(cfg, root)
        pth = os.path.join(tmp, "fabricated.pth")
        model = init_model(create_model(cfg.MODEL)[0], seed=seed)
        torch.save({"state_dict": model.state_dict()}, pth)
        print(f"# fabricated reference-layout checkpoint: {pth} ({len(model.state_dict())} "
              f"tensors); synthetic VOC test set of {n_test} images at {size} px")
        sd, audit = stage_import(cfg, pth)
        if not audit.healthy:
            raise SystemExit("selftest: the audit of the port's own layout is unhealthy")
        with mock.patch.dict(factory.dataset_map, {"voc": in_memory_voc(seed, size)}):
            m_ap = stage_map(cfg, sd, device)
    if m_ap is None or not 0.0 <= m_ap <= 1.0:
        raise SystemExit(f"selftest: stage 3 gave mAP {m_ap}")
    print("selftest OK")
    return m_ap


def row_config(yml: str):
    """An acceptance row's config: its yml, or where PyYAML is missing the
    port's written-out maker of it. Returns ``(cfg, where it came from)``."""
    from ssds_tpu_torch.config import YML_MAKERS

    if have_yaml():
        return load_cfg(os.path.join(CFG_DIR, yml)), f"experiments/cfgs/{yml}"
    cfg = YML_MAKERS[yml]()
    cfg.RESUME_CHECKPOINT = ""
    return cfg, f"config.{YML_MAKERS[yml].__name__}() (no PyYAML)"


def when_data(run_oracle: bool = True, device="cuda"):
    """Build every acceptance row at full width (on the ``meta`` device: no
    weights) and print its command, expected mAP and tolerance; then, unless
    ``run_oracle`` is False, the round-trip oracle. Raises when a row fails
    or the oracle misses its bars."""
    from ssds_tpu_torch.models.builder import create_model

    print(f"== acceptance table (tolerance +/-{MAP_TOLERANCE:.3f} fractional mAP = 0.1 points)")
    failures = []
    for yml, expected, protocol, source in ACCEPTANCE:
        try:
            cfg, where = row_config(yml)
            model, fmaps = create_model(cfg.MODEL)
            n_params = sum(p.numel() for p in model.parameters())
        except Exception as e:  # report every broken row
            failures.append((yml, e))
            print(f"   FAIL {yml}: {type(e).__name__}: {e}")
            continue
        arg = f"experiments/cfgs/{yml}" if have_yaml() else f"<{yml[:-4]}.json>"
        print(f"   ok   {yml}: {cfg.MODEL.SSDS}/{cfg.MODEL.NETS} at "
              f"{list(cfg.MODEL.IMAGE_SIZE)}, {n_params} parameters, maps {fmaps} (from {where}); "
              f"expected {protocol} mAP {expected:.3f} +/- {MAP_TOLERANCE} [{source}]\n"
              f"        run: python -m ssds_tpu_torch.tools.parity_check --cfg {arg} "
              f"--pth <weights.pth> --data <dataset root> --device {device}")
    if failures:
        raise SystemExit(f"{len(failures)} acceptance rows failed to build")
    if run_oracle:
        map_direct, map_imported = roundtrip_oracle(device)
        if map_imported < ORACLE_MAP:
            raise SystemExit(f"round-trip oracle mAP {map_imported:.4f} < {ORACLE_MAP}: the "
                             "parity chain itself is broken")
        if abs(map_imported - map_direct) > MAP_TOLERANCE:
            raise SystemExit(f"imported mAP {map_imported:.4f} != direct mAP {map_direct:.4f} "
                             f"(> {MAP_TOLERANCE}): the .pth round trip loses accuracy")
        print(f"   round-trip: direct mAP {map_direct:.4f}, imported {map_imported:.4f} "
              f"(|delta| <= {MAP_TOLERANCE})")
    print("when-data dry run OK: parity is one command per row above")


# The oracle: SSDLite over MobileNetV1-0.25 at 96 px (the JAX package's
# tests/test_solver_e2e.py CFG_TEMPLATE, float32) trained on 8 images of one
# "car" rectangle each (its make_voc's scenes, drawn in memory), tested on
# the same 8. The JAX oracle's 40 epochs reach mAP 0.9596 on these scenes
# (seed 0, CPU); 80 reach 1.0 at seeds 0, 1 and 2.
ORACLE_IMAGES, ORACLE_EPOCHS, ORACLE_SIZE = 8, 80, 96


def oracle_sample(seed: int, index: int, size: int = ORACLE_SIZE):
    """Image ``index`` of the oracle's set (``synth_voc.sample``'s form): a
    flat dark background with one light "car" box of 30-80 % of the side."""
    rng = np.random.default_rng([seed, index])
    img = np.full((size, size, 3), 30, np.uint8)
    w, h = (int(v) for v in rng.uniform(0.3, 0.8, 2) * size)
    x1, y1 = (int(v) for v in rng.uniform(0.05, 1.0, 2) * (size - np.array([w, h]) - 2))
    img[y1:y1 + h, x1:x1 + w] = (200, 180, 160)
    return img, [("car", x1 + 1, y1 + 1, x1 + w, y1 + h)]


def oracle_config(root: str, exp: str, epochs: int = ORACLE_EPOCHS):
    from ssds_tpu_torch.config import default_config

    cfg = default_config()
    cfg.MODEL.update(SSDS="ssd_lite", NETS="mobilenet_v1_025", IMAGE_SIZE=[96, 96],
                     FEATURE_LAYER=[[11, 13], [128, 256]], ASPECT_RATIOS=[[2], [2]],
                     SIZES=[0.3, 0.6, 0.9], HALF_PRECISION=False)
    cfg.TRAIN.update(MAX_EPOCHS=epochs, CHECKPOINTS_EPOCHS=epochs, BATCH_SIZE=4,
                     TRAINABLE_SCOPE="")
    cfg.TRAIN.OPTIMIZER.update(LEARNING_RATE=0.02, WEIGHT_DECAY=0.0)
    cfg.TRAIN.LR_SCHEDULER.update(STEPS=[100], GAMMA=1.0)
    cfg.TEST.update(BATCH_SIZE=4, TEST_SCOPE=[1000, 1001])
    cfg.POST_PROCESS.update(IOU_THRESHOLD=0.5, MAX_DETECTIONS=20)
    cfg.DATASET.update(MAX_GT=8, NUM_WORKERS=2)
    cfg.update(EXP_DIR=exp, LOG_DIR=os.path.join(exp, "logs"), CHECKPOINTS_PREFIX="oracle")
    return _synthetic_voc_cfg(cfg, root)


def roundtrip_oracle(device="cuda", seed: int = 0, epochs: int = ORACLE_EPOCHS):
    """Train the oracle's model, save it as a reference-layout ``.pth``,
    audit it (healthy) and score it again; returns ``(mAP before saving,
    mAP of the audited file)``."""
    from ssds_tpu_torch.data import factory
    from ssds_tpu_torch.solver import Solver
    from ssds_tpu_torch.tools.synth_voc import in_memory_voc, write_voc

    print("== measurement-chain proof: train -> .pth -> audit -> eval")
    with tempfile.TemporaryDirectory(prefix="parity_whendata_") as tmp, \
            mock.patch.dict(factory.dataset_map,
                            {"voc": in_memory_voc(seed, ORACLE_SIZE, oracle_sample)}):
        root = os.path.join(tmp, "VOCdevkit")
        write_voc(root, seed, ORACLE_IMAGES, 0, ORACLE_SIZE, draw=oracle_sample)
        cfg = oracle_config(root, os.path.join(tmp, "exp"), epochs)
        solver = Solver(cfg, device=device, seed=seed)
        try:
            solver.train_model()
            map_direct = float(solver.test_model())
            pth = os.path.join(tmp, "trained_reference_layout.pth")
            torch.save({"state_dict": {k: v.cpu() for k, v in solver.model.state_dict().items()}},
                       pth)
        finally:
            solver.close()
        print(f"   saved {pth} ({len(solver.model.state_dict())} tensors) after {epochs} epochs")
        sd, audit = stage_import(cfg, pth)
        if not audit.healthy:
            raise SystemExit("round-trip oracle: the audit of the saved model is unhealthy")
        map_imported = stage_map(cfg, sd, device)
    return map_direct, float(map_imported)


def main(argv=None):
    ap = argparse.ArgumentParser(description="mAP-parity harness: import audit, activation "
                                             "diff against the reference, mAP")
    ap.add_argument("--cfg", help="experiment yml (or JSON); with --selftest, its model")
    ap.add_argument("--pth", help="the reference checkpoint")
    ap.add_argument("--data", help="VOCdevkit / COCO root (overrides DATASET.DATASET_DIR)")
    ap.add_argument("--reference", default="/root/reference",
                    help="a readable ssds.pytorch checkout, for stage 2 (the default is "
                         "tools/parity_check.py's)")
    ap.add_argument("--image", help="an image for stage 2 (needs OpenCV)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--selftest", action="store_true",
                    help="stages 1 and 3 on a fabricated checkpoint and a synthetic VOC")
    ap.add_argument("--when-data", action="store_true",
                    help="build every acceptance row, then the round-trip oracle")
    ap.add_argument("--table-only", action="store_true",
                    help="with --when-data: the table alone, no training")
    args = ap.parse_args(argv)

    if args.when_data:
        when_data(run_oracle=not args.table_only, device=args.device)
        return
    if args.selftest:
        selftest(args.cfg, device=args.device)
        return
    if not args.cfg or not args.pth:
        ap.error("--cfg and --pth are required (or --selftest, or --when-data)")
    cfg = load_cfg(args.cfg)
    if args.data:
        cfg.DATASET.DATASET_DIR = args.data
    sd, audit = stage_import(cfg, args.pth)
    stage_activation_diff(cfg, args.cfg, args.pth, args.reference, sd, args.image)
    within = verdict(args.cfg, stage_map(cfg, sd, args.device))
    if not (audit.healthy and within):
        raise SystemExit("parity: " + ", ".join(
            w for w, bad in (("unhealthy import audit", not audit.healthy),
                             ("mAP outside the tolerance", not within)) if bad))
    print("parity OK")


if __name__ == "__main__":
    main()
