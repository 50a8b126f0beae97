"""Serving export: the whole predict program as one ``torch.export`` artifact
(counterpart of :mod:`ssds_tpu.export`).

:func:`export_detector` exports an :class:`~ssds_tpu_torch.detector.ObjectDetector`'s
:class:`~ssds_tpu_torch.detector.Predict` (mean subtraction, the forward in
the detector's dtype with its bf16 conv weights, decode, the batched NMS
kernel, the top rows) with ``torch.export.export`` and saves it, weights
and constants (priors, means) included, as one file. A serving process
needs only ``torch`` and the operators' registrations
(:mod:`ssds_tpu_torch.ops.cuda.nms`, :mod:`ssds_tpu_torch.ops.cuda.int8_conv`),
which :func:`load_exported` imports:
none of the model zoo, config system or detector code runs at load time.

Files written to ``<dir>``:

``predict.pt2``
    the ``torch.export.ExportedProgram`` (``torch.export.save``), its
    parameters and buffers on the device it was exported on.
``export.json``
    the head and backbone names, image size, class count, batch mode,
    device and ``platforms`` (the device types the artifact is meant for),
    so a server can check what it is loading.

One artifact serves on either device type (the counterpart of the JAX
package's ``platforms=``): every operator in the program has a CPU and a
CUDA implementation, and ``load_exported(dir, device=...)`` moves the
program, its weights, its constants (priors, means) and every device the
trace baked into its nodes (``arange``, ``full``, ``to``) to another device
(``torch.export.passes.move_to_device_pass``, then a check that nothing is
left on the old one). :func:`load_exported_sharded` serves data-parallel
over several devices: one moved program a device, the batch split in order,
every piece launched before any result is read, the rows concatenated on the
first device: the single program's rows on the same pieces. A symbolic-batch
program takes the unpruned path at every size, so on the CPU those are its
rows on the whole batch; on the card cuDNN may pick other algorithms at
another batch size, which moves the last bits of the scores.

The batch dimension is exported symbolically by default (``Dim("batch")``:
one artifact serves any batch size); pass ``batch=<int>`` for a fixed-shape
program. A symbolic batch takes ``detect``'s unpruned path at every size,
as the JAX package's artifact does (``ops/postprocess.py::_static_ge``); a
fixed batch of 4 or more keeps the prune, as eager serving at that batch.
In the exported program the NMS is the registered operator
``ssds_tpu_torch::nms_mask``: on the card it launches ``csrc/nms.cu`` (the
wrapper's launch count rises there too), on the CPU the plain version. A
detector quantised to int8 (``MODEL.QUANT``, ``quantize_int8``) exports the
same way: its int8 weights and scales are the program's constants and its
convs the operators ``ssds_tpu_torch::quantize_act`` and ``int8_conv``
(``csrc/int8_conv.cu`` on the card), which the loader registers too.

    python -m ssds_tpu_torch.export --cfg <yml> --out DIR [--batch N] [--device cuda]
                                    [--platforms cuda,cpu] [--check]

``--check`` reloads the artifact and holds its rows bit for bit equal to the
in-process detector's on seeded images (:func:`check_exported`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.export.passes import move_to_device_pass

import ssds_tpu_torch.ops.cuda.int8_conv  # noqa: F401  (registers the int8 operators)
import ssds_tpu_torch.ops.cuda.nms  # noqa: F401  (registers ssds_tpu_torch::nms_mask)

_PROGRAM = "predict.pt2"
_META = "export.json"
# the example batch the program is traced at: 2, since torch.export
# specialises a dynamic dimension whose example size is 0 or 1
_EXAMPLE_BATCH = 2
# the device types every operator of a program implements
PLATFORMS = ("cuda", "cpu")


def export_detector(det, out_dir: str, batch=None, platforms: Sequence[str] = None) -> str:
    """Export ``det``'s predict program for serving.

    Args:
      det: a constructed :class:`ssds_tpu_torch.detector.ObjectDetector`; the
        program runs on its device.
      out_dir: directory to create or fill.
      batch: ``None`` for a symbolic batch dimension (any batch size at call
        time); an ``int`` for a fixed-shape program.
      platforms: the device types the artifact is meant for, e.g.
        ``("cuda", "cpu")``, recorded in ``export.json`` (default: the
        detector's); :func:`load_exported` moves the program to any of them.

    Returns ``out_dir``.
    """
    platforms = list(platforms) if platforms else [det.device.type]
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"platforms {unknown}: the program's operators run on {PLATFORMS}")
    h, w = det.img_hw
    b = _EXAMPLE_BATCH if batch is None else int(batch)
    example = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=det.device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch is None else None
    with torch.no_grad():
        program = torch.export.export(det.predictor.eval(), (example,), dynamic_shapes=dynamic)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM))
    meta = {
        "ssds": str(det.cfg.MODEL.SSDS),
        "nets": str(det.cfg.MODEL.NETS),
        "image_size": [h, w],
        "num_classes": int(det.cfg.POST_PROCESS.NUM_CLASSES),
        "batch": "symbolic" if batch is None else int(batch),
        "device": str(det.device),
        "platforms": platforms,
        "input": "uint8 BGR [B,H,W,3] at image_size (host resize only)",
        "output": "[B, num_classes, max_detections, 5] (score,x1,y1,x2,y2)",
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def _devices_in(program) -> set:
    """Every device a tensor or a node of ``program`` names: its state dict,
    constants, the values its nodes record and the devices in their
    arguments."""
    found = {t.device for t in list(program.state_dict.values())
             + [v for v in program.constants.values() if isinstance(v, torch.Tensor)]}
    for m in program.graph_module.modules():
        if not isinstance(m, torch.fx.GraphModule):
            continue
        for node in m.graph.nodes:
            if isinstance(node.kwargs.get("device"), str):  # as the move writes it
                found.add(node.kwargs["device"])
            for leaf in pytree.tree_leaves((node.args, node.kwargs, node.meta.get("val"))):
                if isinstance(leaf, torch.Tensor):
                    found.add(leaf.device)
                elif isinstance(leaf, torch.device):
                    found.add(leaf)
    return {torch.device(d) for d in found}


def move_program(program, device):
    """``program`` moved to ``device`` in place (weights, constants and every
    device baked into a node); raises if a tensor or node still names
    another device. Returns the program."""
    device = torch.device(device)
    program = move_to_device_pass(program, str(device))
    left = {str(d) for d in _devices_in(program) if d != device}
    if left:
        raise RuntimeError(f"moving the exported program to {device} left {sorted(left)} in it")
    return program


def load_exported(in_dir: str, device=None):
    """Load a served model: returns ``(predict, meta)``.

    ``predict(images_u8) -> [B, C, max_detections, 5]`` float32: a tensor
    of uint8 BGR images already at the exported ``image_size``, on
    ``meta["device"]``: the device the program was exported on, or
    ``device``, to which the program is moved (a device type listed in
    ``meta["platforms"]``). The weights live in the returned module, which
    records no gradients; no ``ssds_tpu_torch`` model code runs.
    """
    with open(os.path.join(in_dir, _META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(in_dir, _PROGRAM))
    if device is not None and torch.device(device) != torch.device(meta["device"]):
        device = torch.device(device)
        platforms = meta.get("platforms", [torch.device(meta["device"]).type])
        if device.type not in platforms:
            raise ValueError(f"{in_dir} was exported for {platforms}, not {device.type}")
        program = move_program(program, device)
        meta = dict(meta, device=str(device))
    return program.module().requires_grad_(False), meta


def load_exported_sharded(in_dir: str, devices=None):
    """Serve an exported artifact data-parallel over several devices:
    returns ``(predict, meta)``, ``meta["devices"]`` the devices.

    ``devices`` defaults to every visible card (two entries may name one
    device). One program is loaded and moved to each; ``predict(images_u8)``
    splits the batch in order into one piece a device (fewer for a batch
    smaller than the devices), launches every piece before it reads any
    result, and returns the rows concatenated on the first device: the
    single program's rows on the same pieces. The artifact's batch must be
    symbolic (a fixed batch cannot be split); such a program takes the
    unpruned path at every size, so where the device's kernels do not
    depend on the batch size (the CPU's) the rows are the single program's
    on the whole batch.
    """
    devices = [torch.device(d) for d in (devices if devices is not None else
               [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    if not devices:
        raise RuntimeError("load_exported_sharded: no device given and no card visible")
    programs, meta = [], None
    for d in devices:
        predict, meta = load_exported(in_dir, device=d)
        programs.append(predict)
    if meta["batch"] != "symbolic":
        raise ValueError(f"{in_dir} has a fixed batch of {meta['batch']}: export it with a "
                         "symbolic batch to split the batch over devices")
    meta = dict(meta, device=str(devices[0]), devices=[str(d) for d in devices])

    def predict(images_u8: torch.Tensor) -> torch.Tensor:
        b = images_u8.shape[0]
        n = max(1, min(len(programs), b))
        cuts = [i * b // n for i in range(n + 1)]
        outs = [programs[i](images_u8[cuts[i]:cuts[i + 1]].to(devices[i], non_blocking=True))
                for i in range(n)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return predict, meta


def check_exported(det, out_dir: str, batch=None, device=None, seed: int = 0) -> str:
    """Reload the artifact in ``out_dir`` (moved to ``device``) and hold its
    rows on seeded uint8 images (``batch`` of them, or 2) equal to ``det``'s
    in-process predict function at the same batch: unpruned for a symbolic
    batch (which takes no prune, ``postprocess._static_ge``), ``det``'s own
    for a fixed one. Raises ``AssertionError`` on any difference; returns
    the message it prints."""
    from ssds_tpu_torch.detector import Predict  # not at import: a server loads no model code

    predict, meta = load_exported(out_dir, device=device)
    b = int(batch) if batch else _EXAMPLE_BATCH
    h, w = det.img_hw
    imgs = np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    direct = det.predictor if meta["batch"] != "symbolic" else Predict(
        det.model, det.means, det.priors, dataclasses.replace(det.post, pre_nms_top_n=0),
        det.dtype)
    with torch.no_grad():
        served = predict(torch.from_numpy(imgs).to(meta["device"])).cpu().numpy()
        want = direct(torch.from_numpy(imgs).to(det.device)).cpu().numpy()
    np.testing.assert_array_equal(served, want)
    return (f"check ok: served == in-process on {served.shape} ({meta['device']}, "
            f"batch {meta['batch']}, platforms {meta['platforms']})")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a detector's predict program "
                                                 "(torch.export) for serving.")
    parser.add_argument("--cfg", required=True, help="experiment yml")
    parser.add_argument("--out", required=True, help="directory to write")
    parser.add_argument("--batch", type=int, default=None,
                        help="fixed batch size (default: symbolic)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--platforms", default="",
                        help="comma-separated device types the artifact is meant for "
                             "(default: the --device's)")
    parser.add_argument("--seed", type=int, default=0,
                        help="random weights when the config names no RESUME_CHECKPOINT")
    parser.add_argument("--check", action="store_true",
                        help="reload the artifact and hold its rows equal to the in-process "
                             "detector's on seeded images")
    args = parser.parse_args(argv)

    from ssds_tpu_torch.config import cfg_from_file
    from ssds_tpu_torch.detector import ObjectDetector

    det = ObjectDetector(cfg_from_file(args.cfg), device=args.device, seed=args.seed)
    out = export_detector(det, args.out, batch=args.batch,
                          platforms=[p for p in args.platforms.split(",") if p] or None)
    print(f"exported {det.cfg.MODEL.SSDS}/{det.cfg.MODEL.NETS} to {out} "
          f"(batch {'symbolic' if args.batch is None else args.batch}, {det.device})")
    if args.check:
        print(check_exported(det, out, batch=args.batch, device=args.device))


if __name__ == "__main__":
    main()
