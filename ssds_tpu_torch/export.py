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
    the head and backbone names, image size, class count, batch mode and
    device, so a server can check what it is loading.

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

Not ported: the JAX package's multi-platform ``platforms=`` argument and
``load_exported_sharded`` (ROADMAP.md).

    python -m ssds_tpu_torch.export --cfg <yml> --out DIR [--batch N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

import ssds_tpu_torch.ops.cuda.int8_conv  # noqa: F401  (registers the int8 operators)
import ssds_tpu_torch.ops.cuda.nms  # noqa: F401  (registers ssds_tpu_torch::nms_mask)

_PROGRAM = "predict.pt2"
_META = "export.json"
# the example batch the program is traced at: 2, since torch.export
# specialises a dynamic dimension whose example size is 0 or 1
_EXAMPLE_BATCH = 2


def export_detector(det, out_dir: str, batch=None) -> str:
    """Export ``det``'s predict program for serving.

    Args:
      det: a constructed :class:`ssds_tpu_torch.detector.ObjectDetector`; the
        program runs on its device.
      out_dir: directory to create or fill.
      batch: ``None`` for a symbolic batch dimension (any batch size at call
        time); an ``int`` for a fixed-shape program.

    Returns ``out_dir``.
    """
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
        "input": "uint8 BGR [B,H,W,3] at image_size (host resize only)",
        "output": "[B, num_classes, max_detections, 5] (score,x1,y1,x2,y2)",
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_exported(in_dir: str):
    """Load a served model: returns ``(predict, meta)``.

    ``predict(images_u8) -> [B, C, max_detections, 5]`` float32: a tensor
    of uint8 BGR images already at the exported ``image_size``, on the
    device the program was exported on (``meta["device"]``). The weights
    live in the returned module, which records no gradients; no
    ``ssds_tpu_torch`` model code runs.
    """
    with open(os.path.join(in_dir, _META)) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(in_dir, _PROGRAM))
    return program.module().requires_grad_(False), meta


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a detector's predict program "
                                                 "(torch.export) for serving.")
    parser.add_argument("--cfg", required=True, help="experiment yml")
    parser.add_argument("--out", required=True, help="directory to write")
    parser.add_argument("--batch", type=int, default=None,
                        help="fixed batch size (default: symbolic)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="random weights when the config names no RESUME_CHECKPOINT")
    args = parser.parse_args(argv)

    from ssds_tpu_torch.config import cfg_from_file
    from ssds_tpu_torch.detector import ObjectDetector

    det = ObjectDetector(cfg_from_file(args.cfg), device=args.device, seed=args.seed)
    out = export_detector(det, args.out, batch=args.batch)
    print(f"exported {det.cfg.MODEL.SSDS}/{det.cfg.MODEL.NETS} to {out} "
          f"(batch {'symbolic' if args.batch is None else args.batch}, {det.device})")


if __name__ == "__main__":
    main()
