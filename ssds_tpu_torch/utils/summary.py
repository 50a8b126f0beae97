"""The summary writer of a machine without TensorBoard.

The Solver writes its scalars (and ``visualize_epoch`` its images and
histograms) through ``torch.utils.tensorboard.SummaryWriter``, which needs
the ``tensorboard`` package; the card's machine has none. There
:class:`JsonLinesWriter` takes its place: one JSON object a line in
``{log_dir}/summary.jsonl``, a scalar with its value, an image or histogram
with its shape and its minimum, mean and maximum.
"""

from __future__ import annotations

import json
import os

import numpy as np


class JsonLinesWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "summary.jsonl")
        self._f = open(self.path, "a")

    def _write(self, **record):
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def add_scalar(self, tag, value, step):
        self._write(kind="scalar", tag=tag, step=int(step), value=float(value))

    def _array(self, kind, tag, values, step):
        a = np.asarray(values, np.float64)
        self._write(kind=kind, tag=tag, step=int(step), shape=list(a.shape),
                    min=float(a.min()) if a.size else None,
                    mean=float(a.mean()) if a.size else None,
                    max=float(a.max()) if a.size else None)

    def add_image(self, tag, img, step):
        self._array("image", tag, img, step)

    def add_histogram(self, tag, values, step):
        self._array("histogram", tag, values, step)

    def close(self):
        self._f.close()
