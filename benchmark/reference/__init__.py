"""Plain PyTorch references of the benchmark's configurations, in float32.

One module an architecture (``ssd_vgg16``, ``yolo_v3``), named by the
``reference`` key of a configuration's file; each gives ``param_spec``,
``priors``, ``model_input``, ``forward``, ``train_loss`` and ``flops_per_image``.
Nothing here imports the program, JAX or the JAX package.
"""

from __future__ import annotations

import importlib


def load(name: str):
    """The reference module ``benchmark.reference.<name>``."""
    return importlib.import_module(f"benchmark.reference.{name}")
