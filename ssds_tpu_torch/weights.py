"""Carry JAX parameters into the port: the inverse of ``ssds_tpu/torch_import.py``.

The port's modules use the reference torch layout (``tests/ref_torch_skeletons.py``),
so a state dict made here loads into the port with ``load_state_dict`` and,
saved as a ``.pth``, loads back into the JAX package through
``torch_import.import_torch_checkpoint`` with no relaxed placements.

=========================================== =========================
flax path                                   port name
=========================================== =========================
``base_layers_{i}/Conv_0/{kernel,bias}``    ``base.{i}.{weight,bias}``
``extra_layers_{j}/layers_{l}/Conv_0/...``  ``extras.{2j+l}.{...}``
``norm/scale``                              ``norm.weight``
``head/loc{k}/Conv_0/...``                  ``loc.{k}.{...}``
``head/conf{k}/Conv_0/...``                 ``conf.{k}.{...}``
=========================================== =========================

Conv kernels go from HWIO to OIHW (``transpose(3, 2, 0, 1)``). :func:`port_name`
gives the name alone, for code that needs the mapping without the arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_RULES = (
    (re.compile(r"base_layers_(\d+)/Conv_0/(kernel|bias)$"), lambda m: f"base.{m[1]}"),
    (re.compile(r"extra_layers_(\d+)/layers_(\d+)/Conv_0/(kernel|bias)$"),
     lambda m: f"extras.{2 * int(m[1]) + int(m[2])}"),
    (re.compile(r"head/(loc|conf)(\d+)/Conv_0/(kernel|bias)$"), lambda m: f"{m[1]}.{m[2]}"),
)


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def port_name(path: str) -> str:
    """The port's state-dict name of a flax param path (``'/'``-joined).
    Raises on a path no rule maps."""
    if path == "norm/scale":
        return "norm.weight"
    for pattern, name in _RULES:
        m = pattern.search(path)
        if m:
            return f"{name(m)}.{'weight' if path.endswith('kernel') else 'bias'}"
    raise KeyError(f"state_dict_from_jax: no port name for flax param {path!r}")


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax SSD param tree (numpy or jax leaves) to the port's state dict.

    ``params`` is the ``'params'`` collection or the whole variables dict.
    Raises on a leaf no rule maps, so nothing is dropped silently.
    """
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        name = port_name(path)
        if path.endswith("kernel"):
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy, writable
    return out
