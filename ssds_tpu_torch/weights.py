"""Carry JAX variables into the port: the inverse of ``ssds_tpu/torch_import.py``.

The port's modules use the reference torch layout (``tests/ref_torch_skeletons.py``),
so a state dict made here loads into the port with ``load_state_dict`` and,
saved as a ``.pth``, loads back into the JAX package through
``torch_import.import_torch_checkpoint`` with no relaxed placements.

==================================================== ==============================
flax path (``params`` or ``batch_stats``)            port name
==================================================== ==============================
``base_layers_{i}/Conv_0/...`` (VGG)                 ``base.{i}.*``
``base_layers_{i}/{Conv_0,BatchNorm_0}/...``         ``base.{i}.{0,1}.*``
``base_layers_{i}/ConvBNReLU_{g}/{Conv_0,BN_0}/...`` ``base.{i}.{3g,3g+1}.*`` (V1),
                                                     ``base.{i}.conv.{3g,3g+1}.*`` (V2)
``extra_layers_{j}/layers_{l}/Conv_0/...``           ``extras.{2j+l}.*``
``extra_layers_{j}/layers_1/ConvBNReLU_{g}/...``     ``extras.{2j+1}.{3g,3g+1}.*``
``norm/scale``                                       ``norm.weight``
``head/{loc,conf}{k}/Conv_0/...``                    ``{loc,conf}.{k}.*``
``head/{loc,conf}_{dw,pw}{k}/Conv_0/...``            ``{loc,conf}.{k}.{0,2}.*``
==================================================== ==============================

Leaves: conv ``kernel`` -> ``weight`` (HWIO to OIHW, ``transpose(3, 2, 0, 1)``),
``bias`` -> ``bias``; BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``,
``mean`` / ``var`` -> ``running_mean`` / ``running_var``. flax counts no
batches, so every BatchNorm also gets ``num_batches_tracked = 0`` and the
dict loads with ``strict=True``.

A flax path alone does not say whether a block's ``ConvBNReLU_{g}`` children
sit in a flat stack (MobileNetV1's ``conv_dw``, the lite extras) or in an
``InvertedResidual``'s ``.conv`` (MobileNetV2), nor whether ``base_layers_{i}/Conv_0``
is a bare conv (VGG) or the first entry of a ``conv_bn``: the backbone's name,
``cfg.MODEL.NETS``, decides (``net``). :func:`port_name` gives the name alone,
for code that needs the mapping without the arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}
_ENTRY = {"Conv_0": 0, "BatchNorm_0": 1}  # a conv_bn stack: conv, BN, activation

_BASE = re.compile(r"base_layers_(\d+)/(?:ConvBNReLU_(\d+)/)?(Conv_0|BatchNorm_0)$")
_EXTRA = re.compile(r"extra_layers_(\d+)/layers_(\d+)/(?:ConvBNReLU_(\d+)/)?(Conv_0|BatchNorm_0)$")
_HEAD = re.compile(r"head/(loc|conf)(?:_(dw|pw))?(\d+)/Conv_0$")


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _module_name(path: str, net: str) -> str:
    if path == "norm":
        return "norm"
    m = _BASE.fullmatch(path)
    if m:
        i, group, entry = m[1], m[2], _ENTRY[m[3]]
        if group is not None:
            inner = "conv." if net.startswith("mobilenet_v2") else ""
            return f"base.{i}.{inner}{3 * int(group) + entry}"
        return f"base.{i}.{entry}" if net.startswith("mobilenet") else f"base.{i}"
    m = _EXTRA.fullmatch(path)
    if m:
        name = f"extras.{2 * int(m[1]) + int(m[2])}"
        return name if m[3] is None else f"{name}.{3 * int(m[3]) + _ENTRY[m[4]]}"
    m = _HEAD.fullmatch(path)
    if m:
        name = f"{m[1]}.{m[3]}"
        return name if m[2] is None else f"{name}.{0 if m[2] == 'dw' else 2}"
    raise KeyError(path)


def port_name(path: str, net: str = "vgg16") -> str:
    """The port's state-dict name of a flax variable path (``'/'``-joined,
    without the collection), for the backbone ``net`` (``cfg.MODEL.NETS``).
    Raises on a path no rule maps."""
    module, _, leaf = path.rpartition("/")
    try:
        return f"{_module_name(module, net)}.{_LEAF[leaf]}"
    except KeyError:
        raise KeyError(f"state_dict_from_jax: no port name for flax variable {path!r} "
                       f"(net {net!r})") from None


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        net: str = "vgg16") -> Dict[str, torch.Tensor]:
    """Map a flax SSD variable tree (numpy or jax leaves) to the port's state dict.

    ``params`` is the ``'params'`` collection, or the whole variables dict
    (then its ``'batch_stats'`` is used too); ``batch_stats`` is that
    collection given apart (``TrainState.batch_stats``). ``net`` is
    ``cfg.MODEL.NETS``. Raises on a leaf no rule maps, so nothing is dropped
    silently.
    """
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    leaves = list(_flatten(params)) + list(_flatten(batch_stats or {}))
    for path, leaf in leaves:
        arr = np.asarray(leaf, dtype=np.float32)
        name = port_name(path, net)
        if path.endswith("kernel"):
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy, writable
        if name.endswith(".running_mean"):
            out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
