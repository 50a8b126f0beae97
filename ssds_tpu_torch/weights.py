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
FSSD, ``fssd_lite``:
``fusion_layers_{j}/layers_{l}/...``                 as ``extra_layers_{j}`` above
``transforms_{k}/Conv_0/...``                        ``transforms.{k}.*``
``fusion_bn/...``                                    ``norm.*``
``pyramid_layers_{k}/{Conv_0,BatchNorm_0}/...``      ``pyramids.{k}.{0,1}.*``
``pyramid_layers_{k}/ConvBNReLU_{g}/...`` (lite)     ``pyramids.{k}.{3g,3g+1}.*``
RFB, ``rfb_lite`` (``b`` = the extras entry of block ``j``, see below):
``extra_layers_{j}/ConvBNReLU_{k}/{Conv_0,BN_0}/..`` ``extras.{b}.<RFB_INNER[k]>.{conv,bn}.*``
``extra_layers_{j}/SepConvBNReLU_{s}/ConvBNReLU_{g}`` ``extras.{b}.<RFB_LITE_SEP[s]>.{3g,3g+1}.*``
``extra_layers_{j}/layers_{l}/Conv_0/...``           ``extras.{b+l}.*``
``norm/{Conv_k,BatchNorm_k}/...`` (``BasicRFB_a``)   ``norm.<RFB_A_INNER[k]>.{conv,bn}.*``
DarkNet, YOLO (``net`` ``darknet_*``, ``ssds`` ``yolo_*``):
``base_layers_{i}/{Conv_0,BatchNorm_0}/...``         ``base.{i}.{0,1}.*``
``base_layers_{i}/ConvBNReLU_{g}/...`` (residual)    ``base.{i}.ConvBNReLU_{g}.{0,1}.*``
``extras_{n}/{Conv_0,BatchNorm_0}/...``              ``extras_{n}.{0,1}.*``
``extras_{n}/ConvBNReLU_{g}/...`` (``ConvSet``)      ``extras_{n}.ConvBNReLU_{g}.{0,1}.*``
``conf{k}/Conv_0/...``                               ``conf{k}.*``
ResNet (``net`` ``resnet_*``: the stem, every residual block):
``base_layers_{i}/ConvBNReLU_{g}/...``               ``base.{i}.ConvBNReLU_{g}.{0,1}.*``
==================================================== ==============================

An RFB ``extras`` list holds one entry for each ``BasicRFB`` and two for each
plain ``''`` pair, in FEATURE_LAYER order, so block ``j``'s first entry ``b``
depends on the kinds before it: the bridge needs the head's FEATURE_LAYER.
A ``BasicRFB``'s flax children are numbered in call order by kind, so the
plain ``BasicRFB`` has ``ConvBNReLU_0-10`` and the lite one ``ConvBNReLU_0-7``
and ``SepConvBNReLU_0-2`` (:data:`RFB_INNER`, :data:`RFB_LITE_INNER`,
:data:`RFB_LITE_SEP`). The lite names (``fssd_lite``, ``rfb_lite``) are the
port's own: the JAX package's importer does not cover a lite ``BasicRFB``,
and these two load through this bridge with ``load_state_dict(strict=True)``.

Leaves: conv ``kernel`` -> ``weight`` (HWIO to OIHW, ``transpose(3, 2, 0, 1)``),
``bias`` -> ``bias``; BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``,
``mean`` / ``var`` -> ``running_mean`` / ``running_var``. flax counts no
batches, so every BatchNorm also gets ``num_batches_tracked = 0`` and the
dict loads with ``strict=True``.

A flax path alone does not say whether a block's ``ConvBNReLU_{g}`` children
sit in a flat stack (MobileNetV1's ``conv_dw``, the lite extras) or in an
``InvertedResidual``'s ``.conv`` (MobileNetV2) or under their own names (a
DarkNet or ResNet residual block), nor whether ``base_layers_{i}/Conv_0``
is a bare conv (VGG) or the first entry of a ``conv_bn``: the backbone's name,
``cfg.MODEL.NETS``, decides (``net``); the head's kind, ``cfg.MODEL.SSDS``
(``ssds``), decides how ``extra_layers_{j}`` maps. :func:`port_name` gives the
name alone, for code that needs the mapping without the arrays.

Quantised variables (``ssds_tpu.quant.quantize_variables``: int8 kernels in
``params`` and a ``quant`` collection of scales) cross with
:func:`quant_state_from_jax`: ``state_dict_from_jax`` carries the tree (the
int8 kernels as float32 values, the float biases and statistics), and the
quant state names each int8 conv of the port with its int8 OIHW weight,
``w_scale`` and ``act_scale``, which :func:`ssds_tpu_torch.quant.load_quantized`
swaps in. A ``layers.Conv`` or ``ConvBNReLU`` keeps ``act_scale`` /
``w_scale`` at its own path (its conv is ``<path>/Conv_0``); a fused
multibox head keeps ``act_scale_src{k}`` / ``w_scale_src{k}`` at the head,
the latter the concatenation of ``loc{k}``'s and ``conf{k}``'s scales.
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
_EXTRA = re.compile(r"(?:extra|fusion)_layers_(\d+)/layers_(\d+)/(?:ConvBNReLU_(\d+)/)?"
                    r"(Conv_0|BatchNorm_0)$")
_HEAD = re.compile(r"head/(loc|conf)(?:_(dw|pw))?(\d+)/Conv_0$")
_TRANSFORM = re.compile(r"transforms_(\d+)/Conv_0$")
_PYRAMID = re.compile(r"pyramid_layers_(\d+)/(?:ConvBNReLU_(\d+)/)?(Conv_0|BatchNorm_0)$")
_RFB = re.compile(r"extra_layers_(\d+)/(?:ConvBNReLU_(\d+)|SepConvBNReLU_(\d+)/ConvBNReLU_(\d+))/"
                  r"(Conv_0|BatchNorm_0)$")
_RFB_A = re.compile(r"norm/(Conv|BatchNorm)_(\d+)$")
_YOLO_EXTRA = re.compile(r"(extras_[a-z0-9]+)/(?:(ConvBNReLU_\d+)/)?(Conv_0|BatchNorm_0)$")
_YOLO_CONF = re.compile(r"(conf\d+)/Conv_0$")

# the reference BasicRFB's BasicConv of each flax ConvBNReLU_{k}, in call order
RFB_INNER = ("branch0.0", "branch0.1", "branch1.0", "branch1.1", "branch1.2", "branch2.0",
             "branch2.1", "branch2.2", "branch2.3", "ConvLinear", "shortcut")
# the lite BasicRFB: its ConvBNReLU_{k} and its SepConvBNReLU_{s} (flat stacks)
RFB_LITE_INNER = ("branch0.0", "branch0.1", "branch1.0", "branch1.2", "branch2.0", "branch2.3",
                  "ConvLinear", "shortcut")
RFB_LITE_SEP = ("branch1.1", "branch2.1", "branch2.2")
# BasicRFB_a's flax Conv_{k} / BatchNorm_{k} pairs
RFB_A_INNER = ("branch0.0", "branch0.1", "branch1.0", "branch1.1", "branch1.2", "branch2.0",
               "branch2.1", "branch2.2", "branch3.0", "branch3.1", "branch3.2", "branch3.3",
               "ConvLinear", "shortcut")
_BASIC_CONV = {"Conv_0": "conv", "BatchNorm_0": "bn", "Conv": "conv", "BatchNorm": "bn"}


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def _extras_entry(j: int, ssds: str, feature_layer) -> int:
    """The first ``extras`` entry of extra block ``j``: two a block, but one
    for each ``BasicRFB`` of an RFB head."""
    if not ssds.startswith("rfb"):
        return 2 * j
    if feature_layer is None:
        raise KeyError("an RFB head's extras need its FEATURE_LAYER")
    kinds = [str(k) for k in feature_layer[0] if not isinstance(k, int)]
    return sum(1 if k in ("R", "S") else 2 for k in kinds[:j])


def _module_name(path: str, net: str, ssds: str, feature_layer) -> str:
    if path in ("norm", "fusion_bn"):
        return "norm"
    m = _RFB_A.fullmatch(path)
    if m:
        return f"norm.{RFB_A_INNER[int(m[2])]}.{_BASIC_CONV[m[1]]}"
    m = _RFB.fullmatch(path)
    if m:
        block = f"extras.{_extras_entry(int(m[1]), ssds, feature_layer)}"
        if m[2] is not None:
            inner = (RFB_LITE_INNER if ssds == "rfb_lite" else RFB_INNER)[int(m[2])]
            return f"{block}.{inner}.{_BASIC_CONV[m[5]]}"
        return f"{block}.{RFB_LITE_SEP[int(m[3])]}.{3 * int(m[4]) + _ENTRY[m[5]]}"
    m = _BASE.fullmatch(path)
    if m:
        i, group, entry = m[1], m[2], _ENTRY[m[3]]
        if net.startswith(("darknet", "resnet")):  # flax's own block names
            return f"base.{i}.{entry}" if group is None else f"base.{i}.ConvBNReLU_{group}.{entry}"
        if group is not None:
            inner = "conv." if net.startswith("mobilenet_v2") else ""
            return f"base.{i}.{inner}{3 * int(group) + entry}"
        return f"base.{i}.{entry}" if net.startswith("mobilenet") else f"base.{i}"
    m = _EXTRA.fullmatch(path)
    if m:
        name = f"extras.{_extras_entry(int(m[1]), ssds, feature_layer) + int(m[2])}"
        return name if m[3] is None else f"{name}.{3 * int(m[3]) + _ENTRY[m[4]]}"
    m = _TRANSFORM.fullmatch(path)
    if m:
        return f"transforms.{m[1]}"
    m = _PYRAMID.fullmatch(path)
    if m:
        return f"pyramids.{m[1]}.{3 * int(m[2] or 0) + _ENTRY[m[3]]}"
    m = _YOLO_EXTRA.fullmatch(path)
    if m:
        return ".".join(p for p in (m[1], m[2], str(_ENTRY[m[3]])) if p)
    m = _YOLO_CONF.fullmatch(path)
    if m:
        return m[1]
    m = _HEAD.fullmatch(path)
    if m:
        name = f"{m[1]}.{m[3]}"
        return name if m[2] is None else f"{name}.{0 if m[2] == 'dw' else 2}"
    raise KeyError(path)


def port_name(path: str, net: str = "vgg16", ssds: str = "ssd", feature_layer=None) -> str:
    """The port's state-dict name of a flax variable path (``'/'``-joined,
    without the collection), for the backbone ``net`` (``cfg.MODEL.NETS``)
    and the head ``ssds`` (``cfg.MODEL.SSDS``); an RFB head's extras also
    need its ``feature_layer`` (``cfg.MODEL.FEATURE_LAYER``). Raises on a
    path no rule maps."""
    module, _, leaf = path.rpartition("/")
    try:
        return f"{_module_name(module, net, ssds, feature_layer)}.{_LEAF[leaf]}"
    except (KeyError, IndexError):
        raise KeyError(f"state_dict_from_jax: no port name for flax variable {path!r} "
                       f"(net {net!r}, head {ssds!r})") from None


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        net: str = "vgg16", ssds: str = "ssd",
                        feature_layer=None) -> Dict[str, torch.Tensor]:
    """Map a flax detector's variable tree (numpy or jax leaves) to the port's
    state dict.

    ``params`` is the ``'params'`` collection, or the whole variables dict
    (then its ``'batch_stats'`` is used too); ``batch_stats`` is that
    collection given apart (``TrainState.batch_stats``). ``net``, ``ssds``
    and ``feature_layer`` are ``cfg.MODEL``'s ``NETS``, ``SSDS`` and
    ``FEATURE_LAYER`` (:func:`port_name`). Raises on a leaf no rule maps, so
    nothing is dropped silently.
    """
    if "params" in params:
        batch_stats = params.get("batch_stats", batch_stats)
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    leaves = list(_flatten(params)) + list(_flatten(batch_stats or {}))
    for path, leaf in leaves:
        arr = np.asarray(leaf, dtype=np.float32)
        name = port_name(path, net, ssds, feature_layer)
        if path.endswith("kernel"):
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a copy, writable
        if name.endswith(".running_mean"):
            out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def quant_state_from_jax(variables: Mapping, net: str = "vgg16", ssds: str = "ssd",
                         feature_layer=None) -> Dict[str, dict]:
    """The port's quantised state of JAX's quantised ``variables`` (``params``
    with int8 kernels and the ``quant`` collection): ``{conv name: {"weight":
    int8 OIHW, "w_scale": float32 [Cout], "act_scale": float32}}``, for
    :func:`ssds_tpu_torch.quant.load_quantized`. ``net``, ``ssds`` and
    ``feature_layer`` as for :func:`state_dict_from_jax`."""
    params = dict(_flatten(variables["params"]))
    scales = dict(_flatten(variables["quant"]))

    def entry(conv_path: str, w_scale, act_scale):
        kernel = np.asarray(params[f"{conv_path}/kernel"])
        if kernel.dtype != np.int8:
            raise ValueError(f"quant_state_from_jax: {conv_path} has a {kernel.dtype} kernel")
        return _module_name(conv_path, net, ssds, feature_layer), {
            "weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
            "w_scale": torch.from_numpy(np.array(w_scale, np.float32)),
            "act_scale": np.float32(act_scale)}

    out: Dict[str, dict] = {}
    for path, act in scales.items():
        module, _, leaf = path.rpartition("/")
        prefix = f"{module}/" if module else ""
        if leaf == "act_scale":
            name, e = entry(f"{prefix}Conv_0", scales[f"{prefix}w_scale"], act)
            out[name] = e
        elif leaf.startswith("act_scale_src"):
            k = leaf[len("act_scale_src"):]
            w_scale = np.asarray(scales[f"{prefix}w_scale_src{k}"], np.float32)
            n_loc = np.asarray(params[f"{prefix}loc{k}/Conv_0/kernel"]).shape[-1]
            for part, ws in (("loc", w_scale[:n_loc]), ("conf", w_scale[n_loc:])):
                name, e = entry(f"{prefix}{part}{k}/Conv_0", ws, act)
                out[name] = e
    return out
