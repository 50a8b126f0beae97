"""ssds_tpu_torch — the PyTorch + CUDA port of ``ssds_tpu`` for NVIDIA Hopper.

The JAX package :mod:`ssds_tpu` is the reference; each module here mirrors
its counterpart's name and layout so a reader finds both halves of every
parity test. The port imports torch, numpy and the standard library only —
never jax or flax, directly or through ``ssds_tpu``.

Ported so far: the SSD300-VGG16 serving path, from uint8 images through
the VGG16 base, the SSD extras and heads, decode and the batched greedy
NMS (a hand-written CUDA kernel, :mod:`ssds_tpu_torch.ops.cuda.nms`) to the
dense ``[B, C, max_det, 5]`` detections of :class:`ObjectDetector`; and
the conv-prototype tools (:mod:`ssds_tpu_torch.tools`), whose 3x3 stem conv
and probe stencils are hand-written CUDA kernels
(:mod:`ssds_tpu_torch.ops.cuda.conv`, :mod:`ssds_tpu_torch.ops.cuda.stencil`).
Then the training path, every backbone and head of the zoo, the serving
export (:mod:`ssds_tpu_torch.export`: a ``torch.export`` program that
reloads with torch and the operators' registrations alone), augmentation on
the device (:mod:`ssds_tpu_torch.ops.augment_device`) and int8 serving
(:mod:`ssds_tpu_torch.quant`, whose convs are hand-written CUDA kernels,
:mod:`ssds_tpu_torch.ops.cuda.int8_conv`). Then data parallelism over
``torch.distributed`` with the JAX step's global reductions
(:mod:`ssds_tpu_torch.parallel`), an export that moves between devices and
serves over several, observability (:mod:`ssds_tpu_torch.utils`) and the
demo's image, video and camera modes: all that the JAX package does but its
spatial mesh axis.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (config-only use imports no model code)."""
    if name == "ObjectDetector":
        from ssds_tpu_torch.detector import ObjectDetector

        return ObjectDetector
    if name in ("cfg", "cfg_from_file", "cfg_from_list", "default_config"):
        from ssds_tpu_torch import config

        return getattr(config, name)
    if name in ("create_model", "init_model"):
        from ssds_tpu_torch.models import builder

        return getattr(builder, name)
    raise AttributeError(name)
