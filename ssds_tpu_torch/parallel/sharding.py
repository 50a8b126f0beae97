"""Data parallelism over ``torch.distributed`` (counterpart of :mod:`ssds_tpu.parallel.sharding`).

The JAX package trains over a ``Mesh('data')`` under ``jit``: the batch is
sharded over the chips, and every reduction in the step is global. Here the
idiom is one process per card, launched by ``torch.distributed.run``
(``python -m torch.distributed.run --nproc_per_node N -m ssds_tpu_torch.train
--cfg <yml>``), with ``DistributedDataParallel`` averaging the gradients over
NCCL (gloo on the CPU). The step keeps JAX's global reductions where a plain
DDP would take them per rank: train-mode BatchNorm normalises with the global
batch's statistics (:class:`ssds_tpu_torch.models.layers.BatchNorm`), the
MultiBox loss divides by the global positive count and YOLOv2's warm-up
counts the global batch (:func:`ssds_tpu_torch.solver.detection_loss`), and
the device augmentation draws the global batch's parameters and applies this
rank's rows (:func:`ssds_tpu_torch.ops.augment_device.augment_batch`).

``TPU.MESH`` maps onto the launch: the world of ``W`` ranks is ``D x S``,
``S`` the spatial width (``MESH.SPATIAL``, :func:`spatial_size`) and ``D``
the data width (:func:`data_parallel_size`): ``DATA`` of -1 or 0 takes ``W /
S`` and another value must equal it. A global ``TRAIN.BATCH_SIZE`` must
divide by ``D``, where the JAX package clips its mesh to a divisor
(``ssds_tpu/parallel/sharding.py:54-56``): a rank cannot sit out a step.
The spatial axis, on which the ``S`` ranks of a data group each hold a band
of image rows, is :mod:`ssds_tpu_torch.parallel.spatial`.

Two ranks may share one card only on gloo: NCCL refuses two ranks on one GPU.
"""

from __future__ import annotations

import os
import socket
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def initialize_distributed(backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group that ``torch.distributed.run`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns whether this process is one of several ranks.

    Does nothing when ``WORLD_SIZE`` is unset (one process) or the group
    exists. ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for
    the CPU; under NCCL the current card becomes ``cuda:{LOCAL_RANK}``.
    """
    if "WORLD_SIZE" not in os.environ:
        return False
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend=backend)
    return dist.get_world_size() > 1


def destroy_distributed() -> None:
    """End the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def is_main() -> bool:
    return rank() == 0


def rank_device(device) -> torch.device:
    """This rank's device: ``"cuda"`` without an index means
    ``cuda:{LOCAL_RANK}`` under a launcher; an explicit ``cuda:k`` is kept,
    so ranks given the same one share that card, which only gloo allows
    (raises under NCCL)."""
    dev = torch.device(device)
    if dev.type != "cuda" or world_size() == 1:
        return dev
    if dev.index is None:
        return torch.device("cuda", local_rank())
    if dist.get_backend() == "nccl":
        where = allgather_pickled((socket.gethostname(), dev.index))
        if len(set(where)) < len(where):
            raise ValueError(f"device {dev}: NCCL cannot run two ranks on one GPU ({where}); "
                             "pass 'cuda' (one card a rank) or use the gloo backend")
    return dev


def spatial_size(tpu_cfg) -> int:
    """The spatial width ``S`` from ``cfg.TPU.MESH.SPATIAL`` (1: no spatial axis)."""
    return max(1, int(tpu_cfg.MESH.get("SPATIAL", 1)))


def data_parallel_size(tpu_cfg, batch_size: int) -> int:
    """The data-parallel width ``D`` from ``cfg.TPU.MESH``: the world size over
    the spatial width.

    The world size must divide by ``SPATIAL``. ``DATA`` of -1 or 0 takes ``W
    / S``; another value must equal it. The global ``batch_size`` must divide
    by ``D`` (the JAX package clips its mesh instead; a rank cannot be left
    idle)."""
    world = world_size()
    spatial = spatial_size(tpu_cfg)
    if world % spatial:
        raise ValueError(f"TPU.MESH.SPATIAL={spatial}, but the launch has {world} rank(s), "
                         "which do not divide by it")
    data = world // spatial
    want = int(tpu_cfg.MESH.DATA)
    if want not in (-1, 0) and want != data:
        raise ValueError(f"TPU.MESH.DATA={want}, but the launch has {world} ranks over "
                         f"SPATIAL={spatial}, a data width of {data} (-1 or 0 takes it)")
    if batch_size % data:
        raise ValueError(f"TRAIN.BATCH_SIZE={batch_size} (the global batch) does not divide "
                         f"by the {data} data-parallel groups of ranks")
    return data


def allgather_pickled(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank (``[obj]`` for one
    process): the merge primitive of the sharded eval. Under NCCL it first
    makes this rank's card the current one."""
    world = world_size()
    if world == 1:
        return [obj]
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(local_rank())  # the staging tensors' card
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def all_reduce_mean(values: List[torch.Tensor]) -> List[float]:
    """The mean over the ranks of each scalar in ``values``, read on the host
    (one collective for all)."""
    t = torch.stack([v.detach().double() for v in values])
    if world_size() > 1:
        dist.all_reduce(t)
        t = t / world_size()
    return t.tolist()


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (nothing to do for one process)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


__all__ = ["initialize_distributed", "destroy_distributed", "world_size", "rank", "local_rank",
           "is_main", "rank_device", "data_parallel_size", "spatial_size", "allgather_pickled",
           "all_reduce_mean", "all_reduce_sum_"]
