"""Training and evaluation: the Solver (counterpart of :mod:`ssds_tpu.solver`).

Reference ``lib/ssds_train.py``: the ``Solver`` owns the model, priors,
loss, optimizer, LR schedule, loaders and summary writer; its epoch loop
trains with warm-up, saves a checkpoint every ``CHECKPOINTS_EPOCHS`` and
auto-resumes from the newest one; inside ``TEST.TEST_SCOPE`` it evaluates
loss and mAP; ``TRAINABLE_SCOPE`` freezes parameters; the writer records
``loss_loc`` / ``loss_conf`` / ``lr``.

A train step here: uint8 images on the device -> minus ``PIXEL_MEANS`` in
float32 -> the forward under ``torch.autocast`` in bf16 when
``MODEL.HALF_PRECISION`` (float32 master weights) -> the loss in float32
(:func:`detection_loss`: match and MultiBox for the SSD-family heads, which
have priors; ``yolo_loss`` for YOLOv3 and ``yolo_v2_loss`` for YOLOv2, whose
warm-up counts ``step * batch`` seen images, as the JAX step does) ->
backward -> the optimizer, whose updates follow the JAX package's optax
chains (:func:`configure_optimizer`) with the LR set each step from the
step-indexed schedule. A step returns device scalars and never waits for the
device. An eval batch takes one forward for its loss and its detections
(:func:`detections`: ``detect`` on the priors, or a YOLO head's decoded boxes
through ``detect_decoded``).

``DATASET.DEVICE_AUG`` runs the augmentation inside the step
(:mod:`ssds_tpu_torch.ops.augment_device`, after the mean subtraction, in
float32 and without gradients) while the loader only resizes; its generator
is re-seeded from ``(17, step)`` at every step, as JAX folds the step into
``PRNGKey(17)``, so a resumed run draws what an unbroken run would have. The
step computes in bf16 when ``MODEL.HALF_PRECISION`` is set and
``TPU.COMPUTE_DTYPE`` is ``bfloat16``, else in float32 (JAX's rule).
``TPU.DEBUG_NANS`` stops at the first non-finite loss or gradient with a
``FloatingPointError`` naming the step and the tensor (JAX's
``jax_debug_nans``); off, the step adds no host synchronisation.
``TPU.REMAT`` runs the forward under ``torch.utils.checkpoint``, as the JAX
step wraps it in ``jax.checkpoint``: the backward recomputes the
activations instead of keeping them, and no number of the step changes (the
recompute leaves the BatchNorms' running statistics alone).

Data parallelism (:mod:`ssds_tpu_torch.parallel.sharding`): under a process
group of ``N`` ranks (``torch.distributed.run``) ``TRAIN.BATCH_SIZE`` is the
global batch; each rank loads its interleaved share of the train set at
``batch / N``, trains the model wrapped in ``DistributedDataParallel`` and
keeps the JAX step's global reductions (BatchNorm statistics, the MultiBox
normaliser, YOLOv2's seen images, the augmentation's draws), so ``N`` ranks
step as one process does at the global batch. Rank 0 alone writes
checkpoints; the printed and written train losses are the ranks' means,
read where the host reads them anyway. The eval and the test forward each
rank's contiguous share of the images and merge the detections and loss sums
over ``allgather_pickled``; rank 0 scores them and every rank returns its
mAP.

The spatial axis (``TPU.MESH.SPATIAL`` = ``S`` > 1,
:mod:`ssds_tpu_torch.parallel.spatial`): the ``N`` ranks are ``D x S``, and
the ``S`` ranks of a data group load the group's share at ``batch / D``.
Each takes a band of the image rows into a model whose convs and pools
exchange halo rows; the loss runs on the whole images, gathered at the
heads, counts each image's positives once, and the gradient is the sum of
every rank's over ``D`` (no DDP wrapper). Eval, test and serving run whole
images, sharded over the ranks as above.

Every family splits on the spatial axis: FSSD's fusion resizes, YOLOv3's
upsamples and YOLOv2's reorg fetch the rows their windows read from the
other bands, as the convs do, and YOLO's predictors are gathered whole for
its loss, which takes the images' size from the uncut batch.

Differences from the JAX solver: every head is ported (SSD, SSDLite, FSSD,
RFB, YOLOv2/v3). After a resume the port
continues the LR schedule from the restored step, as
``ssds_tpu/solver.py:366-367`` intends; the JAX optimizer restarts its
schedule count at 0 (ROADMAP.md §3).

Observability: the epoch loop and the train step open the named spans that
:mod:`ssds_tpu_torch.utils.profiler` lists, which cost nothing unless a
profiler runs; a trace counts the steps and the blocking loss reads by
their spans. ``Solver.setup_s`` holds one-off host seconds: ``model``
(building the model and moving it to the device) and ``first_step`` (the
first loop iteration of ``train_epoch``, the lazy library loads and kernel
selection included: it ends in a loss read).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from ssds_tpu_torch import checkpoint as ckpt_lib
from ssds_tpu_torch.data.factory import load_data
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model, is_yolo
from ssds_tpu_torch.models.heads.common import finalize
from ssds_tpu_torch.ops.anchors import num_anchors_per_cell
from ssds_tpu_torch.ops.augment_device import augment_batch
from ssds_tpu_torch.ops.losses import multibox_loss, multibox_sums
from ssds_tpu_torch.ops.postprocess import PostProcessConfig, detect, detect_decoded
from ssds_tpu_torch.ops.yolo import yolo_loss, yolo_v2_loss
from ssds_tpu_torch.models.layers import recomputing
from ssds_tpu_torch.parallel import sharding, spatial
from ssds_tpu_torch.utils.profiler import annotate
from ssds_tpu_torch.utils.visualize import viz_feature_maps, viz_grads, viz_prior_box, viz_samples

# --------------------------------------------------------------------------
# LR schedule and optimizer (reference configure_lr_scheduler /
# configure_optimizer)
# --------------------------------------------------------------------------


def configure_lr_scheduler(train_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Step-indexed LR schedule from ``cfg.TRAIN.LR_SCHEDULER``, with warm-up.

    step / multi_step / exponential / sgdr (cosine with restarts every
    ``STEPS[0]`` epochs, or once over the run), epoch-granular like the
    reference, then a linear warm-up over ``WARM_UP_EPOCHS`` applied per step.
    Computed in float32 with the JAX schedule's operations, so the two agree
    to float32 rounding.
    """
    f32 = np.float32
    s = train_cfg.LR_SCHEDULER
    base = f32(train_cfg.OPTIMIZER.LEARNING_RATE)
    gamma = f32(s.GAMMA)
    lr_min = f32(s.LR_MIN)
    spe = f32(max(1, steps_per_epoch))
    kind = str(s.SCHEDULER)
    steps = [int(x) for x in (s.STEPS or [])]

    if kind == "step":
        size = f32(max(1, steps[0] if steps else 1))

        def sched(epoch):
            return base * gamma ** np.floor(epoch / size)
    elif kind == "multi_step":
        bounds = np.asarray(sorted(steps), f32)

        def sched(epoch):
            return base * gamma ** f32(np.sum(epoch >= bounds))
    elif kind == "exponential":

        def sched(epoch):
            return base * gamma ** np.floor(epoch)
    elif kind == "sgdr":
        period = f32(steps[0] if steps else int(train_cfg.MAX_EPOCHS))
        # the JAX schedule forms this product of Python floats in float64
        half_span = f32(0.5 * (float(train_cfg.OPTIMIZER.LEARNING_RATE) - float(s.LR_MIN)))

        def sched(epoch):
            t = np.mod(epoch, period) / period
            return lr_min + half_span * (f32(1.0) + np.cos(f32(np.pi) * t))
    else:
        raise ValueError(f"unknown LR_SCHEDULER.SCHEDULER={kind!r}")

    warm_steps = f32(float(s.WARM_UP_EPOCHS) * float(spe))

    def schedule(step: int) -> float:
        step = f32(step)
        lr = sched(step / spe)
        if warm_steps > 0 and step < warm_steps:
            lr = base * (step + f32(1.0)) / warm_steps
        return float(lr)

    return schedule


def trainable_mask(names: Iterable[str], scope: str, aliases=None) -> Dict[str, str]:
    """``{name: 'train' | 'freeze'}`` from TRAINABLE_SCOPE (reference
    ``trainable_param``), with the model's scope ``aliases``
    (:func:`ssds_tpu_torch.checkpoint.path_in_scope`). A scope that matches
    nothing trains everything, with a warning when the scope was not empty."""
    labels = {n: ("train" if ckpt_lib.path_in_scope(n, scope, aliases) else "freeze")
              for n in names}
    if all(v == "freeze" for v in labels.values()):
        if str(scope).strip():
            print(f"warning: TRAINABLE_SCOPE '{scope}' matches no parameter "
                  "path; training ALL parameters instead", flush=True)
        labels = {n: "train" for n in labels}
    return labels


class Adam(torch.optim.Optimizer):
    """optax's ``scale_by_adam(b1, b2, eps)`` then ``add_decayed_weights(wd)``
    then the LR (AdamW, decoupled decay): ``mu = (1 - b1) g + b1 mu``, ``nu =
    (1 - b2) g^2 + b2 nu``, ``u = mu_hat / (sqrt(nu_hat) + eps) + wd p``, ``p -=
    lr u``. The bias corrections ``1 - b^t`` are rounded to float32 as optax
    rounds them: ``torch.optim.AdamW`` forms them in float64, and at ``b2 =
    0.999`` the two differ by up to 5e-5 of the update."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["count"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                state["count"] += 1
                mu, nu = state["mu"], state["nu"]
                mu.copy_((1.0 - b1) * g + b1 * mu)
                nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
                bc1 = float(f32(1.0) - f32(b1) ** f32(state["count"]))
                bc2 = float(f32(1.0) - f32(b2) ** f32(state["count"]))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p.sub_(group["lr"] * u)


class RMSprop(torch.optim.Optimizer):
    """optax's ``scale_by_rms(decay=alpha, eps)`` then ``trace(momentum)``:
    ``nu = (1 - alpha) g^2 + alpha nu``, ``u = g / sqrt(nu + eps)`` (eps inside
    the root, where ``torch.optim.RMSprop`` adds it outside), ``t = u +
    momentum t``, ``p -= lr t``; weight decay is added to ``g`` first."""

    def __init__(self, params, lr: float, alpha: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            alpha, eps, momentum = group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - alpha) * (g * g) + alpha * nu)
                u = torch.rsqrt(nu + eps) * g
                if momentum:
                    u = state["trace"].copy_(u + momentum * state["trace"])
                p.sub_(group["lr"] * u)


def configure_optimizer(train_cfg, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                        scope_aliases=None):
    """The optimizer of ``cfg.TRAIN.OPTIMIZER`` over ``named_params``, equal to
    the JAX package's optax chains (``ssds_tpu/solver.py:152-213``):

    - ``sgd``: ``torch.optim.SGD`` (dampening 0, no Nesterov, decay added to
      the gradient) = ``add_decayed_weights -> trace -> lr``;
    - ``adam``: :class:`Adam` = ``scale_by_adam -> add_decayed_weights -> lr``
      (AdamW's decoupled decay, optax's float32 bias corrections);
    - ``rmsprop``: :class:`RMSprop` (decay 0.9, eps inside the root).

    Parameters outside TRAINABLE_SCOPE get ``requires_grad=False`` and stay
    out of the optimizer (no decay, no momentum: optax's ``set_to_zero``).
    Each ``DIFFERENTIAL_LEARNING_RATE`` entry ``[scope, mult]`` takes the
    trainable parameters under its scope that no earlier entry took, into a
    param group of its own whose ``mult`` scales the LR. The LR itself and
    ``CLIP_GRADIENT`` are applied per step by :func:`apply_gradients`.
    ``scope_aliases`` is the model's ``SCOPE_ALIASES``, for both scopes.
    """
    o = train_cfg.OPTIMIZER
    kind = str(o.OPTIMIZER)
    wd = float(o.WEIGHT_DECAY)
    momentum = float(o.MOMENTUM)
    eps = float(o.get("EPS", 1e-8))
    named = list(named_params)
    labels = trainable_mask([n for n, _ in named], str(train_cfg.TRAINABLE_SCOPE), scope_aliases)
    mults = {"train": 1.0}
    for i, (dscope, mult) in enumerate(o.get("DIFFERENTIAL_LEARNING_RATE") or []):
        key = f"dlr{i}"
        mults[key] = float(mult)
        for n, lab in labels.items():
            if lab == "train" and ckpt_lib.path_in_scope(n, str(dscope), scope_aliases):
                labels[n] = key
    for n, p in named:
        p.requires_grad_(labels[n] != "freeze")
    groups = []
    for key, mult in mults.items():
        params = [p for n, p in named if labels[n] == key]
        if params:
            groups.append({"params": params, "mult": mult, "name": key})
    lr = float(o.LEARNING_RATE)
    if kind == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum, dampening=0.0,
                               nesterov=False, weight_decay=wd)
    if kind == "adam":
        return Adam(groups, lr=lr, betas=(0.9, 0.999), eps=eps, weight_decay=wd)
    if kind == "rmsprop":
        return RMSprop(groups, lr=lr, alpha=0.9, eps=eps, momentum=momentum, weight_decay=wd)
    raise ValueError(f"unknown OPTIMIZER.OPTIMIZER={kind!r}")


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: ``g / norm * max_norm`` where
    ``norm >= max_norm`` (no epsilon), decided on the device."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def apply_gradients(optimizer: torch.optim.Optimizer, lr: float, clip: float = 0.0) -> None:
    """One update: each group's LR set to ``lr * mult`` (in float32, as the
    JAX schedule's product), its gradients clipped to ``clip`` by their own
    global norm (each optax ``multi_transform`` branch clips its own
    partition), then ``optimizer.step()``."""
    lr32 = np.float32(lr)
    for group in optimizer.param_groups:
        group["lr"] = float(lr32 * np.float32(group["mult"]))
        if clip > 0:
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if grads:
                _clip_by_global_norm(grads, clip)
    optimizer.step()


def forward_raw(model: torch.nn.Module, images_u8: torch.Tensor, means: torch.Tensor,
                dtype: torch.dtype):
    """``[B, H, W, 3]`` uint8 BGR -> the ``'train'`` phase's raw outputs
    (``(loc, conf)``, or a YOLO head's per-scale list): the mean subtracted
    in float32, then :func:`forward_input`."""
    return forward_input(model, images_u8.float() - means, dtype)


def forward_input(model: torch.nn.Module, x: torch.Tensor, dtype: torch.dtype):
    """Mean-subtracted float32 ``[B, H, W, 3]`` -> the ``'train'`` phase's raw
    outputs: NCHW, the model under autocast in ``dtype`` (bf16), or in
    float32 (float64 for a model made ``.double()``)."""
    x = x.permute(0, 3, 1, 2).contiguous()
    if dtype in (torch.float32, torch.float64):
        return model(x.to(dtype), phase="train")
    with torch.autocast(x.device.type, dtype=dtype):
        return model(x, phase="train")


AUG_SEED = 17  # the JAX step's PRNGKey(17), into which it folds the step


def aug_seed(step: int) -> int:
    """The device augmentation generator's seed at ``step``: ``(17, step)``."""
    return (AUG_SEED << 32) + int(step)


def check_finite(step: int, named: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """``TPU.DEBUG_NANS``: raise ``FloatingPointError`` at the first tensor
    of ``named`` (losses, then gradients) with a NaN or an infinity."""
    for name, t in named:
        if t is not None and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"TPU.DEBUG_NANS: step {step}: {name} is not finite")


def unwrap(model):
    """The model inside a ``DistributedDataParallel`` wrapper (or ``model``)."""
    return getattr(model, "module", model)


def detection_loss(model, priors, out, batch, seen_images: float = math.inf,
                   data_parallel: bool = False, spatial: int = 1):
    """``(loss_l, loss_c)`` of the raw outputs ``out`` on a device ``batch``:
    the MultiBox loss against ``priors``, or, for a YOLO model (``priors``
    None), ``yolo_loss`` (v3) or ``yolo_v2_loss`` (v2, whose prior-regression
    warm-up runs while ``seen_images`` < 12800; the default, inf, leaves it
    off, as the JAX package's eval loss does). A YOLO loss decodes against
    the images' own size, which is the model's input size.

    ``data_parallel`` (a train step of several ranks): the MultiBox sums are
    divided by the global batch's positive count (one all-reduce) over the
    data width ``D``, since the ranks' gradients are averaged over ``D``; the
    ranks' mean loss and gradient are then the global batch's, as the JAX
    step's over a sharded batch. On the spatial axis the ``spatial`` ranks of
    a data group hold the same images' loss, so the sum over the ranks counts
    each positive ``spatial`` times and is divided by it. A YOLO loss divides
    by the batch, so the ranks' mean is already the global batch's."""
    boxes, labels, valid = batch["boxes"], batch["labels"], batch["valid"]
    model = unwrap(model)
    if priors is not None:
        loc, conf = out
        if not data_parallel:
            return multibox_loss(loc, conf, boxes, labels, valid, priors)
        loss_l, loss_c, num_pos = multibox_sums(loc, conf, boxes, labels, valid, priors)
        n = torch.clamp(sharding.all_reduce_sum_(num_pos) / spatial, min=1.0)
        n = n / (sharding.world_size() // spatial)
        return loss_l / n, loss_c / n
    img_hw = tuple(batch["images"].shape[1:3])
    anchors = model.anchor_tensors(boxes.device)
    if model.version == 2:
        return yolo_v2_loss(out, anchors, boxes, labels, valid, img_hw, seen_images=seen_images)
    return yolo_loss(out, anchors, boxes, labels, valid, img_hw)


def detections(model, priors, out, img_hw, post: PostProcessConfig) -> torch.Tensor:
    """Dense rows ``[B, C, max_det, 5]`` of the raw outputs ``out``:
    ``detect`` of the eval packaging (float32 softmax) against ``priors``, or
    for a YOLO model (``priors`` None) ``detect_decoded`` of its boxes
    decoded against ``img_hw``, the input images' size (the JAX model
    decodes against its input's shape)."""
    if priors is None:
        return detect_decoded(*model.decode(out, img_hw), post)
    return detect(*finalize("eval", *out), priors, post)


def build_train_step(model, priors, optimizer, lr_schedule, dtype, pixel_means,
                     clip: float = 0.0, device_aug_prob: float = 0.0, debug_nans: bool = False,
                     plan: Optional[spatial.SpatialPlan] = None, remat: bool = False):
    """The per-iteration body: ``train_step(batch, step) -> {"loss", "loss_l",
    "loss_c"}`` (device scalars), the model in train mode. ``batch`` holds
    ``images`` (uint8 NHWC), ``boxes``, ``labels`` and ``valid`` on the
    model's device; ``step`` indexes ``lr_schedule``, counts the images a
    YOLOv2 loss has seen (``step * batch``) and seeds the device
    augmentation. ``priors`` is None for a YOLO model
    (:func:`detection_loss`). ``device_aug_prob`` > 0 augments the batch on
    the device with that ``PROB`` (:func:`augment_batch`, the pixel means
    ``pixel_means``); ``debug_nans`` raises at a non-finite loss or gradient
    (:func:`check_finite`) before the update.

    ``model`` may be a ``DistributedDataParallel`` wrapper: under a process
    group of several ranks ``batch`` is this rank's share of the global
    batch, and the step keeps the global batch's reductions (the loss's
    normaliser, YOLOv2's ``step * global batch``, the augmentation's draws;
    the BatchNorms' statistics are the layers' own).

    ``plan`` (the spatial axis; ``model`` partitioned by
    :func:`ssds_tpu_torch.parallel.spatial.partition` and not wrapped):
    ``batch`` is this rank's data group's share, whole images, augmented
    whole; the forward takes this rank's band of rows and gives the whole
    images' outputs, the loss counts each positive once, and the gradients
    are reduced over the world by :func:`spatial.reduce_gradients`.
    ``remat`` (``TPU.REMAT``) runs the forward under
    ``torch.utils.checkpoint`` (non-reentrant, recomputed in full, inside
    :func:`recomputing`)."""
    device = next(model.parameters()).device
    means = torch.tensor(tuple(pixel_means), dtype=torch.float32, device=device)
    aug_gen = torch.Generator(device=device) if device_aug_prob > 0 else None
    named = list(unwrap(model).named_parameters())
    world, rank = sharding.world_size(), sharding.rank()
    width = plan.size if plan is not None else 1
    groups = world // width  # the data width D

    def run(x):
        with spatial.active(plan):
            return forward_input(model, x, dtype)

    def forward(x):
        if not remat:
            return run(x)
        # recomputed in full: a recompute stopped early could skip a
        # collective that another rank's recompute makes
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return torch.utils.checkpoint.checkpoint(
                run, x, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), recomputing()))

    def train_step(batch, step: int) -> Dict[str, torch.Tensor]:
        model.train()  # BatchNorm on batch statistics, as the JAX step's train=True
        x = batch["images"].float() - means
        if aug_gen is not None:
            aug_gen.manual_seed(aug_seed(step))
            x, boxes, valid = augment_batch(aug_gen, x, batch["boxes"], batch["valid"],
                                            device_aug_prob, means, shard=(rank // width, groups))
            batch = dict(batch, boxes=boxes, valid=valid)
        if plan is not None:
            spatial.check_height(x.shape[1], width)
            a, b = plan.rows(x.shape[1])
            x = x[:, a:b]
        with annotate("step.forward"):
            out = forward(x)
        with annotate("step.loss"):
            loss_l, loss_c = detection_loss(model, priors, out, batch,
                                            seen_images=step * batch["images"].shape[0] * groups,
                                            data_parallel=world > 1, spatial=width)
            loss = loss_l + loss_c
        with annotate("step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if plan is not None:
                spatial.reduce_gradients([p for _, p in named], groups)
            if debug_nans:
                check_finite(step, [("loss_l", loss_l), ("loss_c", loss_c)]
                             + [(f"the gradient of {n}", p.grad) for n, p in named])
        with annotate("step.optimizer"):
            apply_gradients(optimizer, lr_schedule(step), clip)
        return {"loss": loss.detach(), "loss_l": loss_l.detach(), "loss_c": loss_c.detach()}

    return train_step


# --------------------------------------------------------------------------
# Solver
# --------------------------------------------------------------------------


class Solver:
    """The train / eval / test lifecycle (reference ``class Solver``).

    Args:
      cfg: the full config tree.
      device: where the model trains; ``"cuda"`` raises without a GPU, and
        under a process group of several ranks means ``cuda:{LOCAL_RANK}``
        (:func:`ssds_tpu_torch.parallel.sharding.rank_device`).
      writer: a summary writer (``add_scalar(tag, value, step)``; and
        ``add_image`` / ``add_histogram`` for ``visualize_epoch``); when
        None, ``torch.utils.tensorboard.SummaryWriter`` on ``LOG_DIR`` is made
        at first use (without the ``tensorboard`` package, a JSON-lines file
        there).
      seed: seeds the model's random init (before any checkpoint is loaded).
    """

    def __init__(self, cfg, device="cuda", writer=None, seed: int = 0):
        self.cfg = cfg
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Solver: device 'cuda' asked for, but no GPU is available")
        self.spatial_size = sharding.spatial_size(cfg.TPU)  # S
        if self.spatial_size > 1:
            spatial.check_model(cfg.MODEL, self.spatial_size)
        self.data_size = sharding.data_parallel_size(cfg.TPU, int(cfg.TRAIN.BATCH_SIZE))  # D
        self.world = sharding.world_size()
        self.rank = sharding.rank()
        self.device = sharding.rank_device(device)
        t0 = time.perf_counter()
        model, self.feature_maps = create_model(cfg.MODEL)
        self.model = init_model(model, seed=seed, device=self.device)
        self.setup_s = {"model": time.perf_counter() - t0}  # one-off host seconds
        self.img_hw = (int(cfg.MODEL.IMAGE_SIZE[0]), int(cfg.MODEL.IMAGE_SIZE[1]))
        self.is_yolo = is_yolo(cfg.MODEL)
        self.priors = None if self.is_yolo else torch.from_numpy(
            create_priors(cfg.MODEL, self.feature_maps)).to(self.device)
        # bf16 only when both say so (ssds_tpu/solver.py:306-309)
        self.compute_dtype = torch.bfloat16 if (
            bool(cfg.MODEL.HALF_PRECISION) and str(cfg.TPU.COMPUTE_DTYPE) == "bfloat16"
        ) else torch.float32
        self.means = torch.tensor(tuple(cfg.DATASET.PIXEL_MEANS), dtype=torch.float32,
                                  device=self.device)
        self.post_cfg = PostProcessConfig.from_cfg(cfg.POST_PROCESS)

        self.exp_dir = cfg.EXP_DIR
        self.prefix = cfg.CHECKPOINTS_PREFIX
        os.makedirs(self.exp_dir, exist_ok=True)
        self.writer = writer
        self._own_writer = False
        self.start_epoch = 0
        self.max_epochs = int(cfg.TRAIN.MAX_EPOCHS)
        self.phases = list(cfg.PHASE)
        self.loaders = {}
        self.optimizer = None
        self.lr_schedule = None
        self.step = 0
        self._train_step = None
        self._checkpointer = None
        self._ddp = None  # the DistributedDataParallel wrapper, under several ranks

    # -- data ---------------------------------------------------------------

    def get_loader(self, phase: str):
        """The phase's loader; the train loader is this rank's data group's
        interleaved share at ``TRAIN.BATCH_SIZE / D`` (``ssds_tpu/solver.py:343-357``),
        the same on the group's ``S`` spatial ranks."""
        if phase not in self.loaders:
            train = phase == "train"
            bs = int(self.cfg.TRAIN.BATCH_SIZE if train else self.cfg.TEST.BATCH_SIZE)
            self.loaders[phase] = load_data(
                self.cfg.DATASET, phase, image_size=self.cfg.MODEL.IMAGE_SIZE,
                batch_size=bs // self.data_size if train else bs,
                shard_id=self.rank // self.spatial_size if train else 0,
                num_shards=self.data_size if train else 1)
        return self.loaders[phase]

    def _upload(self, batch, keys=("images", "boxes", "labels", "valid")):
        """Host arrays to the device: pinned, non-blocking copies on CUDA."""
        out = {}
        for k in keys:
            t = torch.from_numpy(batch[k])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- state / resume -------------------------------------------------------

    def build_state(self, steps_per_epoch: int):
        """Schedule and optimizer; the step counter continues from the
        restored epoch, so the schedule (warm-up included) does too."""
        self.lr_schedule = configure_lr_scheduler(self.cfg.TRAIN, steps_per_epoch)
        self.optimizer = configure_optimizer(self.cfg.TRAIN, self.model.named_parameters(),
                                             getattr(self.model, "SCOPE_ALIASES", None))
        self.step = self.start_epoch * steps_per_epoch

    def restore(self):
        """Auto-resume from the manifest's newest checkpoint, else graft
        ``RESUME_CHECKPOINT`` under ``TRAIN.RESUME_SCOPE`` (reference
        ``find_previous`` / ``resume_checkpoint``)."""
        previous = ckpt_lib.find_previous(self.exp_dir)
        if previous:
            epochs, paths = previous
            self.start_epoch = epochs[-1]
            sd = ckpt_lib.resume_checkpoint(self.model.state_dict(), paths[-1], "")
        elif self.cfg.RESUME_CHECKPOINT:
            sd = ckpt_lib.resume_checkpoint(self.model.state_dict(), self.cfg.RESUME_CHECKPOINT,
                                            str(self.cfg.TRAIN.RESUME_SCOPE),
                                            getattr(self.model, "SCOPE_ALIASES", None))
        else:
            return
        self.model.load_state_dict(sd)

    def save(self, epoch: int):
        """Checkpoint the model (the module inside DDP: no ``module.``
        prefix), from rank 0 alone."""
        if self.rank != 0:
            return
        if self._checkpointer is None:
            self._checkpointer = ckpt_lib.AsyncCheckpointer()
        self._checkpointer.save(self.exp_dir, self.prefix, epoch, self.model.state_dict())

    # -- steps ----------------------------------------------------------------

    def make_train_step(self):
        device_aug = bool(self.cfg.DATASET.get("DEVICE_AUG", False))
        plan = None
        if self.spatial_size > 1:  # the row layers on bands (inert outside the step)
            spatial.partition(self.model, self.img_hw)
            plan = spatial.SpatialPlan.for_rank(self.rank, self.world, self.spatial_size)
        return build_train_step(self._ddp or self.model, self.priors, self.optimizer,
                                self.lr_schedule, self.compute_dtype, self.cfg.DATASET.PIXEL_MEANS,
                                clip=float(self.cfg.TRAIN.OPTIMIZER.get("CLIP_GRADIENT", 0.0) or 0.0),
                                device_aug_prob=float(self.cfg.DATASET.PROB) if device_aug else 0.0,
                                debug_nans=bool(self.cfg.TPU.get("DEBUG_NANS", False)),
                                plan=plan, remat=bool(self.cfg.TPU.get("REMAT", False)))

    def make_eval_step(self):
        """One forward per batch gives both the eval loss and the detections
        (reference ``eval_epoch``): ``eval_step(batch) -> (loss_l, loss_c,
        dets [B, C, max_det, 5])``, the model in eval mode (the train step
        puts it back in train mode)."""

        @torch.no_grad()
        def eval_step(batch):
            self.model.eval()  # BatchNorm on running statistics, as JAX's train=False
            out = forward_raw(self.model, batch["images"], self.means, self.compute_dtype)
            ll, lc = detection_loss(self.model, self.priors, out, batch)
            return ll, lc, detections(self.model, self.priors, out,
                                      tuple(batch["images"].shape[1:3]), self.post_cfg)

        return eval_step

    def make_eval_forward(self):
        """``eval_forward(images_u8) -> dets [B, C, max_det, 5]``."""

        @torch.no_grad()
        def eval_forward(images):
            self.model.eval()
            out = forward_raw(self.model, images, self.means, self.compute_dtype)
            return detections(self.model, self.priors, out, tuple(images.shape[1:3]),
                              self.post_cfg)

        return eval_forward

    # -- epochs ---------------------------------------------------------------

    def _get_writer(self):
        """The writer given, else TensorBoard's on ``LOG_DIR``, else (no
        ``tensorboard`` package) :class:`~ssds_tpu_torch.utils.summary.JsonLinesWriter`."""
        if self.writer is None:
            os.makedirs(self.cfg.LOG_DIR, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                from ssds_tpu_torch.utils.summary import JsonLinesWriter

                self.writer = JsonLinesWriter(self.cfg.LOG_DIR)
                print(f"no tensorboard: summaries go to {self.writer.path}", flush=True)
            else:
                self.writer = SummaryWriter(log_dir=self.cfg.LOG_DIR)
            self._own_writer = True
        return self.writer

    def _wrap_ddp(self):
        """Wrap the model in ``DistributedDataParallel`` (several ranks
        and no spatial axis, whose step reduces its own gradients; after the
        optimizer has set which parameters train). Buffers are not
        broadcast: the BatchNorms' running statistics are global and equal on
        every rank."""
        if self.world > 1 and self.spatial_size == 1 and self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel

            ids = [self.device.index] if self.device.type == "cuda" else None
            self._ddp = DistributedDataParallel(self.model, device_ids=ids,
                                                broadcast_buffers=False)
        return self._ddp

    def train_model(self):
        loader = self.get_loader("train")
        steps_per_epoch = len(loader)
        self.restore()
        self.build_state(steps_per_epoch)
        self._wrap_ddp()
        self._train_step = self.make_train_step()
        writer = self._get_writer()

        for epoch in range(self.start_epoch + 1, self.max_epochs + 1):
            t0 = time.time()
            metrics = self.train_epoch(loader, writer)
            lr = self.lr_schedule(self.step)
            print(f"epoch {epoch}/{self.max_epochs} loss_l={metrics['loss_l']:.4f} "
                  f"loss_c={metrics['loss_c']:.4f} lr={lr:.6f} ({time.time() - t0:.1f}s)",
                  flush=True)
            writer.add_scalar("loss_loc", metrics["loss_l"], epoch)
            writer.add_scalar("loss_conf", metrics["loss_c"], epoch)
            writer.add_scalar("lr", lr, epoch)

            scope = self.cfg.TEST.TEST_SCOPE
            if "eval" in self.phases and scope[0] <= epoch <= scope[1]:
                self.eval_epoch(epoch, writer)
            if "visualize" in self.phases:
                self.visualize_epoch(epoch)
            if epoch % int(self.cfg.TRAIN.CHECKPOINTS_EPOCHS) == 0 or epoch == self.max_epochs:
                self.save(epoch)
        if self._checkpointer is not None:
            self._checkpointer.wait()  # every checkpoint on disk
        if self.world > 1:
            torch.distributed.barrier()  # ... before any rank reads one

    def _host_losses(self, metrics) -> Dict[str, float]:
        """Device loss scalars on the host: their means over the ranks."""
        keys = list(metrics)
        with annotate("solver.host_read"):
            return dict(zip(keys, sharding.all_reduce_mean([metrics[k] for k in keys])))

    def train_epoch(self, loader, writer=None):
        """One pass over ``loader``; returns the epoch means of every step's
        losses (the ranks' means). They add up on the device; the host reads
        them at the first and every 10th step (printing) and at the end."""
        acc = None
        n = 0
        total = len(loader)
        t0 = time.time()
        with annotate("solver.epoch"):
            for batch in loader:
                with annotate("solver.step"):
                    first = time.perf_counter() if "first_step" not in self.setup_s else None
                    with annotate("solver.upload"):
                        dev = self._upload(batch)
                    metrics = self._train_step(dev, self.step)
                    self.step += 1
                    acc = metrics if acc is None else {k: acc[k] + v for k, v in metrics.items()}
                    n += 1
                    if n % 10 == 0 or n == 1:
                        m = self._host_losses(metrics)
                        if writer is not None:
                            writer.add_scalar("iter_loss_loc", m["loss_l"], self.step)
                            writer.add_scalar("iter_loss_conf", m["loss_c"], self.step)
                        if n > 1:
                            eta = (time.time() - t0) / n * (total - n)
                            print(f"  iter {n}/{total} loss_l={m['loss_l']:.4f} "
                                  f"loss_c={m['loss_c']:.4f} eta={eta:.0f}s", flush=True)
                    if first is not None:  # this iteration ended in its loss read (n == 1)
                        self.setup_s["first_step"] = time.perf_counter() - first
            if acc is None:
                return {"loss": 0.0, "loss_l": 0.0, "loss_c": 0.0}
            return {k: v / n for k, v in self._host_losses(acc).items()}

    def eval_epoch(self, epoch, writer=None):
        """Loss and mAP over the eval set, from one forward per batch."""
        mAP, loss_l, loss_c = self._run_detection_eval(self.get_loader("eval"), with_loss=True)
        print(f"eval epoch {epoch}: loss_l={loss_l:.4f} loss_c={loss_c:.4f} mAP={mAP:.4f}",
              flush=True)
        if writer:
            writer.add_scalar("Eval/loss_loc", loss_l, epoch)
            writer.add_scalar("Eval/loss_conf", loss_c, epoch)
            writer.add_scalar("Eval/mAP", mAP, epoch)
        return mAP

    def _collect_detections(self, loader, offset: int = 0, with_loss: bool = False):
        """The eval forward over ``loader``: ``(results, loss_sums)``, results
        ``{image index: {class: [N, 5] (x1, y1, x2, y2, score) in pixels}}``
        and loss_sums ``(sum loss_l, sum loss_c, batches)`` when
        ``with_loss``, both from one pass. ``offset`` is the dataset index of
        the loader's first image (a rank's range, :meth:`DetectionLoader.range_view`).
        The next batch's forward is queued before the previous batch's
        detections are read back."""
        step = self.make_eval_step() if with_loss else self.make_eval_forward()
        num_classes = self.post_cfg.num_classes
        start, end = loader.image_span()
        n_expected = end - start  # the last batch wraps around: skip the repeats
        loss_acc = []

        def forward_batches():
            pending = None
            for batch in loader:
                if with_loss:
                    ll, lc, out = step(self._upload(batch))
                    loss_acc.append((ll, lc))
                else:
                    out = step(self._upload(batch, ("images",))["images"])
                if pending is not None:
                    yield pending[0].cpu().numpy(), pending[1]
                pending = (out, batch.get("sizes"))
            if pending is not None:
                yield pending[0].cpu().numpy(), pending[1]

        results = {}
        img_index = 0
        for dets, sizes in forward_batches():
            for i in range(dets.shape[0]):
                if img_index >= n_expected:
                    break
                h, w = sizes[i] if sizes is not None else self.img_hw
                scale = np.array([w, h, w, h], np.float32)
                per_cls = {}
                for c in range(1, num_classes):
                    rows = dets[i, c]
                    keep = rows[:, 0] > 0
                    if keep.any():
                        per_cls[c] = np.hstack([rows[keep][:, 1:5] * scale,
                                                rows[keep][:, 0:1]]).astype(np.float32)
                if per_cls:
                    results[offset + img_index] = per_cls
                img_index += 1
        loss_sums = None
        if with_loss:
            sums = [0.0, 0.0]
            if loss_acc:
                sums = torch.stack([torch.stack(p) for p in loss_acc]).double().sum(0).tolist()
            loss_sums = (sums[0], sums[1], len(loss_acc))
        return results, loss_sums

    def _run_detection_eval(self, loader, procs=None, pid=None, gather=None,
                            with_loss: bool = False):
        """mAP over ``loader``'s dataset through its ``evaluate_detections``;
        ``(mAP, loss_l, loss_c)`` when ``with_loss``.

        Several ranks (``ssds_tpu/solver.py:690-731``): each forwards its
        contiguous image range, and the detections and loss sums merge over
        ``gather`` (:func:`~ssds_tpu_torch.parallel.sharding.allgather_pickled`).
        Rank 0 scores the merged detections (the dataset's eval writes its
        files into ``EXP_DIR``, which the ranks share) and gathers the mAP to
        every rank. ``procs`` / ``pid`` / ``gather`` default to the process
        group's and can be injected by tests."""
        procs = self.world if procs is None else procs
        pid = self.rank if pid is None else pid
        gather = gather if gather is not None else sharding.allgather_pickled
        dataset = loader.dataset
        n_images = len(dataset)
        num_classes = self.post_cfg.num_classes
        if procs > 1:
            start, end = pid * n_images // procs, (pid + 1) * n_images // procs
            dets, loss_sums = self._collect_detections(loader.range_view(start, end),
                                                       offset=start, with_loss=with_loss)
            merged, sums = {}, [0.0, 0.0, 0]
            for shard_dets, shard_sums in gather((dets, loss_sums)):
                merged.update(shard_dets)
                if shard_sums is not None:
                    sums = [a + b for a, b in zip(sums, shard_sums)]
            dets, loss_sums = merged, tuple(sums)
        else:
            dets, loss_sums = self._collect_detections(loader, with_loss=with_loss)
        mAP = None
        if pid == 0:
            all_boxes = [[[] for _ in range(n_images)] for _ in range(num_classes)]
            for idx, per_cls in dets.items():
                for c, arr in per_cls.items():
                    all_boxes[c][idx] = arr
            mAP = dataset.evaluate_detections(all_boxes, self.exp_dir)
        if procs > 1:
            mAP = gather(mAP)[0]
        if not with_loss:
            return mAP
        n = max(1, loss_sums[2])
        return mAP, loss_sums[0] / n, loss_sums[1] / n

    def test_model(self):
        """mAP over TEST_SETS; a Solver that has not trained first loads the
        newest checkpoint (or RESUME_CHECKPOINT)."""
        if self.optimizer is None:
            self.restore()
        mAP = self._run_detection_eval(self.get_loader("test"))
        print(f"test: mAP={mAP:.4f}", flush=True)
        return mAP

    def visualize_epoch(self, epoch: int = 0):
        """Summary images and histograms (reference ``visualize_epoch``,
        ``ssds_tpu/solver.py:741-777``): the priors (per level, for a head
        with priors), the first ``visualize`` batch's samples with their
        boxes, the feature maps of its first image and one histogram per
        parameter of the loss's gradient on that batch (BatchNorm on its
        running statistics, as the JAX package's ``train=False``)."""
        writer = self._get_writer()
        if self.priors is not None:
            viz_prior_box(writer, self.priors.cpu().numpy(), self.img_hw, epoch,
                          feature_maps=self.feature_maps,
                          anchors_per_cell=num_anchors_per_cell(
                              tuple(tuple(a) for a in self.cfg.MODEL.ASPECT_RATIOS)))
        loader = self.get_loader("visualize")
        viz_samples(writer, loader, epoch)
        for batch in loader:
            x = torch.from_numpy(batch["images"][:1]).to(self.device).float() - self.means
            self.model.eval()
            with torch.no_grad():
                feats = self.model(x.permute(0, 3, 1, 2).contiguous(), phase="feature")
            viz_feature_maps(writer, [f.permute(0, 2, 3, 1).float().cpu().numpy()
                                      for f in feats], epoch)
            grads = self._grads_for_batch(batch)
            viz_grads(writer, {tuple(n.split(".")): g for n, g in grads.items()}, epoch)
            break

    def _grads_for_batch(self, batch) -> Dict[str, np.ndarray]:
        """The eval loss's gradient on ``batch`` for every parameter, frozen
        ones too (as ``jax.grad`` over the JAX package's parameters gives)."""
        named = list(self.model.named_parameters())
        trains = [p.requires_grad for _, p in named]
        self.model.eval()
        try:
            for _, p in named:
                p.requires_grad_(True)
            dev_batch = self._upload(batch)
            out = forward_raw(self.model, dev_batch["images"], self.means, self.compute_dtype)
            loss_l, loss_c = detection_loss(self.model, self.priors, out, dev_batch)
            grads = torch.autograd.grad(loss_l + loss_c, [p for _, p in named], allow_unused=True)
        finally:
            for (_, p), t in zip(named, trains):
                p.requires_grad_(t)
        return {n: (torch.zeros_like(p) if g is None else g).float().cpu().numpy()
                for (n, p), g in zip(named, grads)}

    def close(self):
        """Wait for the checkpoint writes, then end the loaders' worker
        processes, the checkpoint thread and a writer this Solver made."""
        try:
            if self._checkpointer is not None:
                self._checkpointer.close()
                self._checkpointer = None
        finally:
            for loader in self.loaders.values():
                loader.close()
            if self._own_writer:
                self.writer.close()


def train_model(cfg, device="cuda"):
    s = Solver(cfg, device=device)
    try:
        s.train_model()
    finally:
        s.close()
    return s


def test_model(cfg, device="cuda"):
    s = Solver(cfg, device=device)
    try:
        return s.test_model()
    finally:
        s.close()
