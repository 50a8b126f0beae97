"""The training steps the configurations state, in plain PyTorch.

SGD with momentum and weight decay (ssds.pytorch's ``torch.optim.SGD``:
``d = g + wd p``, ``buf = d`` at the first step and ``momentum buf + d``
after, ``p -= lr buf``), every parameter trained, BatchNorm running
statistics blended from each step's batch. The learning rate is the
configuration's step-indexed schedule (``LR_SCHEDULER``: step, multi_step,
exponential or sgdr, epoch-granular) with a linear warm-up over
``WARM_UP_EPOCHS``, in float32.

:func:`train_steps` runs a few steps and reports what the benchmark compares:
each step's losses, the first step's momentum buffer a leaf (the gradient as
the optimizer takes it, decay included), the first step's gradient a leaf,
and after the last step the change of every leaf and running statistic.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.reference.layers import Ops


def lr_schedule(train_cfg, steps_per_epoch: int) -> Callable[[int], float]:
    f32 = np.float32
    s = train_cfg["LR_SCHEDULER"]
    base = f32(train_cfg["OPTIMIZER"]["LEARNING_RATE"])
    gamma, lr_min = f32(s["GAMMA"]), f32(s["LR_MIN"])
    spe = f32(max(1, steps_per_epoch))
    kind = str(s["SCHEDULER"])
    steps = [int(x) for x in (s["STEPS"] or [])]
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
        period = f32(steps[0] if steps else int(train_cfg["MAX_EPOCHS"]))
        half = f32(0.5 * (float(train_cfg["OPTIMIZER"]["LEARNING_RATE"]) - float(s["LR_MIN"])))

        def sched(epoch):
            return lr_min + half * (f32(1.0) + np.cos(f32(np.pi) * (np.mod(epoch, period) / period)))
    else:
        raise ValueError(f"unknown LR_SCHEDULER.SCHEDULER={kind!r}")
    warm = f32(float(s["WARM_UP_EPOCHS"]) * float(spe))

    def lr(step: int) -> float:
        step = f32(step)
        out = sched(step / spe)
        if warm > 0 and step < warm:
            out = base * (step + f32(1.0)) / warm
        return float(out)

    return lr


def train_steps(model, cfg, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], first_step: int, steps_per_epoch: int,
                precision: str = "float32", half_batch: bool = False) -> dict:
    """Train ``params`` (leaves that require no grad yet) in place over
    ``batches``, one step each, from schedule step ``first_step``.

    ``model`` is a reference module (``train_loss``, ``priors``).
    ``half_batch`` is a planted fault: each step's loss over the first half
    of the batch only. Returns ``losses`` ``[(loss_l, loss_c)]``, and a leaf's
    norms: ``buf1`` (momentum buffer after step 1), ``grad1`` (step 1's
    gradient), ``change`` (``|p_end - p_0|``, running statistics included)."""
    opt = cfg["TRAIN"]["OPTIMIZER"]
    if str(opt["OPTIMIZER"]) != "sgd" or float(opt.get("CLIP_GRADIENT", 0) or 0) > 0:
        raise ValueError("the reference trains with SGD and no clipping only")
    wd, momentum = float(opt["WEIGHT_DECAY"]), float(opt["MOMENTUM"])
    lr = lr_schedule(cfg["TRAIN"], steps_per_epoch)
    prior = model.priors(cfg, next(iter(params.values())).device)
    start = {k: v.detach().clone() for k, v in {**params, **buffers}.items()}
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    bufs: Dict[str, torch.Tensor] = {}
    out = {"losses": [], "buf1": {}, "grad1": {}}
    for i, batch in enumerate(batches):
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        ops = Ops({**leaves, **buffers}, precision=precision, train=True)
        loss_l, loss_c = model.train_loss(ops, batch, cfg, prior)
        grads = torch.autograd.grad(loss_l + loss_c, list(leaves.values()))
        ops.update_running_stats(buffers)
        rate = lr(first_step + i)
        with torch.no_grad():
            for (name, p), g in zip(leaves.items(), grads):
                d = g + wd * p
                bufs[name] = d.clone() if name not in bufs else bufs[name].mul_(momentum).add_(d)
                p.sub_(rate * bufs[name])
                if i == 0:
                    out["buf1"][name] = float(torch.linalg.vector_norm(bufs[name]))
                    out["grad1"][name] = float(torch.linalg.vector_norm(g))
        out["losses"].append((float(loss_l.detach()), float(loss_c.detach())))
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm((v.float() - start[k].float())))
                         for k, v in {**params, **buffers}.items()
                         if not k.endswith("num_batches_tracked")}
    return out
