"""Epoch loss curves of the JAX package and the port, side by side, on the CPU.

    python tests/torch_port_loss_curves.py [--epochs 30] [--against jax|port_ulp] [--out PATH]

The recipe of ``chip_smoke.py``'s training phase (SGD, LR 1e-3, momentum
0.9, weight decay 5e-4, the default ``step`` schedule with gamma 0.98 an
epoch, no warm-up, no augmentation, batch 32 over 64 synthetic images,
float32,
``ssds_tpu_torch.tools.synth_voc``) at the narrow 64 px SSD-VGG16 config of
``tests/test_torch_port_train.py::CFG``. Both packages start from the same
weights (the JAX init, carried by ``state_dict_from_jax``) and see the same
batches in the same order (a numpy permutation an epoch); each prints its
epoch means of ``loss_l`` and ``loss_c`` and the largest relative gap
between the two curves. ``--against port_ulp`` is the control: in place of
the JAX package, a second copy of the port whose initial weights are each
moved by one float32 ulp (up or down at random), which shows how far two
runs that differ only by float32 rounding drift apart on this recipe. Runs
for minutes; not a test.
"""

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import conftest  # noqa: E402,F401  (the CPU backend, before any jax use)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ssds_tpu.config import default_config as jax_default_config  # noqa: E402
from ssds_tpu.models import builder as jbuilder  # noqa: E402
from ssds_tpu.solver import TrainState  # noqa: E402
from ssds_tpu.solver import build_train_step as jax_build_train_step  # noqa: E402
from ssds_tpu.solver import configure_lr_scheduler as jax_sched  # noqa: E402
from ssds_tpu.solver import configure_optimizer as jax_opt  # noqa: E402
from ssds_tpu_torch.config import default_config  # noqa: E402
from ssds_tpu_torch.data.voc import VOC_CLASSES  # noqa: E402
from ssds_tpu_torch.models.builder import create_model, create_priors, init_model  # noqa: E402
from ssds_tpu_torch.solver import (build_train_step, configure_lr_scheduler,  # noqa: E402
                                   configure_optimizer)
from ssds_tpu_torch.tools.synth_voc import sample  # noqa: E402
from ssds_tpu_torch.weights import state_dict_from_jax  # noqa: E402

SIZE, N_IMAGES, BATCH, MAX_GT = 64, 64, 32, 8
MODEL = dict(IMAGE_SIZE=[SIZE, SIZE], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
             ASPECT_RATIOS=[[2], [2, 3], [2, 3]])


def dataset(seed):
    """uint8 images ``[N, 64, 64, 3]`` and padded GT (corner boxes in [0, 1])."""
    images = np.zeros((N_IMAGES, SIZE, SIZE, 3), np.uint8)
    boxes = np.zeros((N_IMAGES, MAX_GT, 4), np.float32)
    labels = np.zeros((N_IMAGES, MAX_GT), np.int32)
    valid = np.zeros((N_IMAGES, MAX_GT), bool)
    for i in range(N_IMAGES):
        images[i], objects = sample(seed, i, SIZE)
        for j, (name, x1, y1, x2, y2) in enumerate(objects):
            boxes[i, j] = ((x1 - 1) / SIZE, (y1 - 1) / SIZE, x2 / SIZE, y2 / SIZE)
            labels[i, j] = VOC_CLASSES.index(name)
            valid[i, j] = True
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid}


def batches(data, epoch, seed):
    order = np.random.default_rng([seed, epoch]).permutation(N_IMAGES)
    for s in range(0, N_IMAGES, BATCH):
        idx = order[s:s + BATCH]
        yield {k: v[idx] for k, v in data.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--against", choices=("jax", "port_ulp"), default="jax")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    jcfg, cfg = jax_default_config(), default_config()
    for c in (jcfg, cfg):
        c.MODEL.update(MODEL)
        c.TRAIN.update(MAX_EPOCHS=args.epochs)
    jcfg.MODEL.S2D_STEM = 0
    jmodel, fmaps = jbuilder.create_model(jcfg.MODEL)
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, SIZE, SIZE, 3)), phase="train"))(
        jax.random.PRNGKey(args.seed))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tmodel, tfmaps = create_model(cfg.MODEL)
    tmodel = init_model(tmodel, args.seed)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    priors = create_priors(cfg.MODEL, tfmaps)
    data = dataset(args.seed)
    spe = N_IMAGES // BATCH
    means = cfg.DATASET.PIXEL_MEANS

    tx = jax_opt(jcfg.TRAIN, jax_sched(jcfg.TRAIN, spe))(variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats={},
                       opt_state=tx.init(variables["params"]), tx=tx)
    jstep = jax_build_train_step(jmodel, jnp.asarray(priors), False, (SIZE, SIZE), jnp.float32,
                                 pixel_means=means)

    def port_step(model):
        return build_train_step(model.train(), torch.from_numpy(priors),
                                configure_optimizer(cfg.TRAIN, model.named_parameters()),
                                configure_lr_scheduler(cfg.TRAIN, spe), torch.float32, means)

    tstep = port_step(tmodel)
    if args.against == "port_ulp":
        other = copy.deepcopy(tmodel)
        gen = torch.Generator().manual_seed(args.seed)
        with torch.no_grad():
            for p in other.parameters():
                up = torch.rand(p.shape, generator=gen) < 0.5
                p.copy_(torch.where(up, torch.nextafter(p, p + 1), torch.nextafter(p, p - 1)))
        ostep = port_step(other)

        def jstep(state, batch):
            m = ostep({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, state)
            return state + 1, m

        state = 0
    curves = {"jax": [], "port": []}  # "jax": the control under --against port_ulp
    step = 0
    for epoch in range(args.epochs):
        sums = {"jax": np.zeros(2), "port": np.zeros(2)}
        for batch in batches(data, epoch, args.seed):
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            sums["jax"] += (float(m["loss_l"]), float(m["loss_c"]))
            m = tstep({k: torch.from_numpy(v) for k, v in batch.items()}, step)
            sums["port"] += (float(m["loss_l"]), float(m["loss_c"]))
            step += 1
        for k in curves:
            curves[k].append((sums[k] / spe).tolist())
        (jl, jc), (pl, pc) = curves["jax"][-1], curves["port"][-1]
        print(f"epoch {epoch + 1:3d}  {args.against} loss_l {jl:.5f} loss_c {jc:.5f}   port loss_l {pl:.5f} "
              f"loss_c {pc:.5f}   rel gap {abs(pl - jl) / jl:.2e} {abs(pc - jc) / jc:.2e}",
              flush=True)
    gap = [max(abs(p - j) / j for p, j in zip(pe, je))
           for pe, je in zip(curves["port"], curves["jax"])]
    print(f"largest relative gap between the curves: {max(gap):.3e} (epoch "
          f"{int(np.argmax(gap)) + 1}); first epoch {gap[0]:.3e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"epochs": args.epochs, "against": args.against, "curves": curves,
                       "gap": gap}, f)


if __name__ == "__main__":
    main()
