"""Train CLI: ``python -m ssds_tpu_torch.train --cfg <yml> [--device cuda]``.

The port's counterpart of the repository's ``train.py`` (reference
``python train.py --cfg <yml>``): the config file merged over the defaults,
then :func:`ssds_tpu_torch.solver.train_model` on ``--device`` (default the
GPU; ``cpu`` for a run without one).

Under ``python -m torch.distributed.run --nproc_per_node N -m
ssds_tpu_torch.train --cfg <yml>`` each rank joins the process group
(NCCL on the cards, gloo with ``--device cpu``) and trains its share of the
global batch (:mod:`ssds_tpu_torch.parallel.sharding`), or, under
``TPU.MESH.SPATIAL``, its band of rows of its data group's images
(:mod:`ssds_tpu_torch.parallel.spatial`); no flag is needed.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train an ssds_tpu_torch detection network")
    parser.add_argument("--cfg", dest="config_file", required=True, type=str,
                        help="YAML config file")
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def train(argv=None):
    args = parse_args(argv)
    from ssds_tpu_torch.config import cfg_from_file
    from ssds_tpu_torch.parallel import sharding
    from ssds_tpu_torch.solver import train_model

    sharding.initialize_distributed(device=args.device)
    try:
        train_model(cfg_from_file(args.config_file), device=args.device)
    finally:
        sharding.destroy_distributed()


if __name__ == "__main__":
    train()
