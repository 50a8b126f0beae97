"""Eval CLI: ``python -m ssds_tpu_torch.test --cfg <yml> [--device cuda]``.

The port's counterpart of the repository's ``test.py`` (reference
``python test.py --cfg <yml>``): the newest checkpoint in ``EXP_DIR`` (or
``RESUME_CHECKPOINT``) evaluated over ``TEST_SETS``, mAP printed, on
``--device`` (default the GPU; ``cpu`` for a run without one).

Under ``python -m torch.distributed.run --nproc_per_node N -m
ssds_tpu_torch.test --cfg <yml>`` each rank joins the process group (NCCL
on the cards, gloo with ``--device cpu``), forwards its share of the test
images and prints the merged mAP (:mod:`ssds_tpu_torch.parallel.sharding`);
no flag is needed.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate an ssds_tpu_torch detection network")
    parser.add_argument("--cfg", dest="config_file", required=True, type=str,
                        help="YAML config file")
    parser.add_argument("--device", default="cuda", type=str, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def test(argv=None):
    args = parse_args(argv)
    from ssds_tpu_torch.config import cfg_from_file
    from ssds_tpu_torch.parallel import sharding
    from ssds_tpu_torch.solver import test_model

    sharding.initialize_distributed(device=args.device)
    try:
        test_model(cfg_from_file(args.config_file), device=args.device)
    finally:
        sharding.destroy_distributed()


if __name__ == "__main__":
    test()
