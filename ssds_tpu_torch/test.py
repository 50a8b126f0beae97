"""Eval CLI: ``python -m ssds_tpu_torch.test --cfg <yml> [--device cuda]``.

The port's counterpart of the repository's ``test.py`` (reference
``python test.py --cfg <yml>``): the newest checkpoint in ``EXP_DIR`` (or
``RESUME_CHECKPOINT``) evaluated over ``TEST_SETS``, mAP printed, on
``--device`` (default the GPU; ``cpu`` for a run without one).
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
    from ssds_tpu_torch.solver import test_model

    test_model(cfg_from_file(args.config_file), device=args.device)


if __name__ == "__main__":
    test()
