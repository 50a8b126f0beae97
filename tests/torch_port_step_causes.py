"""The float32 train step, card against CPU (``ssds_tpu_torch.tools.step_parity``),
under changes that each remove one candidate cause of a gap.

    python tests/torch_port_step_causes.py [--model vgg|lite|fssd|rfb|resnet50|ssd512] [--batch N]
        [--variants plain,cpu_ranks,deterministic,both,no_cudnn,cpu_float64]
        [--seed 0] [--out PATH]

- ``plain``: the card's step as it is;
- ``cpu_ranks``: the card's MultiBox loss takes the CPU step's hard-negative
  ranks (``ops.losses.hard_negative_ranks``), so both mine the same
  negatives;
- ``deterministic``: ``torch.backends.cudnn.deterministic`` on (the same
  cuDNN algorithms each call);
- ``both``: the two together;
- ``no_cudnn``: cuDNN off on the card, so its convolutions run PyTorch's own
  CUDA kernels (im2col and cuBLAS GEMMs, TF32 off);
- ``cpu_float64``: no card: the CPU's float32 step against the same step
  with the model in float64 (the loss stays float32), i.e. what float32
  rounding alone does to each measure.

Needs a CUDA device unless the only variant is ``cpu_float64``. Imports no
JAX; not a test.
"""

import argparse
import json
import os
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ssds_tpu_torch.ops import losses  # noqa: E402
from ssds_tpu_torch.tools import card_line, need_cuda, step_parity  # noqa: E402
from ssds_tpu_torch.tools.synth_voc import write_voc  # noqa: E402

VARIANTS = ("plain", "cpu_ranks", "deterministic", "both", "no_cudnn", "cpu_float64")


def ranked_step(cfg, device, batch, seed, ranks=None):
    """:func:`step_parity.step` with the hard-negative ranks it used; ``ranks``
    (one entry a loss call) replaces the step's own."""
    used = []
    plain = losses.hard_negative_ranks

    def record(loss_c):
        r = plain(loss_c) if ranks is None else ranks[len(used)].to(loss_c.device)
        used.append(r.cpu())
        return r

    with mock.patch.object(losses, "hard_negative_ranks", record):
        out = step_parity.step(step_parity.float32_solver(cfg, device, seed), batch)
    return out, used


def float64_step(cfg, batch, seed):
    """The CPU step with the model in float64 (the loss stays float32)."""
    solver = step_parity.float32_solver(cfg, "cpu", seed)
    solver.model.double()
    solver.compute_dtype = torch.float64
    return step_parity.step(solver, batch)


def variant(name, cfg, device, batch, seed):
    if name == "cpu_float64":
        return step_parity.errors(step_parity.step(step_parity.float32_solver(cfg, "cpu", seed),
                                                   batch), float64_step(cfg, batch, seed))
    cpu, ranks = ranked_step(cfg, "cpu", batch, seed)
    with torch.backends.cudnn.flags(enabled=name != "no_cudnn", benchmark=False,
                                    deterministic=name in ("deterministic", "both"),
                                    allow_tf32=False):
        card, _ = ranked_step(cfg, device, batch, seed,
                              ranks if name in ("cpu_ranks", "both") else None)
    return step_parity.errors(card, cpu)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("vgg", "lite", "fssd", "rfb", "resnet50", "ssd512"),
                        default="vgg")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--variants", default="plain,cpu_ranks,deterministic,both")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    variants = args.variants.split(",")
    assert set(variants) <= set(VARIANTS), variants
    if variants == ["cpu_float64"]:
        device, card = "cpu", "no card: the CPU alone"
    else:
        device, card = need_cuda("torch_port_step_causes"), card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "VOCdevkit")
        write_voc(root, args.seed, n_trainval=args.batch, n_test=1)
        cfg = step_parity.config(args.model, root, os.path.join(tmp, "exp"))
        batch = step_parity.synthetic_batch(cfg, args.seed, args.batch)
        for v in variants:
            results[v] = variant(v, cfg, device, batch, args.seed)
            print(f"{args.model} batch {args.batch} [{v}]: {step_parity.describe(results[v])}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "model": args.model, "batch": args.batch,
                       "results": results}, f, indent=1)


if __name__ == "__main__":
    main()
