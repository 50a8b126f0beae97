"""Does an exported program serve an image the same at every batch size on the card?

    python tests/torch_port_export_batches.py

Exports SSD300-VGG16 (default config, seeded weights) with a symbolic batch,
in bf16 and in float32, and serves 32 random images: at batch 32 twice, as
16 + 16 and as 4 x 8, with ``torch.backends.cudnn.deterministic`` off and
on; prints, for each, the largest difference of the rows and how many rows
and images differ, and the model's raw ``loc`` / ``conf`` at batch 32
against batch 16. Needs a CUDA device; imports no JAX; not a test.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssds_tpu_torch.config import default_config  # noqa: E402
from ssds_tpu_torch.detector import ObjectDetector  # noqa: E402
from ssds_tpu_torch.export import export_detector, load_exported  # noqa: E402
from ssds_tpu_torch.ops.cuda import _build  # noqa: E402
from ssds_tpu_torch.tools import card_line  # noqa: E402


def diff(a, b):
    d = (a - b).abs()
    rows = d.amax(-1) > 0
    return (f"max |d| {d.max().item():.3e}, differing rows {int(rows.sum())} of {rows.numel()}, "
            f"images {int(rows.flatten(1).any(1).sum())}")


def main():
    _build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(card_line(), flush=True)
    imgs = np.random.default_rng(0).integers(0, 256, (32, 300, 300, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs).to(dev)
    for half in (True, False):
        cfg = default_config()
        cfg.MODEL.HALF_PRECISION = half
        det = ObjectDetector(cfg, device=dev, seed=0)
        with tempfile.TemporaryDirectory() as tmp:
            single, _ = load_exported(export_detector(det, tmp))
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                whole = single(x)
                halves = torch.cat([single(x[:16]), single(x[16:])])
                eighths = torch.cat([single(x[i:i + 8]) for i in range(0, 32, 8)])
                print(f"bf16={half} deterministic={deterministic}: batch 32 twice: "
                      f"{diff(whole, single(x))}; 32 vs 16+16: {diff(whole, halves)}; "
                      f"32 vs 4x8: {diff(whole, eighths)}", flush=True)
                with torch.no_grad():
                    loc32, conf32 = det.forward(x)
                    loc16, conf16 = det.forward(x[:16])
                print(f"   forward loc 32 vs 16: max {(loc32[:16] - loc16).abs().max().item():.3e}, "
                      f"conf {(conf32[:16].float() - conf16.float()).abs().max().item():.3e}",
                      flush=True)
        torch.backends.cudnn.deterministic = False


if __name__ == "__main__":
    main()
