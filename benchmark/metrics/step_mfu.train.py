"""``step_mfu.train`` (%, layer models): three times the forward's
operations an image (the backward counted as twice the forward, the first
conv's input gradient included) times the window's images a second, over the
bf16 dense peak."""

from benchmark.peaks import BF16_OPS_S


def read(run):
    if run.traffic["kind"] != "train" or "train_img_s" not in run.window:
        return None
    return 300.0 * run.ref.flops_per_image(run.tree) * run.window["train_img_s"] / BF16_OPS_S
