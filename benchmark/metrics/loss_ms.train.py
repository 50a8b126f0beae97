"""``loss_ms.train`` (ms, layer losses): the device time of
``solver.detection_loss``'s forward (matching and MultiBox with hard
negatives, or the YOLO loss) on the train-mode outputs of one batch of the
cell, 20 calls queued behind a sleep."""

import torch

from benchmark.peaks import queued_ms

ITERS = 20


def read(run):
    solver = run.program
    if run.traffic["kind"] != "train" or solver is None:
        return None
    from ssds_tpu_torch.solver import detection_loss, forward_raw

    dev = solver._upload(run.kept["batches"][0])
    with torch.no_grad():
        out = forward_raw(solver.model, dev["images"], solver.means, solver.compute_dtype)
        return queued_ms(lambda: detection_loss(solver.model, solver.priors, out, dev), ITERS)
