"""``upload_ms.train`` (ms, layer solver): CUDA events around
``Solver._upload`` of one batch of the cell (pinning and the non-blocking
copies of images and targets), the mean of 10 after 3."""

from benchmark.peaks import events_ms

ITERS = 10


def read(run):
    solver = run.program
    if run.traffic["kind"] != "train" or solver is None:
        return None
    batch = run.kept["batches"][0]
    for _ in range(3):
        solver._upload(batch)
    run.synchronize()
    return events_ms(lambda: solver._upload(batch), ITERS)
