"""``forward_ms.train`` (ms, layer models): the device busy time a step of
the operations launched inside the program's ``step.forward`` span (the
union of their intervals), over the traced steps of :mod:`benchmark.spans`."""

from benchmark.spans import stage_busy_ms


def read(run):
    return stage_busy_ms(run, "step.forward")
