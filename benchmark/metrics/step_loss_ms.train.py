"""``step_loss_ms.train`` (ms, layer losses): the device busy time a step of
the operations launched inside the program's ``step.loss`` span (the union
of their intervals), over the traced steps of :mod:`benchmark.spans`: the
loss as it runs in the step (``loss_ms.train`` times it from outside)."""

from benchmark.spans import stage_busy_ms


def read(run):
    return stage_busy_ms(run, "step.loss")
