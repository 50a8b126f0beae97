"""``solver_idle_ms.train`` (ms, layer solver): the device's idle time a step
while the host's innermost program span was the loop's own (``solver.epoch``,
``solver.step``, ``solver.upload`` or ``solver.host_read``) and not a stage
of the train step, over the traced steps of :mod:`benchmark.spans`."""

from benchmark.spans import table

LOOP_SPANS = ("solver.epoch", "solver.step", "solver.upload", "solver.host_read")


def read(run):
    tab = table(run)
    if tab is None:
        return None
    return sum(tab["spans"][n]["idle_ms"] for n in LOOP_SPANS if n in tab["spans"])
