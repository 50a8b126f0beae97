"""``launches_per_step.train`` (launches, layer device): the device
operations (kernels, memcpy, memset) that start in the traced window of
:mod:`benchmark.spans` over the train steps it took (its ``solver.step``
spans, checked equal to the rise of ``Solver.step`` across it)."""

from benchmark.spans import table


def read(run):
    tab = table(run)
    return None if tab is None else tab["launches"]
