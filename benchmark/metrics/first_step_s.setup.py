"""``first_step_s.setup`` (s, layer solver): ``Solver.setup_s["first_step"]``,
the program's host seconds of its first ``train_epoch`` loop iteration,
which ends in a loss read: the lazy library loads and kernel selection."""


def read(run):
    setup = getattr(run.program, "setup_s", None)
    if not isinstance(setup, dict) or "first_step" not in setup:
        return None
    return setup["first_step"]
