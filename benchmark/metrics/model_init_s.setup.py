"""``model_init_s.setup`` (s, layer models): ``Solver.setup_s["model"]``,
the program's host seconds building the model and moving it to the device
in ``Solver.__init__``."""


def read(run):
    setup = getattr(run.program, "setup_s", None)
    if not isinstance(setup, dict) or "model" not in setup:
        return None
    return setup["model"]
