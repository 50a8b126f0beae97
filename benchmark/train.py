"""The training runner: ``Solver.train_epoch`` over the cell's batches.

Traffic parameters (``"kind": "train"``): ``batch`` images a step, a
``pool`` of distinct batches cycled in order, ``objects`` ``[lo, hi]`` an
image and ``box_sides`` ``[lo, hi]`` (a box's side over the image's),
``steps_per_epoch`` (the dataset's images over the batch, which sets the
learning-rate schedule's epochs) and ``first_step`` (where in the schedule
the run starts), ``check_steps`` (the first steps, which the reference
follows), ``warmup_steps`` after them, ``trace_steps`` in the traced window
(enough for the window's cadence of a host read every 10 steps).

Set-up builds one ``Solver`` with the seeded weights, and drives it through
its first ``check_steps`` steps with ``train_epoch`` itself, one batch a
call, recording each step's losses, the first step's SGD momentum buffer a
leaf, and every leaf's change after the last; then the warm-up steps. The
window is one ``train_epoch`` over a loader that hands out the pool's
batches until ``--seconds`` have passed; it ends with the epoch's loss read
on the host, so the window holds all its work. ``train_img_s`` is the
images of every step over the window's length. The window's own steps are
judged by their end state: the epoch's mean losses and every leaf finite,
and every leaf that the first steps moved moved again in the window.
"""

from __future__ import annotations

import tempfile
import time

import torch
from torch.profiler import record_function

from benchmark import devtrace, inputs, judge
from benchmark.harness import BenchError, Run, port_config
from benchmark.reference.layers import float32_exact
from benchmark.reference.optim import train_steps

BUFFER_ROLES = ("bn_mean", "bn_var", "bn_count")  # state that takes no gradient


class TimedLoader:
    """The pool's batches in turn, from ``start``, until ``seconds`` have
    passed since the first was handed out; ``count`` says how many were."""

    def __init__(self, batches, start: int, seconds: float):
        self.batches, self.start, self.seconds = batches, start, seconds
        self.count = 0

    def __len__(self) -> int:  # the epoch's progress line only
        return 0

    def __iter__(self):
        begin = time.perf_counter()
        while self.count == 0 or time.perf_counter() - begin < self.seconds:
            yield self.batches[(self.start + self.count) % len(self.batches)]
            self.count += 1


def norms(named) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().float())) for k, v in named}


def measure(run: Run) -> None:
    from ssds_tpu_torch.solver import Solver

    t = run.traffic
    batch = int(t["batch"])
    if int(t["pool"]) < int(t["check_steps"]):
        raise BenchError(f"{run.name}: the check's steps need {t['check_steps']} distinct batches")
    cfg = port_config(run.tree)
    cfg.TRAIN.BATCH_SIZE = batch
    exp = run.extra["exp"] = tempfile.TemporaryDirectory(prefix="portbench-")
    cfg.EXP_DIR, cfg.LOG_DIR = exp.name, exp.name
    solver = run.program = Solver(cfg, device=str(run.device), seed=0)
    start = inputs.weights(run.ref, run.tree, run.seed, run.device)
    solver.model.load_state_dict(start)
    run.kept["weights"] = {k: v.cpu() for k, v in start.items()}
    solver.build_state(int(t["steps_per_epoch"]))
    solver.step = int(t["first_step"])
    solver._train_step = solver.make_train_step()

    imgs = inputs.images(int(t["pool"]) * batch, run.tree["MODEL"]["IMAGE_SIZE"], run.seed,
                         run.device)
    real_classes = int(run.tree["MODEL"]["NUM_CLASSES"]) - 1
    batches = run.kept["batches"] = inputs.train_batches(
        imgs, batch, t["objects"], t["box_sides"], real_classes,
        int(run.tree["DATASET"]["MAX_GT"]), run.seed)

    # the check's first steps, through the window's own call
    model, opt = solver.model, solver.optimizer
    named = list(model.named_parameters())
    prog = {"losses": []}
    for k in range(int(t["check_steps"])):
        m = solver.train_epoch([batches[k]])
        prog["losses"].append((m["loss_l"], m["loss_c"]))
        if k == 0:
            # a step that never reached the optimizer leaves no buffer: a norm of 0
            prog["buf1"] = norms((n, opt.state[p].get("momentum_buffer", torch.zeros(())))
                                 for n, p in named)
    state = model.state_dict()
    prog["change"] = norms((k, state[k].float() - start[k].float()) for k in start
                           if not k.endswith("num_batches_tracked"))
    run.kept["prog"] = prog
    moved = [k for k in start
             if start[k].is_floating_point() and not torch.equal(state[k], start[k])]
    del start, state
    for k in range(int(t["warmup_steps"])):
        solver.train_epoch([batches[(int(t["check_steps"]) + k) % len(batches)]])
    run.synchronize()

    before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()
              if v.is_floating_point()}

    first = (int(t["check_steps"]) + int(t["warmup_steps"])) % len(batches)
    loader = TimedLoader(batches, first, run.seconds)
    begin = time.perf_counter()
    run.window["setup_s"] = begin - run.t_process
    m = solver.train_epoch(loader)
    end = time.perf_counter()
    run.read_memory_peak()
    after = model.state_dict()
    run.kept["window"] = {
        "losses": m,
        "nonfinite": [k for k in before if not bool(torch.isfinite(after[k]).all())],
        "unmoved": [k for k in moved if torch.equal(after[k].detach().cpu(), before[k])]}
    del before, after
    run.window.update(train_img_s=loader.count * batch / (end - begin), steps=loader.count,
                      window_s=end - begin)
    print(f"{run.name}: {loader.count} steps in {end - begin:.3f} s", flush=True)

    if run.trace:
        n = int(t["trace_steps"])
        def window():
            with record_function("Solver.train_epoch"):
                solver.train_epoch([batches[k % len(batches)] for k in range(n)])

        run.traced = devtrace.profile(window, run.out_path("trace.json"))


def check(run: Run):
    """The first steps again in the reference, from the same weights, in
    float32; and the window's end state."""
    t = run.traffic
    spec = run.ref.param_spec(run.tree)
    start = {k: v.to(run.device) for k, v in run.kept.pop("weights").items()}
    buffers = {k: v for k, v in start.items() if spec[k][1] in BUFFER_ROLES}
    params = {k: v for k, v in start.items() if k not in buffers}
    device_batches = [{k: torch.from_numpy(b[k]).to(run.device)
                       for k in ("images", "boxes", "labels", "valid")}
                      for b in run.kept["batches"][:int(t["check_steps"])]]
    with float32_exact():
        ref = train_steps(run.ref, run.tree, params, buffers, device_batches,
                          int(t["first_step"]), int(t["steps_per_epoch"]))
    run.kept["ref"] = ref
    print(f"{run.name}: leaves left out of the change (first gradient under "
          f"{judge.EXCLUDE_BELOW} of the median leaf's): {judge.excluded_leaves(ref)}", flush=True)
    return {**judge.train_numbers(run.kept["prog"], ref),
            **judge.window_numbers(run.kept["window"])}, run.window["steps"]
