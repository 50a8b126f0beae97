"""``ssds_tpu_torch.utils.profiler`` and ``utils.timer`` (counterparts of
``ssds_tpu.utils.profiler`` / ``timer``), on the CPU.

Held: ``trace`` writes a Chrome trace that holds an ``annotate`` span around
a port train step, and the step's operators; ``annotate`` is one shared
no-op with no profiler running; ``Solver.train_epoch`` under ``trace`` puts
its spans in the Chrome trace, each step's stages inside its ``solver.step``
span and in order, one span for each step taken and each loss read;
``Solver.setup_s`` holds the model's build and the first step's seconds;
``timed`` adds each block's seconds to one key; ``Timer`` keeps the JAX package's ``Timer``'s count,
total, average and ``clear``; without the ``tensorboard`` package the
Solver's writer is ``utils.summary.JsonLinesWriter``, one JSON line a scalar,
image or histogram.
"""

import json
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from ssds_tpu.utils.timer import Timer as JaxTimer
from ssds_tpu_torch.config import default_config
from ssds_tpu_torch.solver import Solver
from ssds_tpu_torch.utils import Timer, profiler
from ssds_tpu_torch.utils.timer import Timer as TimerModule
from test_torch_port_mobilenet import one_torch_thread  # noqa: F401


def test_trace_holds_the_annotated_span(tmp_path):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU())
    x = torch.randn(2, 3, 16, 16)
    with profiler.trace(str(tmp_path), name="steps") as prof:
        for _ in range(2):
            with profiler.annotate("train_step"):
                model(x).sum().backward()
    assert prof.trace_path == str(tmp_path / "steps.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert names.count("train_step") == 2
    assert any("conv" in n for n in names)
    assert "train_step" in {e.key for e in prof.key_averages()}


STAGES = ["solver.upload", "step.forward", "step.loss", "step.backward", "step.optimizer"]
EPOCH_STEPS = 11  # loss reads after steps 1 and 10, and the epoch's at the end


def _tiny_solver(tmp_path):
    cfg = default_config()
    cfg.MODEL.update(IMAGE_SIZE=[64, 64], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                     ASPECT_RATIOS=[[2], [2, 3], [2, 3]])
    cfg.EXP_DIR, cfg.LOG_DIR = str(tmp_path / "exp"), str(tmp_path / "logs")
    cfg.TRAIN.BATCH_SIZE = 2
    return Solver(cfg, device="cpu")


@pytest.fixture(scope="module")
def traced_epoch(tmp_path_factory):
    """A Solver after one ``train_epoch`` of 11 batches at 64 px under
    ``profiler.trace``, and the trace's program spans (``solver.*``,
    ``step.*``) in order of start."""
    tmp = tmp_path_factory.mktemp("epoch")
    solver = _tiny_solver(tmp)
    solver.build_state(EPOCH_STEPS)
    solver._train_step = solver.make_train_step()
    rng = np.random.default_rng(0)
    batches = [{"images": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                "boxes": np.array([[[0.1, 0.1, 0.5, 0.6]], [[0.3, 0.2, 0.9, 0.7]]], np.float32),
                "labels": np.array([[1], [2]], np.int32), "valid": np.ones((2, 1), bool)}
               for _ in range(EPOCH_STEPS)]
    with profiler.trace(str(tmp), name="epoch") as prof:
        solver.train_epoch(batches)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(("solver.", "step."))), key=lambda e: e["ts"])
    return solver, spans


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_train_epoch_spans_nest_by_step(traced_epoch):
    _, spans = traced_epoch
    assert len({(e["pid"], e["tid"]) for e in spans}) == 1  # all on the loop's thread
    epochs = [e for e in spans if e["name"] == "solver.epoch"]
    steps = [e for e in spans if e["name"] == "solver.step"]
    assert len(epochs) == 1 and len(steps) == EPOCH_STEPS
    assert all(_inside(e, epochs[0]) for e in spans)
    reads = []
    for k, step in enumerate(steps, 1):
        held = [e["name"] for e in spans if e is not step and _inside(e, step)]
        assert [n for n in held if n != "solver.host_read"] == STAGES, k
        if "solver.host_read" in held:
            assert held[-1] == "solver.host_read"
            reads.append(k)
    assert reads == [1, 10]
    outside = [e for e in spans if e["name"] == "solver.host_read"
               and not any(_inside(e, s) for s in steps)]
    assert len(outside) == 1 and outside[0]["ts"] >= steps[-1]["ts"] + steps[-1]["dur"]


def test_trace_counts_steps_and_loss_reads(traced_epoch):
    solver, spans = traced_epoch
    names = [e["name"] for e in spans]
    assert solver.step == names.count("solver.step") == EPOCH_STEPS
    assert names.count("solver.host_read") == 3


def test_solver_setup_seconds(traced_epoch):
    solver, _ = traced_epoch
    assert set(solver.setup_s) == {"model", "first_step"}
    assert all(v > 0 for v in solver.setup_s.values())


def test_annotate_is_a_shared_no_op_without_a_profiler(tmp_path):
    assert profiler.annotate("a") is profiler.annotate("b")
    with profiler.trace(str(tmp_path)):
        a, b = profiler.annotate("a"), profiler.annotate("b")
        assert a is not b and isinstance(a, torch.profiler.record_function)
    assert profiler.annotate("a") is profiler.annotate("b")


def test_timed_accumulates():
    results = {}
    for _ in range(3):
        with profiler.timed("block", results):
            time.sleep(0.01)
    with profiler.timed("other", results):
        pass
    assert set(results) == {"block", "other"}
    assert 0.03 <= results["block"] < 1.0 and results["other"] < results["block"]


def test_timer_behaves_as_the_jax_timer():
    assert Timer is TimerModule
    ours, theirs = Timer(), JaxTimer()
    for t in (ours, theirs):
        for _ in range(3):
            t.tic()
            time.sleep(0.002)
            last = t.toc(average=False)
            assert last >= 0.002
        avg = t.toc()  # a fourth interval, from the same tic
        assert t.calls == 4 and avg == pytest.approx(t.total_time / 4)
        assert t.diff >= last and t.average_time == avg
        t.clear()
        assert (t.calls, t.total_time, t.average_time, t.diff) == (0, 0.0, 0.0, 0.0)
    assert vars(ours).keys() == vars(theirs).keys()


def test_solver_writer_without_tensorboard(tmp_path):
    cfg = default_config()
    cfg.MODEL.update(IMAGE_SIZE=[64, 64], FEATURE_LAYER=[[22, 34, "S"], [512, 1024, 512]],
                     ASPECT_RATIOS=[[2], [2, 3], [2, 3]])
    cfg.EXP_DIR, cfg.LOG_DIR = str(tmp_path / "exp"), str(tmp_path / "logs")
    solver = Solver(cfg, device="cpu")
    with mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}):
        writer = solver._get_writer()
    writer.add_scalar("loss_loc", np.float32(1.5), 3)
    writer.add_image("priors/level0", np.arange(12, dtype=np.uint8).reshape(1, 3, 4), 3)
    writer.add_histogram("grads/base/0/weight", np.array([-1.0, 2.0]), 3)
    solver.close()
    with open(tmp_path / "logs" / "summary.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == [
        {"kind": "scalar", "tag": "loss_loc", "step": 3, "value": 1.5},
        {"kind": "image", "tag": "priors/level0", "step": 3, "shape": [1, 3, 4], "min": 0.0,
         "mean": 5.5, "max": 11.0},
        {"kind": "histogram", "tag": "grads/base/0/weight", "step": 3, "shape": [2],
         "min": -1.0, "mean": 0.5, "max": 2.0}]
