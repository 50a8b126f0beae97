"""``ssds_tpu_torch.utils.profiler`` and ``utils.timer`` (counterparts of
``ssds_tpu.utils.profiler`` / ``timer``), on the CPU.

Held: ``trace`` writes a Chrome trace that holds an ``annotate`` span around
a port train step, and the step's operators; ``timed`` adds each block's
seconds to one key; ``Timer`` keeps the JAX package's ``Timer``'s count,
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
