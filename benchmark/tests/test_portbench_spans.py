"""The program's spans in a traced window (:mod:`benchmark.spans`) and the
readers of the per-layer metrics that read them, on the CPU."""

from __future__ import annotations

import json
import math
import os
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.tests.conftest import ROOT, SEED, tiny_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SPAN_READERS = ["forward_ms.train", "backward_ms.train", "step_loss_ms.train",
                "optimizer_ms.train", "solver_idle_ms.train", "launches_per_step.train"]
SETUP_READERS = ["model_init_s.setup", "first_step_s.setup"]
MAIN, AUTOGRAD = 1, 2  # the loop's thread, the autograd engine's


def _event(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _step_events():
    """One step in a window of 1000 µs: nested program spans, an optimizer
    annotation, a program-named span on another thread, launches on two
    threads with their correlation ids, the device operations they start,
    one with no launch on record, one before the window."""
    span = lambda name, ts, dur, tid=MAIN: _event("user_annotation", name, ts, dur, tid)
    launch = lambda ts, corr, tid=MAIN, cat="cuda_runtime": _event(cat, "cudaLaunchKernel", ts, 2,
                                                                    tid, corr)
    return [
        span(spans.WINDOW, 0, 1000),
        span("solver.epoch", 10, 980),
        span("solver.step", 20, 480),
        span("solver.upload", 25, 35),
        span("step.forward", 60, 140),
        span("step.loss", 200, 50),
        span("step.backward", 250, 150),
        span("step.optimizer", 400, 50),
        span("Optimizer.step#SGD.step", 405, 40),   # not a program span
        span("solver.host_read", 450, 50),
        span("solver.host_read", 900, 80),           # the epoch's read, after the step
        span("step.forward", 600, 100, AUTOGRAD),    # not on the loop's thread
        _event("cpu_op", "aten::add", 100, 5),
        launch(5, 8), launch(30, 1), launch(100, 2), launch(210, 3),
        launch(300, 4, AUTOGRAD), launch(310, 5, AUTOGRAD, "cuda_driver"),
        launch(410, 6), launch(460, 7),
        _event("kernel", "early", 8, 4, 30, 8),                 # unattributed: before the epoch
        _event("gpu_memcpy", "Memcpy HtoD", 40, 30, 30, 1),     # solver.upload
        _event("kernel", "conv", 110, 60, 30, 2),               # step.forward
        _event("kernel", "loss", 220, 20, 30, 3),               # step.loss
        _event("kernel", "dgrad", 300, 80, 30, 4),              # step.backward (autograd thread)
        _event("kernel", "wgrad", 380, 40, 30, 5),              # step.backward
        _event("kernel", "sgd", 420, 20, 30, 6),                # step.optimizer
        _event("gpu_memcpy", "Memcpy DtoH", 470, 10, 30, 7),    # solver.host_read
        _event("kernel", "orphan", 600, 50, 30, 99),            # no launch on record
        _event("kernel", "before", -100, 50, 30, 98),           # before the window
    ]


def test_attribution_on_a_hand_built_trace():
    tab = spans.attribute(_step_events())
    rows = tab["spans"]
    assert tab["steps"] == 1 and set(rows) == {
        "solver.epoch", "solver.step", "solver.upload", "step.forward", "step.loss",
        "step.backward", "step.optimizer", "solver.host_read", spans.UNATTRIBUTED}
    us = lambda name, field: rows[name][field] * 1e3
    busy = {"solver.upload": 30, "step.forward": 60, "step.loss": 20, "step.backward": 120,
            "step.optimizer": 20, "solver.host_read": 10, spans.UNATTRIBUTED: 54,
            "solver.epoch": 0, "solver.step": 0}
    launches = {"solver.upload": 1, "step.forward": 1, "step.loss": 1, "step.backward": 2,
                "step.optimizer": 1, "solver.host_read": 1, spans.UNATTRIBUTED: 2,
                "solver.epoch": 0, "solver.step": 0}
    # gaps: 0-8 before the epoch, 12-40 upload, 70-110 and 170-220 forward,
    # 240-300 backward, 440-470 the read, 480-600 and 650-1000 the epoch
    idle = {spans.UNATTRIBUTED: 8, "solver.upload": 28, "step.forward": 90, "step.backward": 60,
            "solver.host_read": 30, "solver.epoch": 470, "solver.step": 0, "step.loss": 0,
            "step.optimizer": 0}
    host = {"solver.epoch": 980, "solver.step": 480, "solver.upload": 35, "step.forward": 140,
            "step.loss": 50, "step.backward": 150, "step.optimizer": 50, "solver.host_read": 130}
    self_ = {"solver.epoch": 420, "solver.step": 5, **{k: host[k] for k in host
                                                       if k not in ("solver.epoch", "solver.step")}}
    for name in rows:
        assert us(name, "busy_ms") == pytest.approx(busy[name]), name
        assert rows[name]["launches"] == launches[name], name
        assert us(name, "idle_ms") == pytest.approx(idle[name]), name
        assert us(name, "host_ms") == pytest.approx(host.get(name, 0)), name
        assert us(name, "self_ms") == pytest.approx(self_.get(name, 0)), name
    assert tab["window_ms"] * 1e3 == pytest.approx(1000)
    assert tab["busy_ms"] * 1e3 == pytest.approx(314) == sum(busy.values())
    assert tab["idle_ms"] * 1e3 == pytest.approx(686) == sum(idle.values())
    assert tab["launches"] == 9 == sum(launches.values())


def test_a_window_without_program_spans_gives_none():
    events = [e for e in _step_events() if not e["name"].startswith(spans.PREFIXES)]
    assert spans.attribute(events) is None
    with pytest.raises(RuntimeError, match="no 'portbench.spans' span"):
        spans.attribute(events[1:])


def test_innermost_span_and_self_time():
    owner = spans.Innermost([_event("user_annotation", "a", 0, 100),
                             _event("user_annotation", "b", 10, 20),
                             _event("user_annotation", "c", 30, 70)])  # ends with a
    assert [owner.at(t) for t in (-1, 5, 10, 29, 30, 99, 100)] == [None, "a", "b", "b", "c", "c",
                                                                   None]
    assert owner.self_us() == pytest.approx({"a": 10, "b": 20, "c": 70})


def _readers(names):
    return {n: harness.load_metric(n) for n in names}


def test_readers_read_the_cached_table():
    tab = spans.attribute(_step_events())
    run = SimpleNamespace(extra={"spans": tab}, program=SimpleNamespace(
        setup_s={"model": 1.5, "first_step": 2.5}))
    got = {n: r.read(run) for n, r in _readers(SPAN_READERS + SETUP_READERS).items()}
    assert got == pytest.approx({
        "forward_ms.train": 0.06, "backward_ms.train": 0.12, "step_loss_ms.train": 0.02,
        "optimizer_ms.train": 0.02, "solver_idle_ms.train": 0.47 + 0.028 + 0.03,
        "launches_per_step.train": 9, "model_init_s.setup": 1.5, "first_step_s.setup": 2.5})


class _Unspanned:
    """An older program: it takes its steps but opens no span and keeps no
    set-up seconds."""

    step = 0

    def train_epoch(self, loader):
        for _ in loader:
            self.step += 1


@pytest.mark.parametrize("program", [None, _Unspanned()], ids=["no_program", "no_spans"])
def test_readers_give_none_without_a_traced_program(program, tmp_path):
    run = SimpleNamespace(traffic={"kind": "train", "trace_steps": 2}, program=program, extra={},
                          kept={"batches": [{}]}, device=SimpleNamespace(type="cpu"),
                          synchronize=lambda: None, out_path=lambda name: str(tmp_path / name))
    for name, reader in _readers(SPAN_READERS + SETUP_READERS).items():
        assert reader.read(run) is None, name
    assert os.listdir(tmp_path) == []  # the trace read and deleted, no table written


def test_new_metrics_follow_the_existing_ones():
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[:4] == ["device_idle.train", "step_mfu.train", "upload_ms.train",
                         "loss_ms.train"]
    assert names[4:] == SPAN_READERS[:5] + ["launches_per_step.train"] + SETUP_READERS


def test_the_program_spans_on_the_cpu():
    """The tiny cell's Solver traced on the CPU: its steps taken and
    spanned alike, every stage of the step in the table, no device
    operation, the readers' numbers finite."""
    from benchmark import train

    cell = tiny_cell("ssd300_vgg16_voc.train_b32")
    cell["traffic_file"]["trace_steps"] = 3
    run = harness.Run(cell, SEED, 0.1, False, "cpu", 0.0)
    train.measure(run)
    tab = spans.table(run)
    assert tab["steps"] == 3 and tab["launches"] == 0 and tab["busy_ms"] == 0
    assert tab["host_reads"] == pytest.approx(2 / 3)  # after step 1 and at the end
    rows = tab["spans"]
    assert {"solver.epoch", "solver.step", "solver.upload", "solver.host_read", "step.forward",
            "step.loss", "step.backward", "step.optimizer"} <= set(rows)
    assert all(rows[n]["host_ms"] > 0 for n in rows if n != spans.UNATTRIBUTED)
    assert spans.table(run) is tab  # traced once
    assert os.path.isfile(run.out_path("spans.json"))
    assert not os.path.exists(run.out_path("spans_trace.json"))
    got = {n: r.read(run) for n, r in _readers(SPAN_READERS + SETUP_READERS).items()}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    assert got["model_init_s.setup"] > 0 and got["first_step_s.setup"] > 0
    os.remove(run.out_path("spans.json"))
    run.free_program()
