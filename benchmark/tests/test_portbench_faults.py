"""A run with its timed path broken underneath comes out not correct, and
the control separates from the program; the harness's look for a card is
skipped (CPU, tiny)."""

from __future__ import annotations

import pytest
import torch

from benchmark import controls, harness
from benchmark.tests.conftest import SEED, tiny_cell

TRAIN = ["ssd300_vgg16_voc.train_b32", "yolo_v3_darknet53_coco.train_b64"]


def _separates(control: dict, program: dict, limits: dict) -> bool:
    """The control reads three times the sound program or more on one of
    the numbers the cell compares (at this size the cell's own limits,
    set at its size on the card, do not apply; a training control has no
    window, so its window numbers are not among them)."""
    return any(control[k] >= 3 * program[k] for k in limits if k in control)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    result = harness.run_cell(tiny_cell(name, half_precision=False), SEED, 0.2, False, "cpu")
    assert result["correct"] is False


def _in_the_window(monkeypatch, fault):
    """``fault(solver)`` applied for the timed window's ``train_epoch`` only."""
    from benchmark import train
    from ssds_tpu_torch.solver import Solver

    sound = Solver.train_epoch

    def train_epoch(self, loader, writer=None):
        if isinstance(loader, train.TimedLoader):
            with fault(self):
                return sound(self, loader, writer)
        return sound(self, loader, writer)

    monkeypatch.setattr(Solver, "train_epoch", train_epoch)


@pytest.mark.parametrize("name", TRAIN)
def test_a_window_whose_steps_leave_the_state_unchanged_is_not_correct(name, monkeypatch):
    import contextlib

    @contextlib.contextmanager
    def unchanged(solver):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
            solver._train_step = solver.make_train_step()
            yield

    _in_the_window(monkeypatch, unchanged)
    result = harness.run_cell(tiny_cell(name, half_precision=False), SEED, 0.2, False, "cpu")
    assert result["check"]["window_unmoved"]["value"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_a_window_with_a_nan_loss_is_not_correct(name, monkeypatch):
    import contextlib

    @contextlib.contextmanager
    def nan_loss(solver):
        step = solver._train_step
        solver._train_step = lambda batch, i: {k: v * float("nan") for k, v in
                                               step(batch, i).items()}
        yield
        solver._train_step = step

    _in_the_window(monkeypatch, nan_loss)
    result = harness.run_cell(tiny_cell(name, half_precision=False), SEED, 0.2, False, "cpu")
    assert result["check"]["window_nonfinite"]["value"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out_is_not_correct(name, monkeypatch):
    from ssds_tpu_torch.solver import Solver

    upload = Solver._upload

    def half(self, batch, keys=("images", "boxes", "labels", "valid")):
        return upload(self, {k: v[: len(v) // 2] for k, v in batch.items()}, keys)

    monkeypatch.setattr(Solver, "_upload", half)
    result = harness.run_cell(tiny_cell(name, half_precision=False), SEED, 0.2, False, "cpu")
    assert result["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_training_control_fp8_separates_from_the_program(name):
    cell = tiny_cell(name)
    program = harness.run_cell_numbers(cell, SEED, 0.2, False, "cpu")[1]
    control = controls.train_reference(tiny_cell(name), SEED, "cpu", precision="fp8")
    assert _separates(control, program, cell["limits"]), (control, program)
