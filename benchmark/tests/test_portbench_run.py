"""Whole runs at a tiny size on the CPU: the result's keys, the reference
against the program, the import guard; and one run on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT, SEED, tiny_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", ["ssd300_vgg16_voc.train_b32", "yolo_v3_darknet53_coco.train_b64"])
def test_result_keys_and_end_to_end_metrics(name):
    result = harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu")
    assert list(result) == RESULT_KEYS  # check comes last
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    wanted = {m["name"] for m in harness.load_cell(name)["end_to_end"]}
    assert set(result["metrics"]) == wanted
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in result["check"].values())


@pytest.mark.parametrize("name", [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_program_in_float32_agrees_with_the_reference(name):
    """With the program in float32 the two sides differ by rounding only;
    every compared number is far under the cell's limit."""
    result = harness.run_cell(tiny_cell(name, half_precision=False), SEED, 0.2, False, "cpu")
    for k, v in result["check"].items():
        assert v["value"] <= v["limit"] / 10, (k, v)


def test_same_seed_same_inputs():
    from benchmark import inputs
    from benchmark.reference import load

    cell = tiny_cell("yolo_v3_darknet53_coco.train_b64")
    ref, tree = load("yolo_v3"), cell["config_file"]["cfg"]
    a, b = inputs.weights(ref, tree, SEED, "cpu"), inputs.weights(ref, tree, SEED, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert (inputs.images(2, (64, 64), SEED, "cpu") == inputs.images(2, (64, 64), SEED, "cpu")).all()
    assert not (inputs.images(2, (64, 64), SEED + 1, "cpu")
                == inputs.images(2, (64, 64), SEED, "cpu")).all()


def _run_python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ssd300_vgg16_voc.train_b32", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "GPU" in out.stderr


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    forbidden = repr(harness.FORBIDDEN)
    run = _run_python(
        "import sys; sys.path.insert(0, '.'); import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness, controls\n"
        "from benchmark.tests.conftest import tiny_cell, SEED\n"
        "harness.run_cell(tiny_cell('ssd300_vgg16_voc.train_b32'), SEED, 0.2, False, 'cpu')\n"
        f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({forbidden})))")
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip().splitlines()[-1] == "[]"
    ref = _run_python(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference, benchmark.reference.ssd_vgg16, benchmark.reference.yolo_v3\n"
        "import benchmark.reference.optim\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'ssds_tpu_torch', 'ssds_tpu', 'jax', 'flax'}))")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert ref.stdout.strip() == "[]"


def test_guard_names_a_forbidden_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "ssds_tpu_torch_x", object())  # a longer name is not jax's
    assert "ssds_tpu" not in harness.forbidden_modules()


@pytest.mark.cuda
def test_one_traced_run_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ssd300_vgg16_voc.train_b32", "--seed", str(SEED), "--seconds", "3",
                          "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and 0 < result["device"]["busy_s"]
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(
        "ssd300_vgg16_voc.train_b32")["per_layer"]}
