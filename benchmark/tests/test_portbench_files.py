"""BENCHMARK.json and the files it names: found by name, and within the format's limits."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(str(e[key])), (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")


def test_configs_are_files_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_yml_as_the_program_writes_it(name):
    """The file's tree is ``config.YML_MAKERS[maker]()``: the yml at full
    width and depth, nothing cut."""
    from ssds_tpu_torch.config import YML_MAKERS

    data = json.load(open(os.path.join(harness.BENCH_DIR, "configs", f"{name}.json")))
    made = json.loads(json.dumps(YML_MAKERS[data["maker"]]()))
    assert data["cfg"] == made


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name)
    assert cell["chips"] == 1
    assert cell["traffic_file"]["kind"] == "train"
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in reported
        assert hasattr(harness.load_metric(m["name"]), "read")


def test_metrics_name_their_layer_and_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    bound = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bound["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bound.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "metrics", f"{m['name']}.py"))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")


def test_a_missing_file_is_named():
    with pytest.raises(harness.BenchError, match="no workload"):
        harness.load_cell("no_such.cell")
    with pytest.raises(harness.BenchError, match="no reader"):
        harness.load_metric("no_such_metric")
