"""BENCHMARK.json keeps to the contract, and every cell, configuration,
traffic mix, scene, check, reference and metric it names resolves to a
file of its own."""

import importlib
import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_metric_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_from_files(cell):
    c = spec.load_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert NAME.match(cell) and w["chips"] == 1 and len(w["why"]) <= 200
    assert c.config["name"] == w["config"] and c.config["reduced"] == []
    assert callable(c.entry().load) and callable(c.reference().run) and callable(c.scene().make)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "audio_s_per_s", "call_ms_p95"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert c.checks["calls"] >= 1 and c.checks["limits"]
    for kernel, count in c.config["kernels"].items():
        assert callable(importlib.import_module(f"portbench.roofline.{count}").work)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_entries(conf):
    assert conf["file"].startswith("portbench/configs/") and conf["reduced"] == []
    cfg = spec.read_json(spec.ROOT / conf["file"])
    assert cfg["name"] == conf["name"] and cfg["assumed"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
