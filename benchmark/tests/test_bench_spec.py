"""BENCHMARK.json and the files it names: every cell resolves its config,
traffic, entry, limits and metric readers by name, and the file keeps the
benchmark contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_end_to_end_bounds_and_sources():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(cell, BENCH)
    assert c["cell"]["chips"] == 1
    assert hasattr(c["entry"], "Entry")
    e2e = [m["name"] for m, _ in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m, reader in c["end_to_end"] + c["per_layer"]:
        assert callable(reader.read), m["name"]
    assert set(c["data"]["check"]) == {"restraint_mismatch", "energy_gap", "grad_rms_median",
                                       "grad_rms_chrom_best"}
    for m, _ in c["per_layer"]:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = spec.load_json(spec.ROOT / config["file"])
    assert config["file"].startswith("benchmark/configs/")
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_per_layer_metrics_name_their_cells_and_layers():
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_metric_and_cell_raise():
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.run")
    with pytest.raises(KeyError):
        spec.resolve("no_such_cell", BENCH)
