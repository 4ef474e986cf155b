"""Find everything a cell needs by the names in BENCHMARK.json.

  BENCHMARK.json                  the cells, metrics, run_seconds, command
  benchmark/configs/<config>.json a deployment: source, sizes, protocol
  benchmark/traffic/<traffic>.json a traffic mix: its entry kind and parameters
  benchmark/workloads/<cell>.json a cell's own data: the limits of its check
  benchmark/entries/<kind>.py     one module for each entry kind
  benchmark/metrics/<metric>.py   one reader for each metric; a name with a
                                  dot (`prep_ms.run`) falls back to the file of
                                  the part before the dot (`prep_ms.py`)
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metric_reader(name: str):
    """The module whose read() gives metric `name`."""
    for stem in (name, name.split(".")[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            return _module(path, f"bench_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {name!r} under {BENCH_DIR / 'metrics'}")


def entry_module(kind: str):
    path = BENCH_DIR / "entries" / f"{kind}.py"
    if not path.exists():
        raise FileNotFoundError(f"no module for entry kind {kind!r}: {path}")
    return _module(path, f"bench_entry_{kind}")


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The metrics of `group` ("end_to_end" or "per_layer") that cell reports:
    those without a `workloads` key, and those that list the cell."""
    return [m for m in bench[group] if "workloads" not in m or cell in m["workloads"]]


def resolve(cell: str, bench: dict = None) -> dict:
    """Everything one cell needs: its BENCHMARK.json entry, config, traffic,
    cell data, entry module and metric readers."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"unknown workload {cell!r}; known: {sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    data = load_json(BENCH_DIR / "workloads" / f"{cell}.json")
    e2e = metrics_of(bench, cell, "end_to_end")
    layer = metrics_of(bench, cell, "per_layer")
    return {
        "cell": w, "config": config, "traffic": traffic, "data": data,
        "entry": entry_module(traffic["entry"]),
        "end_to_end": [(m, metric_reader(m["name"])) for m in e2e],
        "per_layer": [(m, metric_reader(m["name"])) for m in layer],
    }
