"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: chromosome3d_tpu_torch is not chromosome3d_tpu), the
reference imports nothing of the program, and run.py refuses to measure
without a card or without the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "chromosome3d_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, f"{path}: {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        names = set(_imports(path))
        assert "chromosome3d_tpu_torch" not in names and not names & FORBIDDEN, path
        assert names <= {"__future__", "numpy", "torch"}, (path, names)


def test_the_check_reads_only_the_reference():
    names = set(_imports(BENCH / "harness" / "check.py"))
    assert "chromosome3d_tpu_torch" not in names


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_run_exits_nonzero_without_a_card():
    r = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "chr1_50kb_run",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "genome_45_bucket",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, env=_env(), timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


def test_the_command_names_no_file_outside_the_paths():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in bench["paths"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chr1_50kb_run", "genome_45_bucket", "genome_100kb"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        "987654321987", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
