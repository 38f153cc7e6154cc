"""The result line's keys, the refusal without a card, and the modules a
run loads: none of JAX, its libraries or the JAX package; and the
reference and the generators import nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness
from benchmarks.tests.portbench_util import ROOT, run_tiny, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    line = run_tiny(tiny_cell("msmarco-search-batch"), trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert list(line)[-1] == "checks"
    json.dumps(line)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {
            m["name"] for m in harness.manifest()["per_layer"]}
    else:
        assert set(line["metrics"]) == {"search_qps", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_refuses_without_a_card():
    """No CUDA device here: a non-zero exit and no result line."""
    p = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "msmarco-search-batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_refuses_where_the_program_is_missing(tmp_path):
    """A directory that holds only the manifest and the benchmark."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "msmarco-search-batch", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_jax_in_a_run():
    """A run (a tiny search cell on the CPU, in its own process) holds none
    of the forbidden top-level modules once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmarks.tests.portbench_util import run_tiny, tiny_cell\n"
        "from benchmarks import harness\n"
        "for name in ('msmarco-search-batch', 'bert-base-encode-corpus',"
        " 'bert-base-train'):\n"
        "    run_tiny(tiny_cell(name))\n"
        "import benchmarks.tools.control, benchmarks.tools.runs\n"
        "print(sorted(harness.top_level_modules()))\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "dhr_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            yield n.module


def test_reference_and_generators_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (ROOT / "benchmarks" / sub).glob("*.py"):
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in harness.FORBIDDEN + ("dhr_tpu_torch",), \
                    (path, mod)


def test_no_file_of_the_benchmark_names_jax():
    for path in (ROOT / "benchmarks").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)
