"""The manifest and every file it names: found by name, within the
contract's limits; and a cell added as new files only."""

from __future__ import annotations

import copy
import json
import re
import shutil

import pytest

from benchmarks import harness
from benchmarks.tests.portbench_util import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"_dim$|_rank$|expansion|experts_per_tok)")


@pytest.fixture(scope="module")
def spec():
    return harness.manifest()


def test_manifest_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmarks"]
    assert spec["command"] == ["python3", "benchmarks/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [c["name"] for c in spec["configs"]] \
        + [w["name"] for w in spec["workloads"]] \
        + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_finds_its_files(spec):
    used = set()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = harness.Cell(spec, w["name"])
        used.add(w["config"])
        assert harness.load_driver(cell.driver).run
        assert hasattr(harness.load_driver(cell.driver), "control")
        assert cell.limits, w["name"]
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert callable(harness.load_reader(m["name"]).read)
    assert used == {c["name"] for c in spec["configs"]}


def test_configs_state_their_cuts(spec):
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        assert c["file"].startswith("benchmarks/")
        assert c["source"].startswith("https://")
        data = harness.load_json(ROOT / c["file"])
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        inside = data.get("reduced_inside", {})
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert inside[key]          # a changed group names its keys
        changed = set(inside.get("model", []))
        for key in changed:
            assert not WIDTH.search(key), key
            assert data["model"][key] != data["source_config"][key]
        # every other published number is kept
        src_key = data.get("model_source_keys", {})
        for key, v in data["model"].items():
            src = src_key.get(key, key)
            if src in data["source_config"] and key not in changed:
                assert v == data["source_config"][src], key


def test_paths_hold_only_benchmark_names():
    bad = []
    for p in (ROOT / "benchmarks").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel):
            bad.append(rel)
    assert not bad


def test_a_cell_added_as_new_files_only(tmp_path, spec):
    """A new traffic file, limits file and workload entry in a copy of the
    tree run without an edit to any file already there."""
    bench = tmp_path / "benchmarks"
    shutil.copytree(ROOT / "benchmarks", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((bench / "traffic" / "search-batch.json")
                         .read_text())
    traffic.update(queries=70, checked_queries=4, chunk_rows=8192)
    (bench / "traffic" / "search-tiny.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny-search.json").write_text(
        (bench / "limits" / "msmarco-search-batch.json").read_text())
    new = copy.deepcopy(spec)
    new["workloads"] = spec["workloads"] + [{
        "name": "tiny-search", "config": "dhr-distilbert-msmarco",
        "traffic": "search-tiny", "chips": 1, "why": "a test cell"}]
    for m in new["end_to_end"] + new["per_layer"]:
        if "msmarco-search-batch" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny-search"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.Cell(harness.manifest(tmp_path), "tiny-search",
                        root=tmp_path, bench=bench)
    assert cell.traffic["queries"] == 70
    cell.config["index"]["rows"] = 20000
    cell.config["search"].update(pool=1000, topk=100, query_batch=32)
    line = run_tiny(cell)
    assert line["correct"] and line["attempted"] >= 70
    assert set(line["metrics"]) == {"search_qps", "setup_s"}
