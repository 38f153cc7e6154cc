"""The port's pipeline rehearsal (dhr_tpu_torch/tools/pipeline_rehearsal.py)
against the JAX tool (tools/pipeline_rehearsal.py).

- the world (make_world, make_queries, zipf_background and the written
  corpus / train / dev / qrels files) is byte-equal to the JAX tool's for
  three seeds; _ratio, family_flags, default_topics and the gate constants
  match case by case;
- a --quick run on the CPU (family dhr, cut to 256 passages, 96 train
  queries, 32 dev queries and 8 steps so that it fits a test's time) exits
  0 with mrr_improves and staged_holds_exact_quality true; its report has
  the JAX tool's keys (read from the JAX tool's source) and
  tools/render_pipeline_run.py renders it;
- its untrained exact TREC run equals, up to ties, dhr_tpu's brute-force
  Searcher on the same two npz files (the on-disk formats are shared).
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dhr_tpu_torch.tools import pipeline_rehearsal as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import pipeline_rehearsal as jax_tool  # noqa: E402

JAX_TOOL = os.path.join(ROOT, "tools", "pipeline_rehearsal.py")
QUICK = ["--quick", "--n-corpus", "256", "--n-train", "96", "--n-dev", "32",
         "--max-steps", "8"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_world_generators_equal_the_jax_tool(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(port.zipf_background(a, 500),
                                  jax_tool.zipf_background(b, 500))
    pw, pz, pp = port.make_world(a, 6, 12, 80)
    jw, jz, jp = jax_tool.make_world(b, 6, 12, 80)
    assert pw == jw
    np.testing.assert_array_equal(pz, jz)
    np.testing.assert_array_equal(pp, jp)
    pids = np.arange(0, 80, 3)
    assert port.make_queries(a, pw, pz, pp, pids) == \
        jax_tool.make_queries(b, jw, jz, jp, pids)
    # the streams stayed in step
    assert a.random() == b.random()


def _jax_world_files(work, seed, n_corpus, n_train, n_dev, n_topics,
                     pool_size):
    """The JAX tool's world files, as its main writes them
    (tools/pipeline_rehearsal.py:395-433), with its own functions."""
    from dhr_tpu.data.examples import write_jsonl

    rng = np.random.default_rng(seed)
    passages, z, pools = jax_tool.make_world(rng, n_topics, pool_size,
                                             n_corpus)
    write_jsonl(os.path.join(work, "corpus.jsonl"), (
        {"text_id": f"d{i}", "text": p} for i, p in enumerate(passages)))
    all_pids = rng.permutation(n_corpus)
    train_pids = all_pids[:n_train]
    dev_pids = all_pids[n_train: n_train + n_dev]
    train_queries = jax_tool.make_queries(rng, passages, z, pools,
                                          train_pids)
    dev_queries = jax_tool.make_queries(rng, passages, z, pools, dev_pids)
    groups = []
    for qt, pid in zip(train_queries, train_pids):
        topic_mates = np.flatnonzero(z == z[pid])
        hard = rng.choice(
            topic_mates[topic_mates != pid],
            size=min(8, max(1, len(topic_mates) - 1)), replace=False)
        rand = rng.integers(0, n_corpus, 24)
        negs = [str(int(p)) for p in (*hard, *rand) if int(p) != int(pid)]
        groups.append({"query": qt, "positive_pids": [str(int(pid))],
                       "negative_pids": negs})
    write_jsonl(os.path.join(work, "train.jsonl"), groups)
    write_jsonl(os.path.join(work, "dev_queries.jsonl"), (
        {"text_id": f"q{i}", "text": t} for i, t in enumerate(dev_queries)))
    with open(os.path.join(work, "dev.qrels"), "w") as f:
        for i, pid in enumerate(dev_pids):
            f.write(f"q{i} 0 d{int(pid)} 1\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_world_files_are_byte_equal_to_the_jax_tool(tmp_path, seed):
    sizes = dict(n_corpus=400, n_train=80, n_dev=30, n_topics=8,
                 pool_size=12)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths = port.write_world(str(tmp_path / "port"), seed, **sizes)
    _jax_world_files(str(tmp_path / "jax"), seed, **sizes)
    names = ["corpus.jsonl", "train.jsonl", "dev_queries.jsonl", "dev.qrels"]
    assert [os.path.basename(p) for p in paths] == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_ratio_matches_the_jax_tool_case_by_case():
    for num, den in ((0.09, 0.10), (0.2, 0.1), (0.0, 0.0), (0.3, 0.0),
                     (0.123456, 0.7), (1, 3)):
        assert port._ratio(num, den) == jax_tool._ratio(num, den)
    for num, den in ((None, None), (0.0, None), (None, 0.1)):
        with pytest.raises(KeyError):
            port._ratio(num, den)
        with pytest.raises(KeyError):
            jax_tool._ratio(num, den)


def test_constants_and_family_flags_match_the_jax_tool():
    for name in ("STAGED_FLOOR", "MAX_STAGED_RUNGS", "VOCAB", "FIRST_TOKEN",
                 "REMOVE", "CLS_ID", "SEP_ID", "VERB_TIMEOUT_S"):
        assert getattr(port, name) == getattr(jax_tool, name), name
    for family in ("dhr", "dense", "agg", "colbert"):
        assert port.family_flags(family, "/ckpt") == \
            jax_tool.family_flags(family, "/ckpt")
    for tool in (port, jax_tool):
        with pytest.raises(ValueError):
            tool.family_flags("dlr", "/ckpt")
    for n, quick in ((2048, True), (1000, False), (102_400, False),
                     (1_024_000, False), (8_841_823, False)):
        assert port.default_topics(n, quick) == \
            jax_tool.default_topics(n, quick)


def test_family_flags_parse_against_the_port_cli():
    from dhr_tpu_torch.cli.main import build_parser

    ap = build_parser()
    for family in ("dhr", "dense", "agg", "colbert"):
        flags = port.family_flags(family, "/ckpt")
        for verb in (["encode", "--input", "x", "--output", "y"],
                     ["train", "--train-path", "t", "--output-dir", "o"]):
            args = ap.parse_args([verb[0], *flags, "--bf16", *verb[1:]])
            assert args.model == family and args.bf16


def test_without_a_gpu_the_run_fails_unless_the_cpu_is_asked(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port.main(["--workdir", str(tmp_path)])
    assert e.value.code == 1
    assert not os.listdir(tmp_path)
    args = port.parse_args(["--device", "cpu"])
    assert args.device == "cpu" and args.n_corpus == 102_400
    assert port.parse_args(["--quick"]).device == "cpu"


def test_a_failing_verb_raises(tmp_path):
    args = port.parse_args(["--quick"])
    timings = []
    with pytest.raises(RuntimeError, match="eval-missing failed"):
        port.run_verb("eval-missing", [
            "eval", "--qrels", str(tmp_path / "none.qrels"), "--run",
            str(tmp_path / "none.trec")], dict(os.environ, PYTHONPATH=ROOT),
            timings, args)
    assert timings[0]["verb"] == "eval-missing"


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("rehearsal")
    out = work / "report.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run(
        [sys.executable, "-m", "dhr_tpu_torch.tools.pipeline_rehearsal",
         *QUICK, "--workdir", str(work), "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    return p, work, out


def _jax_schema():
    """Keys the JAX tool writes: the report's top level (``report[...]``
    in main), its config dict, and each stage's quality dict and staged
    operating point (eval_stage)."""
    tree = ast.parse(open(JAX_TOOL).read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def subscripts(fn, name):
        keys = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == name):
                        keys.add(t.slice.value)
        return keys

    def dict_keys(fn, name):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and isinstance(node.value,
                                                            ast.Dict)
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in node.targets)):
                return node.value
        raise KeyError(name)

    report = dict_keys(funcs["main"], "report")
    config = {k.value for k in report.values[0].keys}
    point = {k.value for k in dict_keys(funcs["eval_stage"], "point").keys}
    top = {k.value for k in report.keys} | subscripts(funcs["main"],
                                                      "report")
    return top, config, subscripts(funcs["eval_stage"], "quality"), point


def test_quick_run_learns_and_keeps_the_jax_schema(quick_run):
    p, work, out = quick_run
    assert p.returncode == 0, p.stderr[-4000:]
    report = json.loads(out.read_text())
    assert report["mrr_improves"] is True
    assert report["staged_holds_exact_quality"] is True
    top, config, quality, point = _jax_schema()
    assert set(report) == top
    assert set(report["config"]) == config
    assert set(report["trained"]) == quality
    assert set(report["untrained"]) == quality
    assert set(report["trained"]["staged_operating_point"]) == point
    assert report["config"]["quick"] is True
    assert "hidden 64 x 2 layers" in report["config"]["model"]
    verbs = [t["verb"] for t in report["timings"]]
    assert verbs[0] == "world-gen" and "train" in verbs
    assert "trained.search-exact" in verbs
    # every verb that takes --device ran on the CPU
    for t in report["timings"]:
        for line in t.get("device", []):
            if "device" in line:
                assert line["device"] == "cpu", t
    searches = [t for t in report["timings"] if ".search-" in t["verb"]]
    assert all("launches" in t["device"][0] for t in searches)
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "render_pipeline_run.py"),
                        str(out)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    assert "learn-to-retrieve holds" in r.stdout
    assert "| trained.search-staged |" in r.stdout


def _up_to_ties(got_ids, got_s, want_ids, want_s, rel=1e-5):
    """Scores equal rank by rank within ``rel``; ids equal apart from order
    inside runs of scores within ``rel`` of each other (the run reaching
    the cut compared by its count)."""
    np.testing.assert_allclose(got_s, want_s, rtol=rel, atol=0)
    n, start = len(want_s), 0
    for i in range(1, n + 1):
        if i == n or abs(want_s[i] - want_s[start]) > rel * abs(
                want_s[start]):
            if i < n:
                assert set(got_ids[start:i]) == set(want_ids[start:i])
            start = i


def test_untrained_exact_run_equals_dhr_tpu_brute_force(quick_run):
    from dhr_tpu.retrieval import DeviceIndex, PackedIndex, SearchConfig
    from dhr_tpu.retrieval import Searcher

    p, work, _ = quick_run
    assert p.returncode == 0, p.stderr[-4000:]
    packed = PackedIndex.load(str(work / "untrained_index.npz"))
    assert packed.value_scales is not None  # int8, as the verb built it
    with np.load(work / "untrained_queries.npz") as z:
        qv, qi = z["values"], z["indices"]
    qids = json.loads((work / "untrained_queries.npz.qids.json")
                      .read_text())
    searcher = Searcher(DeviceIndex.from_packed(packed),
                        SearchConfig(topk=1000, theta=0.0, query_batch=32))
    results, scores = searcher.search_run(qids, qv, qi)
    got = {}
    for line in (work / "untrained_exact.trec").read_text().splitlines():
        q, _, doc, _, s, _ = line.split()
        got.setdefault(q, []).append((doc, float(s)))
    assert sorted(got) == sorted(results)
    for q in qids:
        assert len(got[q]) == len(results[q]) == packed.num_rows
        _up_to_ties([d for d, _ in got[q]], [s for _, s in got[q]],
                    results[q], np.asarray(scores[q]))
