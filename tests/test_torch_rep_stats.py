"""The port's rep_stats (dhr_tpu_torch/tools/rep_stats.py) against the JAX
tool (tools/rep_stats.py), on the CPU.

- pct, overlap_at_k, stats_from_planes and _drift equal the JAX tool's on
  the same arrays;
- npz_stats dequantizes an int8 npz (the counterpart of
  tests/test_rep_stats.py) and equals the JAX tool's on the same files;
- a dense-family npz (no fold plane) is refused with a message naming the
  file, where the JAX tool raises a TypeError;
- the staged / reference-theta / exact agreement on the same planes equals
  the JAX tool's within 0.02 a query at each k (its candidate selection is
  ``lax.approx_max_k`` per slice, the port's an exact top-k per slice;
  equal pools but for ties);
- the generator keeps ~30-46 query dims above theta 0.3, and the report
  and the trained toy's keys are the JAX tool's.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from dhr_tpu_torch.retrieval.index import PackedIndex
from dhr_tpu_torch.retrieval.synth import SynthConfig
from dhr_tpu_torch.tools import rep_stats as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import rep_stats as jax_tool  # noqa: E402

JAX_TOOL = os.path.join(ROOT, "tools", "rep_stats.py")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _planes(seed, nq=16, n=300, lex=64, n_folds=7):
    rng = np.random.default_rng(seed)
    lexq = (rng.random((nq, lex)) ** 3).astype(np.float32)
    lexp = (rng.random((n, lex)) ** 4 * 0.8).astype(np.float32)
    pf = rng.integers(0, n_folds, (n, lex)).astype(np.int8)
    return lexq, lexp, pf, n_folds


@pytest.mark.parametrize("seed", [0, 1])
def test_pure_helpers_equal_the_jax_tool(seed):
    lexq, lexp, pf, n_folds = _planes(seed)
    for theta, cap in ((0.3, 8), (0.05, 48), (0.9, 1)):
        assert port.stats_from_planes(lexq, lexp, pf, n_folds, theta, cap) \
            == jax_tool.stats_from_planes(lexq, lexp, pf, n_folds, theta,
                                          cap)
    x = np.random.default_rng(seed).random(101)
    for q in (0, 50, 95, 99, 100):
        assert port.pct(x, q) == jax_tool.pct(x, q)
    rng = np.random.default_rng(seed + 5)
    a = [rng.permutation(50) for _ in range(6)]
    b = [rng.permutation(50) for _ in range(6)]
    for k in (1, 10, 50):
        assert port.overlap_at_k(a, b, k) == jax_tool.overlap_at_k(a, b, k)
    real = port.stats_from_planes(lexq, lexp, pf, n_folds, 0.3, 8)
    synth = port.stats_from_planes(*_planes(seed + 9)[:3], n_folds, 0.3, 8)
    assert port._drift(real, synth) == jax_tool._drift(real, synth)


def _save_world(tmp_path, pk, with_folds=True):
    corpus = str(tmp_path / "corpus.npz")
    pk.save(corpus)
    rng = np.random.default_rng(1)
    qv = (rng.random((8, pk.values.shape[1])) * 0.6).astype(np.float32)
    queries = str(tmp_path / "queries.npz")
    arrays = {"values": qv}
    if with_folds:
        arrays["indices"] = rng.integers(0, 4, (8, pk.lex_dim)).astype(
            np.int32)
    np.savez(queries, **arrays)
    with open(queries + ".qids.json", "w") as f:
        json.dump([f"q{i}" for i in range(8)], f)
    return corpus, queries


def _float_index(n=64, lex=24, cls=8):
    rng = np.random.default_rng(0)
    vals = (rng.random((n, lex + cls)) * 0.5).astype(np.float32)
    idxs = rng.integers(0, 4, (n, lex)).astype(np.uint8)
    docids = np.asarray([f"d{i}" for i in range(n)], dtype=object)
    return PackedIndex(vals, idxs, docids, lex_dim=lex)


def test_npz_stats_dequantizes_int8_and_equals_the_jax_tool(tmp_path):
    pk_f = _float_index()
    pk_q = pk_f.quantize()
    (tmp_path / "f").mkdir()
    (tmp_path / "q").mkdir()
    cf, qf_ = _save_world(tmp_path / "f", pk_f)
    cq, qq = _save_world(tmp_path / "q", pk_q)
    theta = 0.25
    s_f, _, _ = port.npz_stats(cf, qf_, theta, cap=16)
    s_q, pkq, (qv, qf) = port.npz_stats(cq, qq, theta, cap=16)
    assert pkq.value_scales is not None and qf.dtype == np.int32
    # dequantized statistics track the float plane; raw codes would put
    # every nonzero value above theta
    a = s_f["passage_dims_active"]["gt_theta_mean"]
    b = s_q["passage_dims_active"]["gt_theta_mean"]
    assert abs(a - b) <= max(0.05 * a, 0.5), (s_f, s_q)
    a = s_f["value_profile"]["p_active_mean"]
    b = s_q["value_profile"]["p_active_mean"]
    assert abs(a - b) <= 0.05 * a and b < 1.0
    for c, q, got in ((cf, qf_, s_f), (cq, qq, s_q)):
        want, _, _ = jax_tool.npz_stats(c, q, theta, cap=16, max_rows=40)
        assert port.npz_stats(c, q, theta, cap=16, max_rows=40)[0] == want
        assert got == jax_tool.npz_stats(c, q, theta, cap=16)[0]


def test_dense_npz_is_refused_by_name(tmp_path):
    pk = _float_index()
    dense = PackedIndex(pk.values[:, 24:], None, pk.docids, lex_dim=0)
    corpus, queries = _save_world(tmp_path, dense, with_folds=False)
    with pytest.raises(SystemExit, match="no fold plane") as e:
        port.npz_stats(corpus, queries, 0.3, cap=16)
    assert corpus in str(e.value)
    with pytest.raises(SystemExit, match="no fold plane"):
        port.main(["--from-corpus-npz", corpus, "--from-query-npz", queries,
                   "--device", "cpu"])
    # the JAX tool's crash that this message replaces
    with pytest.raises(TypeError):
        jax_tool.npz_stats(corpus, queries, 0.3, cap=16)


@pytest.fixture(scope="module")
def small_generator():
    cfg = SynthConfig()
    return cfg, port.generator_stats(cfg, 12_288, 24, 0.3, 48,
                                     device="cpu")


def test_generator_stats_keep_the_calibrated_band(small_generator):
    cfg, (stats, corpus, queries) = small_generator
    assert 30 <= stats["query_dims_above_theta"]["mean"] <= 46
    assert stats["fold_top_share_mean"] > 2 * stats["fold_uniform_share"]
    v_i8, folds, scales, _ = corpus
    assert v_i8.dtype == torch.int8 and v_i8.shape == (12_288, 896)
    assert folds.shape == (12_288, 768) and scales.shape == (896,)


def test_agreement_equals_the_jax_tool_on_the_same_planes(small_generator):
    cfg, (_, corpus, queries) = small_generator
    got = port.agreement(cfg, corpus, queries, 0.3, 48, 100, 1000,
                         device="cpu")
    jcorpus = tuple(t.numpy() for t in corpus)
    jqueries = tuple(t.numpy() for t in queries)
    want = jax_tool.agreement(cfg, jcorpus, jqueries, 0.3, 48, 100, 1000)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 0.02, (k, got[k], want[k])
    assert got["reference_theta_vs_exact@10"] >= 0.9


def test_npz_agreement_equals_the_jax_tool(tmp_path, small_generator):
    from dhr_tpu_torch.retrieval.synth import synth_reps

    cfg, (_, corpus, queries) = small_generator
    v_i8, folds, scales, _ = (t.numpy() for t in corpus)
    n = v_i8.shape[0]
    pk = PackedIndex(v_i8, folds.astype(np.uint8),
                     np.arange(n).astype(str).astype(object), cfg.lex_dim,
                     scales)
    pk.save(str(tmp_path / "c.npz"))
    qv, qf, _ = synth_reps(0, 16, cfg, "query", stream=2, device="cpu")
    np.savez(tmp_path / "q.npz", values=qv.numpy(),
             indices=qf.numpy().astype(np.int32))
    (tmp_path / "q.npz.qids.json").write_text(json.dumps(
        [f"q{i}" for i in range(16)]))
    real, pk_p, (qv_n, qf_n) = port.npz_stats(
        str(tmp_path / "c.npz"), str(tmp_path / "q.npz"), 0.3, 48)
    got = port.npz_agreement(pk_p, qv_n, qf_n, 0.3, 48, 100, 1000, 8192,
                             device="cpu")
    _, pk_j, (qv_j, qf_j) = jax_tool.npz_stats(
        str(tmp_path / "c.npz"), str(tmp_path / "q.npz"), 0.3, 48)
    want = jax_tool.npz_agreement(pk_j, qv_j, qf_j, 0.3, 48, 100, 1000,
                                  8192)
    assert got.keys() == want.keys() and got["n_rows"] == 8192
    for k in want:
        assert abs(got[k] - want[k]) <= 0.02, (k, got[k], want[k])


def _report_keys(path):
    """The keys of every ``report = {...}`` literal in ``main``."""
    tree = ast.parse(open(path).read())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    out = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "report"
                        for t in node.targets)):
            out.append({k.value for k in node.value.keys})
    return out


def test_reports_keep_the_jax_tool_keys(tmp_path):
    out = tmp_path / "stats.json"
    report = port.main(["--n-corpus", "4096", "--n-queries", "8", "--topk",
                        "50", "--pool", "500", "--device", "cpu",
                        "--out", str(out)])
    assert json.loads(out.read_text()) == report
    generator_keys = [k for k in _report_keys(JAX_TOOL) if "generator" in k]
    assert set(report) == generator_keys[0]
    assert set(report["config"]) == set(
        f.name for f in __import__("dataclasses").fields(SynthConfig))
    assert _report_keys(JAX_TOOL) == _report_keys(port.__file__)


def test_trained_toy_reports_the_jax_tool_keys():
    got = port.trained_stats(0.3, device="cpu")
    tree = ast.parse(open(JAX_TOOL).read())
    fn = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
              and f.name == "trained_stats")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    assert set(got) == {k.value for k in ret.value.keys}
    for k in ("query_frac_dims_above_theta_mean",
              "passage_fold_top_share_mean"):
        assert 0.0 <= got[k] <= 1.0
    assert np.isfinite(got["query_top1_dim_mass_share_mean"])
