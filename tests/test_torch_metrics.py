"""The port's metrics and its ``eval`` / ``merge-runs`` verbs against
dhr_tpu's on the same runs and qrels.  Metrics are the same NumPy
arithmetic, so every number must be equal (tolerance 0)."""

import json

import numpy as np
import pytest

from dhr_tpu.cli.main import main as jax_main
from dhr_tpu.eval import metrics as jm
from dhr_tpu_torch.cli.main import main
from dhr_tpu_torch.eval import metrics as tm
from dhr_tpu_torch.retrieval import write_run


@pytest.fixture
def judged(rng):
    docs = [f"d{i}" for i in range(60)]
    qrels, run = {}, {}
    for q in range(12):
        qid = f"q{q}"
        rel = rng.choice(docs, size=int(rng.integers(0, 5)), replace=False)
        qrels[qid] = {d: int(rng.integers(0, 3)) for d in rel}
        if q % 5 != 4:   # a few queries without a run
            ranked = rng.choice(docs, size=40, replace=False)
            run[qid] = {d: float(s) for d, s in
                        zip(ranked, np.round(rng.random(40), 2))}
    qrels["q_zero"] = {"d1": 0}
    return qrels, run


@pytest.mark.parametrize("name", ["mrr_at_k", "recall_at_k",
                                  "recall_cap_at_k", "hole_at_k",
                                  "top_k_accuracy", "ndcg_at_k"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_run_metrics_equal_reference(judged, name, k):
    qrels, run = judged
    assert getattr(tm, name)(qrels, run, k) == getattr(jm, name)(qrels, run,
                                                                 k)


def test_evaluate_run_and_strict_mode_equal_reference(judged):
    qrels, run = judged
    assert tm.evaluate_run(qrels, run) == jm.evaluate_run(qrels, run)
    assert tm.zero_positive_queries(qrels) == jm.zero_positive_queries(qrels)
    for fn in ("recall_at_k", "recall_cap_at_k"):
        with pytest.raises(ValueError, match="no positive"):
            getattr(tm, fn)(qrels, run, 10, strict=True)


@pytest.mark.parametrize("compat", [False, True])
def test_array_metrics_equal_reference(rng, compat):
    ranked = [rng.integers(0, 3, int(rng.integers(1, 30))) for _ in range(9)]
    ranked.append(np.zeros(5, int))
    for fn in ("average_precision", "r_precision", "ndcg_reference"):
        for r in ranked:
            assert getattr(tm, fn)(r) == getattr(jm, fn)(r)
    for r in ranked:
        for k in (None, 3, 10):
            assert tm.reciprocal_rank(r, k) == jm.reciprocal_rank(r, k)
            assert tm.ndcg_from_ranked(r, k) == jm.ndcg_from_ranked(r, k)
    assert tm.rerank_metrics(ranked, compat) == jm.rerank_metrics(ranked,
                                                                  compat)


def _write(tmp_path, judged):
    qrels, run = judged
    path = tmp_path / "qrels.tsv"
    path.write_text("".join(f"{q} 0 {d} {r}\n" for q, rels in qrels.items()
                            for d, r in rels.items()))
    ranked = {q: sorted(docs, key=lambda d: (-docs[d], d))
              for q, docs in run.items()}
    write_run(str(tmp_path / "run.trec"), ranked,
              {q: [run[q][d] for d in ds] for q, ds in ranked.items()})
    return str(path), str(tmp_path / "run.trec")


@pytest.mark.parametrize("extra", [[], ["--rcap", "--k", "10"]])
def test_eval_cli_prints_what_the_reference_prints(tmp_path, judged, capsys,
                                                   extra):
    qrels, run = _write(tmp_path, judged)
    main(["eval", "--qrels", qrels, "--run", run, *extra])
    got = capsys.readouterr().out
    jax_main(["eval", "--qrels", qrels, "--run", run, *extra])
    want = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["zero_positive_queries"] >= 1
    with pytest.raises(ValueError, match="no positive"):
        main(["eval", "--qrels", qrels, "--run", run, "--strict"])


def test_merge_runs_cli_writes_what_the_reference_writes(tmp_path):
    write_run(str(tmp_path / "r0.trec"), {"q": ["d1", "d3"], "p": ["d2"]},
              {"q": [9.0, 1.5], "p": [0.25]})
    write_run(str(tmp_path / "r1.trec"), {"q": ["d2", "d4"]},
              {"q": [5.0, 1.5]})
    main(["merge-runs", "--inputs", str(tmp_path / "r*.trec"),
          "--output", str(tmp_path / "m_torch.out"), "--topk", "3"])
    jax_main(["merge-runs", "--inputs", str(tmp_path / "r*.trec"),
              "--output", str(tmp_path / "m_jax.out"), "--topk", "3"])
    got = (tmp_path / "m_torch.out").read_text()
    assert got == (tmp_path / "m_jax.out").read_text()
    assert got.splitlines()[0].split()[2] == "d1"


def test_sharded_search_then_merge_equals_full_run(tmp_path, rng):
    """``search --total-shard/--shard`` slices the rows; the merged shard
    runs equal the full run, as with python -m dhr_tpu."""
    from dhr_tpu_torch.retrieval import PackedIndex, read_run

    values = (rng.random((40, 8)) + 0.1).astype(np.float16)
    indices = rng.integers(0, 3, (40, 8)).astype(np.uint8)
    docids = np.asarray([f"d{i}" for i in range(40)], dtype=object)
    PackedIndex(values, indices, docids, lex_dim=8).save(
        str(tmp_path / "index.npz"))
    qnpz = str(tmp_path / "q.npz")
    np.savez(qnpz, values=values[:2].astype(np.float32),
             indices=indices[:2].astype(np.int32))
    (tmp_path / "q.npz.qids.json").write_text(json.dumps(["q0", "q1"]))
    base = ["search", "--index-path", str(tmp_path / "index.npz"),
            "--query-path", qnpz, "--brute-force", "--topk", "10",
            "--query-batch", "2", "--device", "cpu"]
    main(base + ["--output", str(tmp_path / "full.trec")])
    for s in range(3):
        main(base + ["--output", str(tmp_path / f"part{s}.trec"),
                     "--total-shard", "3", "--shard", str(s)])
    main(["merge-runs", "--inputs", str(tmp_path / "part*.trec"),
          "--output", str(tmp_path / "merged.trec"), "--topk", "10"])
    full = read_run(str(tmp_path / "full.trec"))
    merged = read_run(str(tmp_path / "merged.trec"))
    for q in ("q0", "q1"):
        assert list(merged[q]) == list(full[q])
