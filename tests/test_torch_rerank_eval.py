"""The port's rerank evaluation against ``dhr_tpu.eval.rerank``: the pair
scorer of every family on one Flax tree (loaded into both packages), the
metrics of ``evaluate_rerank`` with its read-time ``max_queries`` cut, and
the ``rerank-eval`` verb on an HF checkpoint both CLIs load.

Scores agree within 1e-5 of the batch's largest magnitude (f32 models,
different summation orders); metrics within 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.cli.main import main as jax_main
from dhr_tpu.eval import rerank as ref
from dhr_tpu.models.retrievers import BiEncoder as JaxBiEncoder
from dhr_tpu.train.checkpoint import export_hf_checkpoint
from dhr_tpu_torch.cli.main import main
from dhr_tpu_torch.data import collate
from dhr_tpu_torch.eval.rerank import evaluate_rerank, make_pair_scorer
from dhr_tpu_torch.models import BiEncoder, load_flax_params
from tests.test_torch_models import CASES, OUT, REMOVE, V, configs, flax_tree

SCORER_CASES = ["dense_cls", "dense_mean_pooler", "dhr_pooler",
                "dhr_no_pooler", "dlr_pooler", "agg_full", "agg_semi",
                "agg_skip_mlm", "colbert"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_scorers(case, seed):
    jcfg, tcfg = configs(CASES[case])
    b = collate.pad_token_batch([[REMOVE + 1] * 6], 8, 0, 1, 2)
    tree = flax_tree(jcfg, b["input_ids"], b["attention_mask"], seed)
    want = ref.make_pair_scorer(JaxBiEncoder(jcfg), tree, jcfg,
                                remove_dims=REMOVE)
    got = make_pair_scorer(load_flax_params(BiEncoder(tcfg), tree), tcfg,
                           remove_dims=REMOVE, device="cpu")
    return got, lambda q, p: np.asarray(want(jax.tree.map(jnp.asarray, q),
                                             jax.tree.map(jnp.asarray, p)))


def token_rows(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(REMOVE, V, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("case", SCORER_CASES)
def test_pair_scorer_matches_reference(case):
    got, want = both_scorers(case, 30)
    q = collate.pad_token_batch(token_rows(31, 6, 1, 10), 10, 0, 1, 2)
    p = collate.pad_token_batch(token_rows(32, 6, 0, 16), 16, 0, 1, 2)
    s = got(q, p)
    assert isinstance(s, torch.Tensor) and s.dtype == torch.float32
    w = want(q, p)
    assert s.shape == w.shape == (6,)
    np.testing.assert_allclose(s.numpy(), w, rtol=1e-5,
                               atol=1e-5 * np.abs(w).max())


def examples(seed, n_queries=5):
    """(qid, q_tokens, pid, p_tokens, rel) rows, 2-6 a query, one empty
    passage, ragged lengths."""
    rng = np.random.default_rng(seed)
    rows = []
    for q in range(n_queries):
        q_toks = token_rows(seed + q, 1, 1, 9)[0]
        n = int(rng.integers(2, 7))
        for j, p_toks in enumerate(token_rows(seed + 50 + q, n, 1, 20)):
            rows.append((f"q{q}", q_toks, f"p{q}-{j}",
                         [] if (q, j) == (2, 1) else p_toks,
                         int(rng.random() < 0.4 or j == n - 1)))
    return rows


@pytest.mark.parametrize("case", ["dhr_pooler", "colbert"])
@pytest.mark.parametrize("reference_compat", [False, True])
def test_evaluate_rerank_metrics_match_reference(case, reference_compat):
    got_scorer, want_scorer = both_scorers(case, 33)
    rows = examples(34)
    kw = dict(q_max_len=10, p_max_len=20, batch_size=4, cls_id=1, sep_id=2,
              reference_compat=reference_compat)
    got = evaluate_rerank(got_scorer, rows, **kw)
    want = ref.evaluate_rerank(want_scorer, rows, **kw)
    assert sorted(got) == sorted(want) and got["num_queries"] == 5
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("max_queries,batch_size", [
    (1, 3), (2, 3), (3, 4), (3, 64), (9, 4)])
def test_max_queries_cut_never_lands_inside_a_query(max_queries, batch_size):
    """Queries are counted as their rows are read: a flush that holds the
    next query's first row never admits it past the cap."""
    got_scorer, want_scorer = both_scorers("dense_cls", 35)
    rows = examples(36)
    kw = dict(q_max_len=10, p_max_len=20, batch_size=batch_size,
              max_queries=max_queries)
    got = evaluate_rerank(got_scorer, rows, **kw)
    want = ref.evaluate_rerank(want_scorer, rows, **kw)
    assert got["num_queries"] == want["num_queries"] == min(max_queries, 5)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_rerank_eval_verb_matches_reference(tmp_path, capsys):
    jcfg, _ = configs(CASES["dhr_pooler"])
    b = collate.pad_token_batch([[REMOVE + 1] * 6], 8, 0, 1, 2)
    ckpt = str(tmp_path / "ckpt")
    export_hf_checkpoint(ckpt, flax_tree(jcfg, b["input_ids"],
                                         b["attention_mask"], 37), jcfg)
    with open(tmp_path / "eval.jsonl", "w") as f:
        for qid, q, pid, p, rel in examples(38, n_queries=6):
            f.write(json.dumps({"qry_text_id": qid, "qry_text": q,
                                "psg_text_id": pid, "psg_text": p,
                                "rel": rel}) + "\n")
    args = ["rerank-eval", "--model", "dhr", "--model-name-or-path", ckpt,
            "--add-pooler", "--dlr-out-dim", str(OUT), "--remove-dims",
            str(REMOVE), "--cls-token-id", "1", "--sep-token-id", "2",
            "--batch-size", "5", "--q-max-len", "10", "--p-max-len", "20",
            "--input", str(tmp_path / "eval.jsonl"), "--max-queries", "4",
            "--reference-ndcg"]
    jax_main(args)
    want = json.loads(capsys.readouterr().out)
    main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want) and got["num_queries"] == 4
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
