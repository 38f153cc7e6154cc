"""The port's ColBERT MaxSim scoring and full-ranking retrieval against
``dhr_tpu.retrieval.colbert``, and its ``colbert-score`` verb against the
reference's.

Reps come from a seed: standard normal with zero-padded tails (what
``encode_tokens`` writes), CLS at position 0.  Scores agree to f32
rounding: ``|got - want| <= 1e-6 * (|want| + max|want|)`` (a MaxSim near
zero sums terms as large as the largest score, so its rounding is relative
to that scale).  Row ids are exact: on the tie-free fixtures, and where
passages repeat, too, since both sides keep the lower row on equal scores.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.cli.main import main as jax_main
from dhr_tpu.retrieval import colbert as ref
from dhr_tpu_torch.cli.main import main
from dhr_tpu_torch.retrieval import colbert


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_reps(seed, n, length, dim=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    reps = rng.standard_normal((n, length, dim)).astype(np.float32)
    for i in range(n):
        reps[i, int(rng.integers(2, length + 1)):] = 0.0
    return reps.astype(dtype)


def assert_scores_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_maxsim_pairwise_and_listwise_match_reference(dtype):
    q = make_reps(0, 7, 5, dtype=dtype)
    p = make_reps(1, 37, 9, dtype=dtype)
    assert_scores_close(
        colbert.maxsim_listwise(torch.from_numpy(q), torch.from_numpy(p)),
        ref.maxsim_listwise(jnp.asarray(q), jnp.asarray(p)))
    qq = make_reps(2, 37, 5, dtype=dtype)
    assert_scores_close(
        colbert.maxsim_pairwise(torch.from_numpy(qq), torch.from_numpy(p)),
        ref.maxsim_pairwise(jnp.asarray(qq), jnp.asarray(p)))


@pytest.mark.parametrize("batch_size", [4, 256])
def test_score_pairs_matches_reference(batch_size):
    q, p = make_reps(3, 6, 5), make_reps(4, 11, 9)
    qids, pids = [f"q{i}" for i in range(6)], [f"d{i}" for i in range(11)]
    rng = np.random.default_rng(5)
    pairs = [(qids[a], pids[b]) for a, b in zip(rng.integers(0, 6, 23),
                                                rng.integers(0, 11, 23))]
    got = colbert.score_pairs(q, qids, p, pids, pairs, batch_size=batch_size,
                              device="cpu")
    assert got.shape == (23,)
    assert_scores_close(got, ref.score_pairs(q, qids, p, pids, pairs,
                                             batch_size=batch_size))
    assert colbert.score_pairs(q, qids, p, pids, [], device="cpu").shape == (
        0,)


@pytest.mark.parametrize("route,budget", [
    ("resident", 4 << 30),
    ("slabs", 12 * 9 * 8 * 4),  # 12 rows a slab: 4 slabs of 41 rows
])
@pytest.mark.parametrize("topk", [9, 41, 1000])
def test_full_ranking_matches_reference(route, budget, topk):
    """Ids exact, scores to rounding, the topk clamp (1000 -> 41 rows),
    pads past a chunk boundary (41 % 4 != 0) and ragged query batches."""
    q, p = make_reps(6, 5, 4), make_reps(7, 41, 9)
    want_s, want_r = ref.full_ranking(q, p, topk=topk, q_batch=2, p_chunk=4,
                                      max_plane_bytes=budget)
    got_s, got_r = colbert.full_ranking(q, p, topk=topk, q_batch=2,
                                        p_chunk=4, max_plane_bytes=budget,
                                        device="cpu")
    assert got_r.dtype == np.int64 and got_r.shape == (5, min(topk, 41))
    np.testing.assert_array_equal(got_r, want_r)
    assert_scores_close(got_s, want_s)
    assert (np.diff(got_s, axis=1) <= 0).all()


@pytest.mark.parametrize("budget", [4 << 30, 10 * 9 * 8 * 2])
def test_full_ranking_ties_keep_the_lower_row(budget):
    """Repeated passages tie exactly; both packages rank the lower row
    first, on the resident and the slab routes (f16 planes)."""
    q = make_reps(8, 6, 4, dtype=np.float16)
    p = make_reps(9, 23, 9, dtype=np.float16)
    p = np.concatenate([p, p[:10]])
    want_s, want_r = ref.full_ranking(q, p, topk=33, q_batch=4, p_chunk=8,
                                      max_plane_bytes=budget)
    got_s, got_r = colbert.full_ranking(q, p, topk=33, q_batch=4, p_chunk=8,
                                        max_plane_bytes=budget, device="cpu")
    np.testing.assert_array_equal(got_r, want_r)
    assert_scores_close(got_s, want_s)
    for row in got_r:  # each repeat right after its original
        pos = {r: i for i, r in enumerate(row.tolist())}
        assert all(pos[r] + 1 == pos[r + 23] for r in range(10))


# ------------------------------------------------------------------ verb --


def write_reps(path, reps, ids):
    np.savez(path, token=reps)
    with open(str(path) + ".ids.json", "w") as f:
        json.dump(ids, f)


@pytest.fixture
def reps_world(tmp_path):
    q, p = make_reps(10, 4, 5), make_reps(11, 13, 9)
    qids, pids = [f"q{i}" for i in range(4)], [f"d{i}" for i in range(13)]
    write_reps(tmp_path / "q.npz", q, qids)
    write_reps(tmp_path / "p.npz", p, pids)
    with open(tmp_path / "pairs.tsv", "w") as f:
        for i in range(4):
            for j in range(0, 13, 2):
                f.write(f"q{i}\td{(j + i) % 13}\n")
    return tmp_path, ["colbert-score", "--query-reps", str(tmp_path / "q.npz"),
                      "--passage-reps", str(tmp_path / "p.npz")]


def read_rows(path):
    return [line.split() for line in open(path).read().splitlines()]


def assert_same_rows(got, want, score_col):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:score_col] + g[score_col + 1:] == \
            w[:score_col] + w[score_col + 1:]
    s = np.asarray([float(r[score_col]) for r in got], np.float32)
    assert_scores_close(s, [float(r[score_col]) for r in want])


@pytest.mark.parametrize("form", ["tsv", "trec", "full_ranking"])
def test_colbert_score_verb_matches_reference(reps_world, form):
    d, base = reps_world
    extra = {"tsv": ["--pairs", str(d / "pairs.tsv"), "--batch-size", "5"],
             "trec": ["--pairs", str(d / "pairs.tsv"), "--trec"],
             "full_ranking": ["--full-ranking", "--topk", "6",
                              "--query-batch", "3", "--passage-chunk", "4",
                              "--plane-budget-gb", str(5 * 9 * 8 * 4 / 2**30)],
             }[form]
    jax_main(base + extra + ["--output", str(d / "want")])
    main(base + extra + ["--output", str(d / "got"), "--device", "cpu"])
    got, want = read_rows(d / "got"), read_rows(d / "want")
    assert len(got) == (24 if form == "full_ranking" else 28)
    assert_same_rows(got, want, 2 if form == "tsv" else 4)


def test_colbert_score_verb_refuses_pairs_with_full_ranking(reps_world):
    d, base = reps_world
    with pytest.raises(SystemExit, match="--pairs conflicts"):
        main(base + ["--full-ranking", "--pairs", str(d / "pairs.tsv"),
                     "--output", str(d / "run.trec"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --pairs or --full-ranking"):
        main(base + ["--output", str(d / "run.trec"), "--device", "cpu"])
    assert not (d / "run.trec").exists()


def test_port_verb_scores_reps_encoded_by_the_reference(tmp_path):
    """dhr_tpu's ``encode --model colbert`` (an HF checkpoint it exported)
    writes the reps; the port's verb scores them as the reference's does."""
    from dhr_tpu.train.checkpoint import export_hf_checkpoint
    from tests.test_torch_encode import encode_batches, token_lists
    from tests.test_torch_models import CASES, configs, flax_tree

    jcfg, _ = configs(dict(CASES["colbert"], add_pooler=True))
    b = encode_batches(20, 4, 12, 4)[0]
    ckpt = str(tmp_path / "ckpt")
    export_hf_checkpoint(ckpt, flax_tree(jcfg, b["input_ids"],
                                         b["attention_mask"], 20), jcfg)
    for name, seed, n, hi in (("corpus", 21, 9, 20), ("queries", 22, 3, 8)):
        with open(tmp_path / f"{name}.jsonl", "w") as f:
            for i, t in enumerate(token_lists(seed, n, 1, hi)):
                f.write(json.dumps({"text_id": f"{name[0]}{i}",
                                    "text": t}) + "\n")
    common = ["--model", "colbert", "--model-name-or-path", ckpt,
              "--add-pooler", "--projection-dim", "16", "--cls-token-id",
              "1", "--sep-token-id", "2", "--q-max-len", "8",
              "--p-max-len", "12", "--batch-size", "4"]
    jax_main(["encode", *common, "--input", str(tmp_path / "corpus.jsonl"),
              "--output", str(tmp_path / "p_reps")])
    jax_main(["encode", *common, "--encode-is-qry", "--input",
              str(tmp_path / "queries.jsonl"), "--output",
              str(tmp_path / "q_reps")])
    base = ["colbert-score", "--query-reps", str(tmp_path / "q_reps"),
            "--passage-reps", str(tmp_path / "p_reps"), "--full-ranking",
            "--topk", "5"]
    jax_main(base + ["--output", str(tmp_path / "want.trec")])
    main(base + ["--output", str(tmp_path / "got.trec"), "--device", "cpu"])
    got, want = read_rows(tmp_path / "got.trec"), read_rows(
        tmp_path / "want.trec")
    assert len(got) == 15
    assert_same_rows(got, want, 4)
