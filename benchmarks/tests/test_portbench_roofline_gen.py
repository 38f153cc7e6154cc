"""The FLOP and byte counters against hand counts, and the frozen generators
repeating bit for bit for a seed."""

from __future__ import annotations

import numpy as np
import torch

import benchmarks.tests.portbench_util  # noqa: F401  (the checkout's root)
from benchmarks import roofline
from benchmarks.gen import tokens
from benchmarks.gen.synth import synth_index_planes, synth_reps
from benchmarks.gen.weights import make_weights


def test_used_dims_and_candidate_bytes_by_hand():
    qv = np.array([[0.5, 0.2, 0.9, 0.4], [0.31, 0.8, 0.1, 0.0]], np.float32)
    scales = np.array([1.0, 1.0, 0.1, 1.0], np.float32)
    dims = roofline.used_dims(qv, scales, theta=0.3, max_dims=2)
    # query 0: above 0.3 are dims 0 (.5), 2 (.09 folded), 3 (.4): top 2 = 0, 3
    assert [d.tolist() for d in dims] == [[0, 3], [1, 0]]
    # one batch of both: union {0, 1, 3}, lexical dims < 3: {0, 1}
    got = roofline.candidates_bytes(dims, batch=2, n_rows=10, lex_dim=3,
                                    pool=4)
    assert got == [10 * (3 * 1 + 2 * 1) + 2 * 4 * (2 + 8)]
    assert roofline.rerank_bytes(3, 2, pool=4, dim=4, lex_dim=3, topk=2) == [
        2 * 4 * (8 + 4 + 3) + 2 * 2 * 12, 1 * 4 * (8 + 4 + 3) + 1 * 2 * 12]


def test_tower_flops_by_hand():
    d = {"hidden": 2, "ffn": 3, "vocab": 5, "layers": 1, "proj": 1}
    # per token 2 * (4*4 + 2*2*3) = 56; attention 2*2*1*2*n^2 = 8 n^2;
    # head (n - 1) * 2 * (4 + 10 + 2) = 32 (n - 1); projection 2 * 2 * 1
    n = 3
    want = 56 * n + 8 * n * n + 32 * (n - 1) + 4
    assert roofline.tower_flops([n], d) == want
    assert roofline.train_step_flops([n], [n, n], d) == 3 * 3 * want


def test_synth_repeats_bit_for_bit():
    a = synth_index_planes(2**35 + 7, 3000, chunk_rows=1024, device="cpu")
    b = synth_index_planes(2**35 + 7, 3000, chunk_rows=1024, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = synth_index_planes(2**35 + 8, 3000, chunk_rows=1024, device="cpu")
    assert not torch.equal(a[0], c[0])
    q1 = synth_reps(11, 16, role="query", device="cpu")
    q2 = synth_reps(11, 16, role="query", device="cpu")
    assert torch.equal(q1[0], q2[0]) and torch.equal(q1[1], q2[1])


def test_token_and_weight_generators_repeat():
    spec = {"mean": 75, "sigma": 0.45, "min": 8, "max": 126}
    t1, l1 = tokens.token_lists(spec, 500, tokens.rng(2**40, 1))
    t2, l2 = tokens.token_lists(spec, 500, tokens.rng(2**40, 1))
    assert np.array_equal(l1, l2)
    assert all(np.array_equal(a, b) for a, b in zip(t1, t2))
    assert l1.min() >= 8 and l1.max() <= 126 and 60 < l1.mean() < 90
    assert min(int(t.min()) for t in t1) >= tokens.CONTENT_ID_LO
    assert max(int(t.max()) for t in t1) < tokens.VOCAB
    q = tokens.text_queries({"mean": 6, "sigma": 0.4, "min": 1, "max": 20},
                            50, tokens.rng(3))
    assert q == tokens.text_queries(
        {"mean": 6, "sigma": 0.4, "min": 1, "max": 20}, 50, tokens.rng(3))
    tok = tokens.HashingTokenizer()
    ids = tok.encode(q[0], max_length=3, truncation=True)
    assert ids == tok.encode(q[0].upper(), max_length=3, truncation=True)
    assert len(ids) <= 3
    cfg = {"model": {"num_hidden_layers": 1, "hidden_size": 8,
                     "num_attention_heads": 2, "intermediate_size": 16,
                     "vocab_size": 20, "max_position_embeddings": 8,
                     "layer_norm_eps": 1e-12, "initializer_range": 0.02},
           "head": {"projection_dim": 4}}
    w1, w2 = make_weights(cfg, 2**33, "cpu"), make_weights(cfg, 2**33, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["l0.q.w"], make_weights(cfg, 5, "cpu")["l0.q.w"])
