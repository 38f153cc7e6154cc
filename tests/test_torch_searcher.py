"""The port's Searcher against dhr_tpu's Searcher on one index.

16,384 rows, lex=64, cls=16, int8 value planes (the bench layout), the same
numpy-made corpus and queries under both.  Rankings must agree except at
exact score ties.  The fixture keeps stage-1 ties at the candidate pool's
edge rare (3 folds, ~19 query dims above theta, dense int8 values): with
sparser data many rows share one stage-1 score, the two packages keep
different tied rows in the pool, and the reranked top-k can then differ
beyond ties of the final scores.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dhr_tpu.retrieval import DeviceIndex as JaxDeviceIndex
from dhr_tpu.retrieval import PackedIndex as JaxPacked
from dhr_tpu.retrieval import SearchConfig as JaxConfig
from dhr_tpu.retrieval import Searcher as JaxSearcher
from dhr_tpu.retrieval import write_run as jax_write_run
from dhr_tpu_torch.ops.partial_gip import partial_gip
from dhr_tpu_torch.ops.rerank_gip import rerank_gip
from dhr_tpu_torch.retrieval import (
    DeviceIndex,
    PackedIndex,
    SearchConfig,
    Searcher,
    write_run,
)
from dhr_tpu_torch.retrieval.searcher import _pick_slices

N, LEX, CLS, FOLDS, B = 16384, 64, 16, 3, 40
AGIP, TOPK = 1024, 100


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    e = rng.exponential(size=(N, LEX))
    lex = np.where(rng.random((N, LEX)) < 0.3, 0.1 + 0.35 * e, 0.05 * e)
    values = np.concatenate(
        [lex, 0.3 * rng.standard_normal((N, CLS))], 1).astype(np.float16)
    folds = rng.integers(0, FOLDS, (N, LEX)).astype(np.uint8)
    docids = np.asarray([f"p{i}" for i in range(N)], dtype=object)
    packed = JaxPacked(values, folds, docids, LEX).quantize()
    eq = rng.exponential(size=(B, LEX))
    qlex = np.where(rng.random((B, LEX)) < 0.3, 0.2 + 0.3 * eq, 0.01 * eq)
    qv = np.concatenate([qlex, 0.3 * rng.standard_normal((B, CLS))],
                        1).astype(np.float32)
    qi = rng.integers(0, FOLDS, (B, LEX)).astype(np.int32)
    jidx = JaxDeviceIndex.from_packed(packed)
    tidx = DeviceIndex.from_packed(PackedIndex(**vars(packed)), device="cpu")
    return jidx, tidx, qv, qi


def _assert_rankings_equal(s_got, r_got, s_want, r_want):
    """Scores close; rows equal wherever the score is not tied (within a
    few ulps) with another score of the list or with the cut-off."""
    np.testing.assert_allclose(s_got, s_want, rtol=1e-5, atol=1e-5)
    for i in range(s_want.shape[0]):
        s = s_want[i]
        tol = 1e-5 * max(np.abs(s).max(), 1.0)
        gaps = np.abs(s[:, None] - s[None, :]) <= tol
        tied = gaps.sum(1) > 1
        tied |= np.abs(s - s[-1]) <= tol
        np.testing.assert_array_equal(r_got[i][~tied], r_want[i][~tied])
        assert set(r_got[i][~tied]) == set(r_want[i][~tied])


def _both(world, **cfg):
    jidx, tidx, qv, qi = world
    jax_s, jax_r = JaxSearcher(jidx, JaxConfig(**cfg)).search(qv, qi)
    searcher = Searcher(tidx, SearchConfig(**cfg), device="cpu")
    got_s, got_r = searcher.search(qv, qi)
    assert got_s.dtype == np.float32 and got_r.dtype == np.int64
    assert searcher.last_timing["queries"] == B
    return (got_s, got_r), (np.asarray(jax_s), np.asarray(jax_r))


def test_fixture_reaches_stratified_slices():
    assert _pick_slices("auto", N, AGIP) == 16


def test_brute_force_theta0(world):
    got, want = _both(world, theta=0.0, topk=TOPK, query_batch=16)
    _assert_rankings_equal(*got, *want)


@pytest.mark.parametrize("approx", [True, False])
def test_theta_rerank(world, approx):
    got, want = _both(world, theta=0.3, rerank=True, agip_topk=AGIP,
                      topk=TOPK, max_important_dims=24, query_batch=16,
                      approx_candidates=approx, candidate_bf16=False)
    _assert_rankings_equal(*got, *want)


def test_theta_rerank_bf16_candidates_final_ranking(world):
    """bf16 stage-1 scores change only the pool's edge; the exact f32
    rerank keeps the final top-k equal to the f32-candidate search."""
    jidx, tidx, qv, qi = world
    cfg = SearchConfig(theta=0.3, rerank=True, agip_topk=AGIP, topk=TOPK,
                       max_important_dims=24, query_batch=16)
    before = (partial_gip.launches, rerank_gip.launches)
    s16, r16 = Searcher(tidx, cfg, device="cpu").search(qv, qi)
    s32, r32 = Searcher(tidx, dataclasses.replace(cfg, candidate_bf16=False),
                        device="cpu").search(qv, qi)
    overlap = np.mean([len(set(a) & set(b)) / TOPK for a, b in zip(r16, r32)])
    assert overlap >= 0.99
    assert (partial_gip.launches, rerank_gip.launches) == before


def test_trec_run_matches_reference(world, tmp_path):
    jidx, tidx, qv, qi = world
    cfg = dict(theta=0.3, rerank=True, agip_topk=AGIP, topk=TOPK,
               max_important_dims=24, query_batch=16, candidate_bf16=False)
    qids = [f"q{i}" for i in range(B)]
    jr, js = JaxSearcher(jidx, JaxConfig(**cfg)).search_run(qids, qv, qi)
    tr, ts = Searcher(tidx, SearchConfig(**cfg),
                      device="cpu").search_run(qids, qv, qi)
    jax_write_run(str(tmp_path / "jax.trec"), jr, js)
    write_run(str(tmp_path / "torch.trec"), tr, ts)
    want = (tmp_path / "jax.trec").read_text().splitlines()
    got = (tmp_path / "torch.trec").read_text().splitlines()
    assert len(got) == len(want) == B * TOPK
    by_q = {}
    for g, w in zip(got, want):
        gq, g0, gd, grank, gs, gname = g.split()
        wq, w0, wd, wrank, ws, wname = w.split()
        assert (gq, g0, grank, gname) == (wq, w0, wrank, wname)
        assert abs(float(gs) - float(ws)) <= 1e-5 * max(abs(float(ws)), 1)
        by_q.setdefault(gq, []).append((gd, wd, float(ws)))
    for rows in by_q.values():
        scores = np.array([s for _, _, s in rows], np.float32)
        _assert_rankings_equal(
            scores[None], np.array([[int(g[1:]) for g, _, _ in rows]]),
            scores[None], np.array([[int(w[1:]) for _, w, _ in rows]]))


def test_unported_modes_raise(world):
    """Every mode of the reference is ported: each builds without
    NotImplementedError; an unknown mode, a mode the index cannot serve or
    a foreign device still raises."""
    _, tidx, _, _ = world
    for cfg in (SearchConfig(mode="ip"),
                SearchConfig(fused_candidates=True, rerank=True),
                SearchConfig(rerank=True, escalate_pool=200, topk=100),
                SearchConfig(mode="ip", row_chunk=4096)):
        Searcher(tidx, cfg, device="cpu")
    for cfg in (SearchConfig(mode="pq"), SearchConfig(mode="splade")):
        with pytest.raises(ValueError):
            Searcher(tidx, cfg, device="cpu")
    with pytest.raises(ValueError):
        Searcher(tidx, SearchConfig(), device=torch.device("meta"))
