"""Row-sharded search over gloo ranks on the CPU.

Each scenario's index is sharded over 2 and 4 ranks (1-D ``index`` mesh)
and over a hybrid ``(host, index)`` 2 x 2 mesh (``num_hosts=2``); the ranks
search the same queries and must return the same results as the port's
one-process search (ids exact up to ties, f32 scores to rtol 1e-6) and as
``dhr_tpu``'s search sharded over its 8-device CPU mesh.  The corpora
follow tests/test_torch_searcher.py (dense exponential values, 3 folds) so
that stage-1 ties at the pool's edge stay rare.  N = 1,021 is prime: every
shard count pads rows, and no pad row may reach a run.
"""

import dataclasses

import numpy as np
import pytest

from dhr_tpu.parallel import make_mesh as jax_make_mesh
from dhr_tpu.retrieval import DeviceIndex as JaxDeviceIndex
from dhr_tpu.retrieval import PackedIndex as JaxPacked
from dhr_tpu.retrieval import SearchConfig as JaxConfig
from dhr_tpu.retrieval import Searcher as JaxSearcher
from dhr_tpu_torch.retrieval import (
    DeviceIndex, PackedIndex, SearchConfig, Searcher)
from torch_parallel_util import run_ranks

LEX, CLS, FOLDS, B = 24, 8, 3, 8


def _corpus(n, seed, neg_cls=False):
    rng = np.random.default_rng(seed)
    e = rng.exponential(size=(n, LEX))
    lex = np.where(rng.random((n, LEX)) < 0.3, 0.1 + 0.35 * e, 0.05 * e)
    values = np.concatenate(
        [lex, 0.3 * rng.standard_normal((n, CLS))], 1).astype(np.float16)
    folds = rng.integers(0, FOLDS, (n, LEX)).astype(np.uint8)
    docids = np.asarray([f"p{i}" for i in range(n)], dtype=object)
    eq = rng.exponential(size=(B, LEX))
    qlex = np.where(rng.random((B, LEX)) < 0.3, 0.2 + 0.3 * eq, 0.01 * eq)
    qcls = 0.3 * rng.standard_normal((B, CLS))
    if neg_cls:  # lexical scores near zero, CLS scores of both signs
        qlex = 0.0 * qlex
        qcls = 3.0 * qcls
    qv = np.concatenate([qlex, qcls], 1).astype(np.float32)
    qi = rng.integers(0, FOLDS, (B, LEX)).astype(np.int32)
    return dict(values=values, indices=folds, docids=docids,
                lex_dim=LEX), qv, qi


def _pq(packed):
    p = PackedIndex(**packed).quantize_pq(m=4, iters=5, device="cpu")
    return dict(packed, pq_codes=p.pq_codes, pq_centroids=p.pq_centroids)


def _int8(packed):
    p = PackedIndex(**packed).quantize()
    return dict(packed, values=p.values, value_scales=p.value_scales)


RERANK = dict(theta=0.3, rerank=True, agip_topk=64, topk=10,
              max_important_dims=16, query_batch=4, candidate_bf16=False,
              approx_candidates=False)

# name -> (corpus rows, corpus seed, transform, layout, config, dhr_tpu
# extra config); each runs on every mesh
SCENARIOS = {
    "gip_exact": (1021, 1, None, "both", RERANK, {}),
    "gip_brute": (1021, 2, None, "dim",
                  dict(theta=0.0, topk=10, query_batch=4), {}),
    "fused_k3": (2048, 3, None, "both",
                 dict(RERANK, agip_topk=128, fused_candidates=True,
                      candidate_block=2),
                 dict(use_pallas=True, pallas_interpret=True,
                      pallas_n_tile=256)),
    "ip_dim_major": (1021, 4, None, "both",
                     dict(mode="ip", topk=10, query_batch=4), {}),
    "ip_row_chunked": (1021, 5, None, "row",
                       dict(mode="ip", rerank=True, agip_topk=64, topk=10,
                            row_chunk=100, approx_candidates=False,
                            candidate_bf16=False, query_batch=4), {}),
    "pq": (1021, 6, _pq, "row",
           dict(mode="pq", rerank=True, agip_topk=64, topk=10,
                approx_candidates=False, candidate_bf16=False,
                query_batch=4), {}),
    "int8": (1021, 7, _int8, "both", RERANK, {}),
    "escalation": (1021, 8, None, "both",
                   dict(RERANK, topk=10, escalate_pool=20,
                        escalate_margin=0.3), {}),
    "pad_rows": (1021, 9, None, "dim",
                 dict(theta=0.0, topk=1021, query_batch=4), {}),
}
MESHES = [(2, "index"), (4, "index"), (4, "hybrid")]


def _inputs():
    out = {}
    for name, (n, seed, tf, layout, cfg, _) in SCENARIOS.items():
        packed, qv, qi = _corpus(n, seed, neg_cls=name == "pad_rows")
        if tf is not None:
            packed = tf(packed)
        out[name] = dict(packed=packed, qv=qv, qi=qi, layout=layout, cfg=cfg,
                         qids=[f"q{i}" for i in range(B)],
                         calibrate=name == "escalation")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario once per mesh: {(world, mesh): [rank results]}."""
    tmp = tmp_path_factory.mktemp("psearch")
    inp = _inputs()
    out = {}
    for world in (2, 4):
        scen = {}
        for w, mesh in MESHES:
            if w == world:
                scen.update({f"{k}@{mesh}": dict(v, mesh=mesh)
                             for k, v in inp.items()})
        res = run_ranks("search", world, {"scenarios": scen}, tmp)
        for w, mesh in MESHES:
            if w == world:
                out[(w, mesh)] = [{k.split("@")[0]: v for k, v in r.items()
                                   if k.endswith("@" + mesh)} for r in res]
    return inp, out


def _one_process(sc):
    idx = DeviceIndex.from_packed(PackedIndex(**sc["packed"]),
                                  layout=sc["layout"], device="cpu")
    s = Searcher(idx, SearchConfig(**sc["cfg"]), device="cpu")
    return s.search(sc["qv"], sc["qi"]), s


def _dhr_tpu_sharded(name, sc, eight_devices):
    extra = SCENARIOS[name][5]
    cfg = JaxConfig(**sc["cfg"], **extra)
    idx = JaxDeviceIndex.from_packed(
        JaxPacked(**sc["packed"]),
        mesh=jax_make_mesh(eight_devices, axis="index"),
        layout=sc["layout"])
    s, r = JaxSearcher(idx, cfg).search(sc["qv"], sc["qi"])
    return np.asarray(s), np.asarray(r)


def _assert_rankings_equal(s_got, r_got, s_want, r_want, rtol=1e-6):
    """Scores to rtol; rows equal wherever the score is not tied (within
    rtol) with another score of the list."""
    np.testing.assert_allclose(s_got, s_want, rtol=rtol, atol=rtol)
    for i in range(s_want.shape[0]):
        s = s_want[i]
        tol = rtol * max(np.abs(s).max(), 1.0)
        tied = (np.abs(s[:, None] - s[None, :]) <= tol).sum(1) > 1
        np.testing.assert_array_equal(r_got[i][~tied], r_want[i][~tied])


CASES = [n for n in SCENARIOS if n != "pad_rows"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_one_process(runs, name, mesh):
    inp, out = runs
    (want_s, want_r), single = _one_process(inp[name])
    ranks = out[mesh]
    for r, res in enumerate(ranks):
        _assert_rankings_equal(res[name]["scores"], res[name]["rows"],
                               want_s, want_r)
        # every rank returns the same results
        np.testing.assert_array_equal(res[name]["rows"],
                                      ranks[0][name]["rows"])
        assert res[name]["timing_shards"] == mesh[0]
    if name == "escalation":
        assert 0 < single.escalated_queries < B
        assert ranks[0][name]["escalated"] == single.escalated_queries
        assert ranks[0][name]["pool_overlap"][64] == 1.0


@pytest.mark.parametrize("name", CASES)
def test_sharded_equals_dhr_tpu_sharded(runs, name, eight_devices):
    inp, out = runs
    want_s, want_r = _dhr_tpu_sharded(name, inp[name], eight_devices)
    for mesh in MESHES:
        got = out[mesh][0][name]
        _assert_rankings_equal(got["scores"], got["rows"], want_s, want_r)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_rank_holds_only_its_padded_rows(runs, mesh):
    _, out = runs
    world = mesh[0]
    per = -(-1021 // world)
    for r, res in enumerate(out[mesh]):
        got = res["gip_exact"]
        assert got["shape"] == (per, LEX + CLS)
        assert got["offset"] == r * per
        want_axes = ("host", "index") if mesh[1] == "hybrid" else ("index",)
        assert tuple(got["axes"]) == want_axes


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_pad_rows_never_reach_a_run(runs, mesh):
    """Pad rows are zero rows: search() can return them (score 0, as the
    reference's), search_run drops them; before the first pad row the
    ranking is the one-process ranking."""
    inp, out = runs
    sc = inp["pad_rows"]
    (want_s, want_r), _ = _one_process(sc)
    got = out[mesh][0]["pad_rows"]
    pad = got["rows"] >= 1021
    if mesh[0] > 1 and 1021 % mesh[0]:
        assert pad.any()   # the fixture does reach the pad rows
    np.testing.assert_array_equal(got["scores"][pad], 0.0)
    results, _ = got["run"]
    for i in range(B):
        docs = results[f"q{i}"]
        assert len(docs) == int((~pad[i]).sum())
        assert all(int(d[1:]) < 1021 for d in docs)
        first = int(np.argmax(pad[i])) if pad[i].any() else len(pad[i])
        _assert_rankings_equal(got["scores"][i:i + 1, :first],
                               got["rows"][i:i + 1, :first],
                               want_s[i:i + 1, :first],
                               want_r[i:i + 1, :first])


@pytest.fixture(scope="module")
def refused_reload(tmp_path_factory):
    """A two-rank service whose follower fails to load one index."""
    first, qv, qi = _corpus(301, 10)
    second, _, _ = _corpus(201, 11)
    cfg = dict(RERANK, agip_topk=40)
    inp = dict(packed={"first": first, "second": second}, qv=qv, qi=qi,
               qids=[f"q{i}" for i in range(B)], cfg=cfg)
    got = run_ranks("serve_reload", 2, inp,
                    tmp_path_factory.mktemp("preload"), timeout=180)[0]
    return inp, got


def _same_run(got, packed, inp):
    """``got`` equals the one-process ``search_run`` over ``packed``."""
    idx = DeviceIndex.from_packed(PackedIndex(**packed), device="cpu")
    s = Searcher(idx, SearchConfig(**inp["cfg"]), device="cpu")
    results, scores = s.search_run(inp["qids"], inp["qv"], inp["qi"])
    assert got["results"] == results
    for q, w in scores.items():
        np.testing.assert_allclose(got["scores"][q], w, rtol=1e-6)


@pytest.mark.parametrize("free_first", [False, True])
def test_reload_failing_on_a_follower_is_refused(refused_reload, free_first):
    inp, got = refused_reload
    assert "failed on another rank" in got[f"bad_free{free_first}"]
    if free_first:  # the old index was dropped first: drain mode
        assert "no index loaded" in got["search_freeTrue"]
    else:  # the old index serves on, every rank still in step
        _same_run(got["before"], inp["packed"]["first"], inp)
        _same_run(got["search_freeFalse"], inp["packed"]["first"], inp)


def test_sharded_service_recovers_after_a_refused_reload(refused_reload):
    inp, got = refused_reload
    assert got["good"]["rows"] == 201
    _same_run(got["after"], inp["packed"]["second"], inp)


def test_from_arrays_rows_must_match_num_rows():
    # num_rows names the global count: without a mesh the arrays must
    # hold exactly that many rows
    packed, _, _ = _corpus(12, 12)
    idx = DeviceIndex.from_arrays(packed["values"], packed["indices"],
                                  packed["docids"], LEX, device="cpu",
                                  num_rows=12)
    assert idx.num_rows == 12
    with pytest.raises(ValueError, match="holds 13"):
        DeviceIndex.from_arrays(packed["values"], packed["indices"],
                                packed["docids"], LEX, device="cpu",
                                num_rows=13)
