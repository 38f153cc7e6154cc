"""The port's search modes against dhr_tpu's on the same numpy inputs:
fused candidates (K3), ip over dim- and row-major planes, row-chunked ip,
pq, two-tier escalation and pool calibration, plus the theta-in-ip repair.

Rankings must agree except at exact score ties (``_assert_rankings_equal``,
scores to 1e-5).  Parity fixtures keep stage-1 scores in f32
(``candidate_bf16=False``): the reference's CPU scan ignores that flag, so
bf16 candidates would change the pool's edge on one side only.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dhr_tpu.ops import pq as jpq
from dhr_tpu.retrieval import DeviceIndex as JaxDeviceIndex
from dhr_tpu.retrieval import PackedIndex as JaxPacked
from dhr_tpu.retrieval import SearchConfig as JaxConfig
from dhr_tpu.retrieval import Searcher as JaxSearcher
from dhr_tpu.retrieval import calibrate_pool as jax_calibrate_pool
from dhr_tpu_torch.ops import pq as tpq
from dhr_tpu_torch.ops.gip_candidates import gip_candidates
from dhr_tpu_torch.ops.partial_gip import partial_gip
from dhr_tpu_torch.retrieval import (
    DeviceIndex,
    PackedIndex,
    SearchConfig,
    Searcher,
    calibrate_pool,
)
from dhr_tpu_torch.retrieval.searcher import _pick_row_chunks, _row_chunk_split

from tests.test_retrieval import build_corpus, build_queries
from tests.test_torch_searcher import _assert_rankings_equal


def _port_index(packed, **kw):
    return DeviceIndex.from_packed(PackedIndex(**vars(packed)), device="cpu",
                                   **kw)


def _both(packed, qv, qi, layout="both", value_dtype=None, jax_extra=None,
          **cfg):
    jdt = None if value_dtype is None else {
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[value_dtype]
    jidx = JaxDeviceIndex.from_packed(packed, layout=layout, value_dtype=jdt)
    js, jr = JaxSearcher(jidx, JaxConfig(**cfg, **(jax_extra or {}))
                         ).search(qv, qi)
    searcher = Searcher(_port_index(packed, layout=layout,
                                    value_dtype=value_dtype),
                        SearchConfig(**cfg), device="cpu")
    s, r = searcher.search(qv, qi)
    return (s, r), (np.asarray(js), np.asarray(jr)), searcher


# -- theta in ip / pq mode (repair) -------------------------------------------


@pytest.mark.parametrize("mode", ["ip", "gip"])
def test_theta_applies_in_gip_mode_only(rng, mode):
    """ip mode runs the full inner product: theta leaves its stage-1 query
    alone in both packages; gip mode thresholds it."""
    packed = build_corpus(rng, N=64).quantize()
    qv, qi = build_queries(rng, B=5)
    cfg = dict(mode=mode, theta=0.3, topk=8)
    jax_s = JaxSearcher(JaxDeviceIndex.from_packed(packed), JaxConfig(**cfg))
    want = jax_s.prepare_queries(qv, qi)
    want_dev = jax_s._prep(jnp.asarray(qv), jnp.asarray(qi))
    got = Searcher(_port_index(packed), SearchConfig(**cfg),
                   device="cpu").prepare_queries(qv, qi)
    for g, w, wd in zip(got, want, want_dev):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wd))
    raw = qv * np.asarray(packed.value_scales)[None, :]
    thresholded = (got[1].numpy() != raw).any()
    assert thresholded == (mode == "gip")


# -- fused candidates (K3) ----------------------------------------------------


def _fused_world(rng, N):
    lex, cls = 24, 8
    values = (rng.random((N, lex + cls)) + 0.05).astype(np.float16)
    indices = rng.integers(0, 6, (N, lex)).astype(np.uint8)
    docids = np.asarray([f"d{i}" for i in range(N)], dtype=object)
    packed = JaxPacked(values, indices, docids, lex_dim=lex)
    return packed, values[:8].astype(np.float32), indices[:8].astype(np.int32)


@pytest.mark.parametrize("G", [2, 8])
@pytest.mark.parametrize("approx", [False, True])
def test_fused_search_matches_reference(rng, G, approx):
    N = 4096
    packed, qv, qi = _fused_world(rng, N)
    cfg = dict(topk=10, mode="gip", theta=0.1, rerank=True, agip_topk=256,
               query_batch=8, fused_candidates=True, candidate_block=G,
               approx_candidates=approx,
               candidate_slices=4 if approx else "auto")
    jax_extra = dict(use_pallas=True, pallas_interpret=True,
                     pallas_n_tile=1024, candidate_recall=0.99)
    before = gip_candidates.launches, partial_gip.launches
    got, want, searcher = _both(packed, qv, qi, jax_extra=jax_extra, **cfg)
    assert searcher._fused and searcher._packed_ids
    assert (gip_candidates.launches, partial_gip.launches) == before
    _assert_rankings_equal(got[0][:, :10], got[1][:, :10],
                           want[0][:, :10], want[1][:, :10])


def test_fused_two_plane_g3_matches_reference(rng):
    """G = 3: no packed ids; the row plane is gathered (bf16 scores)."""
    packed, qv, qi = _fused_world(rng, 3072)
    cfg = dict(topk=10, mode="gip", theta=0.1, rerank=True, agip_topk=256,
               query_batch=8, fused_candidates=True, candidate_block=3,
               approx_candidates=False)
    got, want, searcher = _both(
        packed, qv, qi, jax_extra=dict(use_pallas=True, pallas_interpret=True,
                                       pallas_n_tile=768), **cfg)
    assert searcher._fused and not searcher._packed_ids
    _assert_rankings_equal(*got, *want)


def test_fused_rules_follow_the_reference(rng):
    packed, _, _ = _fused_world(rng, 1024)
    idx = _port_index(packed)

    def fused(**kw):
        base = dict(rerank=True, agip_topk=64, fused_candidates=True)
        base.update(kw)
        return Searcher(idx, SearchConfig(**base), device="cpu")._fused

    assert fused()
    assert not fused(rerank=False)                       # needs rerank
    assert not fused(candidate_block=1)                  # needs G > 1
    assert not fused(mode="ip")                          # needs gip planes
    assert not fused(agip_topk=200)                      # 1024 // 8 < 200
    assert fused(fused_candidates="auto")                # 128 >= 2 * 64
    assert not fused(fused_candidates="auto", agip_topk=65)
    assert not fused(fused_candidates="auto", approx_candidates=False)
    assert fused(approx_candidates=False)                # explicit True


# -- ip mode ------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["both", "row"])
@pytest.mark.parametrize("rerank", [False, True])
def test_ip_mode_f32_planes(rng, layout, rerank):
    """ip over the dim-major (layout both) and row-major (row) planes."""
    packed = build_corpus(rng, N=300)
    qv, qi = build_queries(rng, B=9)
    got, want, _ = _both(packed, qv, qi, layout=layout,
                         value_dtype=torch.float32, mode="ip", topk=12,
                         rerank=rerank, agip_topk=60, query_batch=4,
                         candidate_bf16=False, approx_candidates=False)
    _assert_rankings_equal(*got, *want)


def test_ip_mode_bf16_planes_and_dense_index(rng):
    """bf16 planes multiply as bf16 x bf16 -> f32 like the reference; a
    dense index (no fold planes) searches by inner product in gip mode."""
    packed = build_corpus(rng, N=300)
    qv, qi = build_queries(rng, B=6)
    got, want, _ = _both(packed, qv, qi, mode="ip", topk=12, query_batch=6)
    _assert_rankings_equal(*got, *want)
    dense = JaxPacked(packed.values, None, packed.docids,
                      lex_dim=packed.dim)
    got, want, s = _both(dense, qv, None, layout="row", topk=12,
                         query_batch=6)
    assert not s._has_gip
    _assert_rankings_equal(*got, *want)


@pytest.mark.parametrize("row_major", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_ip_scores_blocked_equals_one_product(rng, monkeypatch, row_major,
                                              dtype):
    """Non-f32 planes multiply block by block (bf16 x bf16 -> f32); with
    dyadic queries and small integer values every sum is exact, so the
    blocks, including a ragged last one, must give the one product's
    numbers bit for bit."""
    from dhr_tpu_torch.retrieval import searcher as port_searcher

    monkeypatch.setattr(port_searcher, "_IP_BLOCK_ROWS", 7)
    n, d = 45, 24
    values = rng.integers(-127, 128, (n, d)).astype(np.int8)
    qv = rng.integers(-16, 17, (5, d)).astype(np.float32) / 8
    plane = torch.from_numpy(values if row_major else values.T.copy())
    got = port_searcher._ip_scores(torch.from_numpy(qv), plane.to(dtype),
                                   row_major=row_major)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  qv @ values.T.astype(np.float32))


def test_mode_validation_mirrors_reference(rng):
    packed = build_corpus(rng, N=64)
    with pytest.raises(ValueError, match="PQ-quantized"):
        Searcher(_port_index(packed), SearchConfig(mode="pq"), device="cpu")
    with pytest.raises(ValueError, match="layout='row'"):
        Searcher(_port_index(packed, layout="row"), SearchConfig(),
                 device="cpu")
    with pytest.raises(ValueError, match="layout='dim'"):
        Searcher(_port_index(packed, layout="dim"),
                 SearchConfig(rerank=True), device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        Searcher(_port_index(packed), SearchConfig(mode="bm25"), device="cpu")


# -- row-chunked ip -----------------------------------------------------------


def test_pick_row_chunks_matches_reference():
    from dhr_tpu.retrieval.searcher import _pick_row_chunks as jpick
    from dhr_tpu.retrieval.searcher import _row_chunk_split as jsplit

    for rc, n in [(0, 1_638_400), (0, 8_806_400), (0, 8_841_823),
                  (-1, 8_806_400), (64, 256), (100, 97), (50, 97),
                  (32, 97), (2500, 5000), (4, 23)]:
        assert _pick_row_chunks(rc, n) == jpick(rc, n)
        J = _pick_row_chunks(rc, n)
        assert _row_chunk_split(n, J) == jsplit(n, J)


@pytest.mark.parametrize("rerank", [False, True])
def test_row_chunked_ip_equals_unchunked_at_prime_rows(rng, rerank):
    N, lex, cls = 97, 12, 4
    values = rng.random((N, lex + cls)).astype(np.float32)
    indices = rng.integers(0, 5, (N, lex)).astype(np.uint8)
    packed = JaxPacked(values, indices,
                       np.asarray([f"d{i}" for i in range(N)], dtype=object),
                       lex_dim=lex)
    qv = rng.random((4, lex + cls)).astype(np.float32)
    qi = rng.integers(0, 5, (4, lex)).astype(np.int32)
    kw = dict(mode="ip", topk=7, rerank=rerank, agip_topk=32, query_batch=4,
              approx_candidates=False, candidate_bf16=False)
    idx = _port_index(JaxPacked(**vars(packed)), layout="row",
                      value_dtype=torch.float32)
    plain = Searcher(idx, SearchConfig(**kw, row_chunk=-1), device="cpu")
    chunked = Searcher(idx, SearchConfig(**kw, row_chunk=32), device="cpu")
    assert chunked._row_chunks == 4 and plain._row_chunks == 1
    sp, rp = plain.search(qv, qi)
    sc, rc = chunked.search(qv, qi)
    np.testing.assert_array_equal(rp, rc)
    np.testing.assert_array_equal(sp, sc)
    _, want, _ = _both(packed, qv, qi, layout="row",
                       value_dtype=torch.float32, row_chunk=32, **kw)
    _assert_rankings_equal(sc, rc, *want)


def test_row_chunked_exact_keeps_the_whole_tail(rng):
    """ADVICE r5 #1: with a target below sqrt(N) the tail (5 rows) is wider
    than a chunk (3 rows).  The reference keeps only a chunk's width of the
    tail and loses true top-k rows (known divergence, asserted as such);
    the port keeps min(k, part rows) per part and returns the exact
    top-k."""
    N, lex = 23, 4
    values = rng.random((N, lex)).astype(np.float32)
    values[18:] += 10.0                 # the tail rows are the best rows
    packed = JaxPacked(values, rng.integers(0, 3, (N, lex)).astype(np.uint8),
                       np.asarray([f"d{i}" for i in range(N)], dtype=object),
                       lex_dim=lex)
    qv = rng.random((2, lex)).astype(np.float32) + 0.1
    assert _row_chunk_split(N, _pick_row_chunks(4, N)) == (3, 18)
    kw = dict(mode="ip", topk=10, query_batch=2)
    exact = np.argsort(-(qv @ values.T), axis=1, kind="stable")[:, :10]
    idx = _port_index(JaxPacked(**vars(packed)), layout="row",
                      value_dtype=torch.float32)
    _, rows = Searcher(idx, SearchConfig(**kw, row_chunk=4),
                       device="cpu").search(qv)
    np.testing.assert_array_equal(rows, exact)
    jidx = JaxDeviceIndex.from_packed(packed, layout="row",
                                      value_dtype=jnp.float32)
    _, jrows = JaxSearcher(jidx, JaxConfig(**kw, row_chunk=4)).search(qv)
    missing = [set(e) - set(np.asarray(j)) for e, j in zip(exact, jrows)]
    assert all(len(m) == 2 for m in missing)   # the reference's loss


# -- pq -----------------------------------------------------------------------


def _pq_data(rng, n=512, m=4, d_sub=3, n_centers=32):
    centers = rng.standard_normal((m, n_centers, d_sub)).astype(np.float32)
    picks = rng.integers(0, n_centers, (m, n))
    sub = np.stack([centers[j, picks[j]] for j in range(m)], axis=1)
    return (sub + 0.01 * rng.standard_normal(sub.shape)).reshape(
        n, m * d_sub).astype(np.float32)


def test_pq_ops_equal_reference_given_centroids(rng):
    values = _pq_data(rng)
    m = 4
    codes, centroids = (np.array(x) for x in jpq.train_encode_pq_np(
        values, m, iters=5, seed=0))
    t_codes = tpq.encode_pq(torch.from_numpy(values),
                            torch.from_numpy(centroids))
    assert t_codes.dtype == torch.uint8
    np.testing.assert_array_equal(t_codes.numpy(), codes)
    np.testing.assert_array_equal(
        tpq.decode_pq(t_codes, torch.from_numpy(centroids)).numpy(),
        np.asarray(jpq.decode_pq(jnp.asarray(codes), jnp.asarray(centroids))))
    qv = rng.standard_normal((5, values.shape[1])).astype(np.float32)
    luts = np.asarray(jpq.pq_luts(jnp.asarray(qv), jnp.asarray(centroids)))
    np.testing.assert_allclose(
        tpq.pq_luts(torch.from_numpy(qv), torch.from_numpy(centroids)).numpy(),
        luts, rtol=1e-6, atol=1e-6)
    # the same tables give the same ADC numbers: bf16 entries bit for bit,
    # f32 gather to summation order
    t_luts = torch.from_numpy(luts)
    np.testing.assert_array_equal(
        tpq.pq_ip_scores(t_luts, t_codes).numpy(),
        np.asarray(jpq.pq_ip_scores(jnp.asarray(luts), jnp.asarray(codes))))
    np.testing.assert_allclose(
        tpq.pq_ip_scores_gather(t_luts, t_codes).numpy(),
        np.asarray(jpq.pq_ip_scores_gather(jnp.asarray(luts),
                                           jnp.asarray(codes))),
        rtol=1e-6, atol=1e-6)


def test_train_pq_equal_given_the_same_init_rows(rng):
    values = _pq_data(rng, n=600)
    m, seed = 4, 3
    want = np.asarray(jpq.train_pq(jnp.asarray(values), m, 8, seed))
    init = np.asarray(jax.random.choice(
        jax.random.PRNGKey(seed), values.shape[0], (tpq.N_CENTROIDS,),
        replace=False))
    got = tpq.train_pq(torch.from_numpy(values), m, 8, seed, init_rows=init)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pq_luts_sum_the_subvector_in_order(rng):
    """One rounding per product and per add, dims in order: the tables are
    the same bits on every device (numpy's f32 loop here)."""
    m, d_sub = 4, 5
    qv = rng.standard_normal((3, m * d_sub)).astype(np.float32)
    cents = rng.standard_normal((m, 256, d_sub)).astype(np.float32)
    want = np.zeros((3, m, 256), np.float32)
    q = qv.reshape(3, m, 1, d_sub)
    for d in range(d_sub):
        want = want + q[..., d] * cents[None, ..., d]
    got = tpq.pq_luts(torch.from_numpy(qv), torch.from_numpy(cents))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cluster_sums_equal_a_bincount(rng, monkeypatch):
    """The k-means update's one-hot matmuls, in blocks (ragged last one),
    against numpy per-centroid sums; integer data, so sums are exact."""
    monkeypatch.setattr(tpq, "_ROWS_PER_UPDATE", 50)
    m, n, d = 3, 333, 2
    sub = rng.integers(-8, 9, (m, n, d)).astype(np.float32)
    codes = rng.integers(0, tpq.N_CENTROIDS, (m, n))
    sums, counts = tpq._cluster_sums(torch.from_numpy(sub),
                                     torch.from_numpy(codes))
    for j in range(m):
        np.testing.assert_array_equal(
            counts[j].numpy(), np.bincount(codes[j], minlength=256))
        for c in range(d):
            np.testing.assert_array_equal(
                sums[j, :, c].numpy(),
                np.bincount(codes[j], sub[j, :, c], minlength=256))


def test_train_encode_pq_int8_plane_in_blocks(rng, monkeypatch):
    """An int8 plane with its scales, as a tensor, encodes in row blocks to
    the codes of its dequantized float plane given as numpy; training on a
    sample is repeatable bit for bit."""
    monkeypatch.setattr(tpq, "_ROWS_PER_STEP", 64)
    n, dim = 300, 12
    q = rng.integers(-127, 128, (n, dim)).astype(np.int8)
    scales = (rng.random(dim) * 0.02 + 0.01).astype(np.float32)
    floats = q.astype(np.float32) * scales[None, :]
    kw = dict(m=4, iters=4, seed=2, train_sample=200, device="cpu")
    codes, cents = tpq.train_encode_pq(
        torch.from_numpy(q), value_scales=torch.from_numpy(scales), **kw)
    want_codes, want_cents = tpq.train_encode_pq_np(floats, **kw)
    np.testing.assert_array_equal(cents.numpy(), want_cents)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(
        tpq.encode_pq(torch.from_numpy(floats), cents).numpy(), want_codes)
    again = tpq.train_encode_pq_np(floats, **kw)
    np.testing.assert_array_equal(again[0], want_codes)
    np.testing.assert_array_equal(again[1], want_cents)


def test_quantize_pq_runs_on_the_gpu_by_default(rng, monkeypatch, tmp_path):
    """Without a device named, the PQ build asks for the GPU: with none, it
    raises instead of running on the CPU (the API and 'index --pq-m')."""
    from dhr_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = PackedIndex(**vars(build_corpus(rng, N=64)))
    with pytest.raises(RuntimeError, match="CUDA"):
        packed.quantize_pq(m=4, iters=2)
    packed.save(str(tmp_path / "shard0.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["index", "--inputs", str(tmp_path / "shard*.npz"),
              "--output", str(tmp_path / "index.npz"), "--pq-m", "4"])
    cpu = packed.quantize_pq(m=4, iters=2, device="cpu")
    assert cpu.pq_codes.shape == (64, 4) and cpu.pq_codes.dtype == np.uint8


@pytest.fixture(scope="module")
def pq_world():
    rng = np.random.default_rng(5)
    packed = build_corpus(rng, N=600)
    qv, qi = build_queries(rng, B=9)
    return packed.quantize_pq(m=4, iters=5), qv, qi


def test_pq_index_crosses_packages(pq_world, tmp_path):
    packed, _, _ = pq_world
    packed.save(str(tmp_path / "jax.npz"))
    loaded = PackedIndex.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(loaded.pq_codes, packed.pq_codes)
    np.testing.assert_array_equal(loaded.pq_centroids, packed.pq_centroids)
    mine = PackedIndex(**vars(packed)).quantize_pq(m=4, iters=5,
                                                   device="cpu")
    assert mine.pq_codes.dtype == np.uint8
    assert mine.pq_centroids.shape == packed.pq_centroids.shape
    mine.save(str(tmp_path / "torch.npz"))
    back = JaxPacked.load(str(tmp_path / "torch.npz"))
    np.testing.assert_array_equal(back.pq_codes, mine.pq_codes)
    np.testing.assert_array_equal(back.pq_centroids, mine.pq_centroids)


@pytest.mark.parametrize("rerank", [False, True])
def test_pq_search_matches_reference(pq_world, rerank):
    packed, qv, qi = pq_world
    got, want, _ = _both(packed, qv, qi, layout="row", mode="pq", topk=10,
                         rerank=rerank, agip_topk=80, query_batch=4,
                         approx_candidates=False, candidate_bf16=False)
    # without rerank the scores are ADC sums of bf16 table entries, which
    # tie often: rows may differ only among equal scores
    _assert_rankings_equal(*got, *want)


def test_pq_tables_use_the_unfolded_query_on_an_int8_index(pq_world):
    """A pq index quantized to int8 afterwards ('index --pq-m --quantize'):
    the port scores codes with the raw query, since the centroids live in
    float space; the reference folds the int8 scales into that query first
    (a divergence found in this port, ROADMAP faults)."""
    packed, qv, qi = pq_world
    both = packed.quantize()
    idx = _port_index(both, layout="row")
    s = Searcher(idx, SearchConfig(mode="pq", topk=10), device="cpu")
    _, qv1, qi1 = s.prepare_queries(qv, qi)
    want = tpq.pq_ip_scores(tpq.pq_luts(torch.from_numpy(qv),
                                        idx.pq_centroids), idx.pq_codes)
    torch.testing.assert_close(s.stage1(qv1, qi1), want, rtol=0, atol=0)
    jax_s = JaxSearcher(JaxDeviceIndex.from_packed(both, layout="row"),
                        JaxConfig(mode="pq", topk=10))
    _, jqv1, _ = jax_s.prepare_queries(qv, qi)
    np.testing.assert_allclose(
        jqv1, qv * np.asarray(both.value_scales)[None, :], rtol=1e-6)


# -- escalation -----------------------------------------------------------------


def _esc_cfg(**kw):
    base = dict(topk=10, mode="gip", theta=0.35, rerank=True, agip_topk=100,
                query_batch=8, approx_candidates=False, candidate_bf16=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def esc_world():
    rng = np.random.default_rng(7)
    packed = build_corpus(rng, N=500)
    qv, qi = build_queries(rng, B=29)
    return packed, qv, qi


def _margins(packed, qv, qi):
    s = Searcher(_port_index(packed), SearchConfig(**_esc_cfg(
        escalate_pool=20)), device="cpu")
    scores, _, floors = s._run(s.prepare_queries(qv, qi))
    return np.sort(scores[:, -1] - floors)


@pytest.mark.parametrize("which", ["all", "never", "partial"])
def test_escalation_matches_reference(esc_world, which):
    packed, qv, qi = esc_world
    m = _margins(packed, qv, qi)
    margin = {"all": 1e30, "never": -1e30,
              "partial": float((m[14] + m[15]) / 2)}[which]
    cfg = _esc_cfg(escalate_pool=20, escalate_margin=margin)
    jidx = JaxDeviceIndex.from_packed(packed)
    jax_s = JaxSearcher(jidx, JaxConfig(**cfg))
    js, jr = jax_s.search(qv, qi)
    s = Searcher(_port_index(packed), SearchConfig(**cfg), device="cpu")
    got = s.search(qv, qi)
    assert s.escalated_queries == jax_s.escalated_queries
    assert s.escalated_queries == {"all": 29, "never": 0, "partial": 15}[which]
    assert s.last_timing["escalated"] == s.escalated_queries
    _assert_rankings_equal(*got, np.asarray(js), np.asarray(jr))
    # each query equals the tier that served it
    full = Searcher(_port_index(packed), SearchConfig(**_esc_cfg()),
                    device="cpu").search(qv, qi)[1]
    small = Searcher(_port_index(packed), SearchConfig(**_esc_cfg(
        agip_topk=20)), device="cpu").search(qv, qi)[1]
    for i in range(29):
        assert (np.array_equal(got[1][i], full[i])
                or np.array_equal(got[1][i], small[i]))


def test_calibrate_escalation_matches_reference(esc_world):
    packed, qv, qi = esc_world
    cfg = _esc_cfg(escalate_pool=20)
    want = JaxSearcher(JaxDeviceIndex.from_packed(packed), JaxConfig(**cfg)
                       ).calibrate_escalation(qv, qi, miss_mass_target=0.95)
    got = Searcher(_port_index(packed), SearchConfig(**cfg), device="cpu"
                   ).calibrate_escalation(qv, qi, miss_mass_target=0.95)
    assert set(got) == set(want)
    assert got["overlap_small_mean"] < 1.0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def test_escalation_validation(esc_world):
    packed, _, _ = esc_world
    idx = _port_index(packed)
    with pytest.raises(ValueError, match="rerank"):
        Searcher(idx, SearchConfig(topk=10, escalate_pool=20), device="cpu")
    for pool in (5, 100):
        with pytest.raises(ValueError, match="must lie in"):
            Searcher(idx, SearchConfig(**_esc_cfg(escalate_pool=pool)),
                     device="cpu")
    with pytest.raises(ValueError, match="escalate_pool"):
        Searcher(idx, SearchConfig(**_esc_cfg()), device="cpu"
                 ).calibrate_escalation(np.zeros((4, 20), np.float32))
    dense = JaxPacked(packed.values, None, packed.docids, lex_dim=packed.dim)
    with pytest.raises(ValueError, match="dense"):
        Searcher(_port_index(dense), SearchConfig(
            topk=10, mode="ip", rerank=True, agip_topk=100,
            escalate_pool=20), device="cpu")


# -- pool calibration ---------------------------------------------------------


def test_calibrate_pool_matches_reference():
    rng = np.random.default_rng(11)
    packed = build_corpus(rng, N=512)
    qv, qi = build_queries(rng, B=13)
    cfg = dict(topk=32, mode="gip", theta=0.35, rerank=True, agip_topk=256,
               query_batch=8, approx_candidates=False, candidate_bf16=False)
    pools = (256, 128, 64, 32)
    want = jax_calibrate_pool(JaxDeviceIndex.from_packed(packed),
                              JaxConfig(**cfg), qv, qi, pools=pools,
                              passes=1, overlap_target=0.9)
    got = calibrate_pool(_port_index(packed), SearchConfig(**cfg), qv, qi,
                         pools=pools, passes=1, overlap_target=0.9)
    assert set(got) == set(want)
    assert got["recommended_pool"] == want["recommended_pool"]
    assert got["pools"][256]["overlap_mean"] == 1.0
    for p in pools:
        assert set(got["pools"][p]) == set(want["pools"][p])
        assert len(got["pools"][p]["pass_s"]) == 1
        for k in ("overlap_mean", "overlap_min"):
            assert got["pools"][p][k] == want["pools"][p][k], (p, k)
    with pytest.raises(ValueError, match="rerank"):
        calibrate_pool(_port_index(packed), SearchConfig(
            **dict(cfg, rerank=False)), qv, qi, pools=(64, 32))
    with pytest.raises(ValueError, match="topk"):
        calibrate_pool(_port_index(packed), SearchConfig(**cfg), qv, qi,
                       pools=(64, 8))
    with pytest.raises(ValueError, match="two pool"):
        calibrate_pool(_port_index(packed), SearchConfig(**cfg), qv, qi,
                       pools=(64,))


# -- every mode through the CLI -------------------------------------------------


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    from dhr_tpu_torch.cli.main import main

    tmp = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(3)
    packed = build_corpus(rng, N=2048)
    JaxPacked(**vars(packed)).save(str(tmp / "shard0.npz"))
    main(["index", "--inputs", str(tmp / "shard*.npz"),
          "--output", str(tmp / "index.npz"), "--pq-m", "4",
          "--device", "cpu"])
    qv, qi = build_queries(rng, B=6)
    np.savez(tmp / "q.npz", values=qv, indices=qi)
    (tmp / "q.npz.qids.json").write_text(
        json.dumps([f"q{i}" for i in range(6)]))
    return tmp


@pytest.mark.parametrize("name,flags", [
    ("ip", ["--IP", "--rerank", "--agip-topk", "64"]),
    ("ip_chunked", ["--IP", "--row-chunk", "500", "--exact-candidates"]),
    ("pq", ["--PQIP", "--rerank", "--agip-topk", "64"]),
    ("fused", ["--theta", "0.3", "--rerank", "--agip-topk", "64",
               "--fused-candidates", "on", "--candidate-block", "8"]),
    ("escalate", ["--theta", "0.35", "--rerank", "--agip-topk", "64",
                  "--escalate-pool", "16", "--escalate-margin", "0.05"]),
])
def test_cli_search_modes_on_cpu(cli_world, name, flags, capsys):
    from dhr_tpu.retrieval import read_run as jax_read_run
    from dhr_tpu_torch.cli.main import main
    from dhr_tpu_torch.retrieval import read_run

    out = str(cli_world / f"{name}.trec")
    main(["search", "--index-path", str(cli_world / "index.npz"),
          "--query-path", str(cli_world / "q.npz"), "--topk", "10",
          "--query-batch", "4", "--output", out, "--device", "cpu", *flags])
    run = read_run(out)
    assert sorted(run) == [f"q{i}" for i in range(6)]
    assert all(len(d) == 10 for d in run.values())
    timing = json.loads(capsys.readouterr().err.split("DHR_TIMING ")[1])
    assert timing["queries"] == 6 and timing["device"] == "cpu"
    if name in ("ip", "ip_chunked", "pq"):
        from dhr_tpu.cli.main import main as jax_main

        ref = str(cli_world / f"{name}_ref.trec")
        jax_main(["search", "--index-path", str(cli_world / "index.npz"),
                  "--query-path", str(cli_world / "q.npz"), "--topk", "10",
                  "--query-batch", "4", "--output", ref, *flags])
        want = jax_read_run(ref)
        for q in run:
            assert set(run[q]) == set(want[q]), (name, q)


def test_cli_calibration_reports(cli_world):
    from dhr_tpu_torch.cli.main import main

    base = ["search", "--index-path", str(cli_world / "index.npz"),
            "--query-path", str(cli_world / "q.npz"), "--topk", "8",
            "--theta", "0.35", "--rerank", "--agip-topk", "64",
            "--query-batch", "4", "--exact-candidates", "--device", "cpu"]
    out = cli_world / "pool.json"
    main(base + ["--pool-calibrate", "64,16,8", "--pool-passes", "1",
                 "--output", str(out)])
    report = json.loads(out.read_text())
    assert set(int(k) for k in report["pools"]) == {64, 16, 8}
    assert report["pools"]["64"]["overlap_mean"] == 1.0
    out = cli_world / "esc.json"
    main(base + ["--escalate-pool", "16", "--escalate-calibrate",
                 "--output", str(out)])
    report = json.loads(out.read_text())
    assert {"escalate_margin", "frac_escalated", "overlap_after_mean",
            "pool", "agip_topk"} <= set(report)
    assert report["pool"] == 16


def test_cli_still_rejects_multi_gpu_and_recall_flags(cli_world):
    from dhr_tpu_torch.cli.main import main

    base = ["search", "--index-path", str(cli_world / "index.npz"),
            "--query-path", str(cli_world / "q.npz"), "--device", "cpu"]
    for flag in ("--shard-over-devices", "--candidate-recall"):
        with pytest.raises(SystemExit):
            main(base + [flag])


def test_search_config_fields_cover_the_reference():
    """Every SearchConfig field of the reference exists in the port, apart
    from the TPU-only ones (Pallas tiles, interpret mode, approx_max_k's
    recall target, the blockwise top-k block)."""
    tpu_only = {"use_pallas", "pallas_n_tile", "pallas_unroll",
                "pallas_interpret", "candidate_recall", "topk_block"}
    ref = {f.name for f in dataclasses.fields(JaxConfig)}
    port = {f.name for f in dataclasses.fields(SearchConfig)}
    assert port == ref - tpu_only
