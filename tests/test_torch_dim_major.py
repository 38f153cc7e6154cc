"""Dim-major planes at a padded row pitch.

``DeviceIndex`` keeps each dim-major plane as a ``(D, N)`` view of
``(D, pitch)`` storage, ``pitch = ceil(N / 128) * 128``, so that every dim
row starts 16-byte aligned for the theta-pass kernels.  The views must hold
the reference's bytes, the searcher must give the reference's answers over
them in every mode that reads them, and the kernels' wrappers take them
without a copy while refusing, on the card's route, a pitch that breaks
the alignment.
"""

import numpy as np
import pytest
import torch

from dhr_tpu.retrieval import DeviceIndex as JaxDeviceIndex
from dhr_tpu.retrieval import PackedIndex as JaxPacked
from dhr_tpu.retrieval import SearchConfig as JaxConfig
from dhr_tpu.retrieval import Searcher as JaxSearcher
from dhr_tpu_torch.ops.gip_candidates import gip_candidates_plain
from dhr_tpu_torch.ops.gip_candidates import gip_candidates
from dhr_tpu_torch.ops.partial_gip import (
    check_planes,
    partial_gip,
    partial_gip_plain,
    select_important,
)
from dhr_tpu_torch.retrieval import DeviceIndex, PackedIndex, SearchConfig
from dhr_tpu_torch.retrieval import Searcher
from dhr_tpu_torch.retrieval.index import dim_major

from tests.test_retrieval import build_corpus, build_queries
from tests.test_torch_index import _bytes
from tests.test_torch_searcher import _assert_rankings_equal


def _assert_padded(plane, n):
    assert plane.shape[1] == n
    assert plane.stride(1) == 1 and plane.stride(0) % 128 == 0
    assert plane.stride(0) == -(-n // 128) * 128
    assert plane.untyped_storage().nbytes() == \
        plane.shape[0] * plane.stride(0) * plane.element_size()


# -- (a) the planes -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 127, 128, 204_803])
@pytest.mark.parametrize("quantized", [False, True])
def test_device_planes_padded_and_byte_equal(rng, n, quantized):
    lex, cls = 12, 4
    values = rng.standard_normal((n, lex + cls)).astype(np.float16)
    folds = rng.integers(0, 6, (n, lex)).astype(np.uint8)
    jp = JaxPacked(values, folds, np.arange(n).astype(str), lex)
    if quantized:
        jp = jp.quantize()
    want = JaxDeviceIndex.from_packed(jp)
    got = DeviceIndex.from_packed(PackedIndex(**vars(jp)), device="cpu")
    for f in ("values_T", "indices_T"):
        _assert_padded(getattr(got, f), n)
        assert _bytes(getattr(got, f)) == _bytes(getattr(want, f)), f
    arrays = DeviceIndex.from_arrays(got.values, got.indices, jp.docids, lex,
                                     device="cpu")
    for f in ("values_T", "indices_T"):
        _assert_padded(getattr(arrays, f), n)
        assert torch.equal(getattr(arrays, f), getattr(got, f))


def test_dim_major_is_one_transposing_copy_with_zeroed_padding():
    plane = torch.arange(3 * 5, dtype=torch.int16).reshape(5, 3)  # (N, D)
    t = dim_major(plane)
    assert torch.equal(t, plane.T)
    _assert_padded(t, 5)
    full = torch.as_strided(t, (3, 128), (128, 1))
    assert bool((full[:, 5:] == 0).all())


# -- (e) what the wrappers take -----------------------------------------------


def _imp(rng, B, D, n_imp):
    qv = torch.from_numpy(np.where(rng.random((B, D)) > 0.3,
                                   rng.random((B, D)), 0.0).astype(np.float32))
    qi = torch.from_numpy(rng.integers(0, 3, (B, D)).astype(np.int32))
    return select_important(qv, qi, n_imp)


def test_wrappers_take_row_strided_planes_without_a_copy(rng):
    n, lex, cls = 301, 16, 4
    values = torch.from_numpy(rng.standard_normal((n, lex + cls))
                              .astype(np.float32))
    folds = torch.from_numpy(rng.integers(0, 3, (n, lex)).astype(np.int8))
    vt, it = dim_major(values), dim_major(folds)
    assert not vt.is_contiguous()
    check_planes(vt, it, aligned=True)
    imp = _imp(rng, 4, lex + cls, 9)
    got = partial_gip(*imp, vt, it, lex)
    assert torch.equal(got, partial_gip_plain(
        *imp, vt.contiguous(), it.contiguous(), lex))
    got = gip_candidates(*imp, vt, it, lex, 4, True)
    assert torch.equal(got.view(torch.int32), gip_candidates_plain(
        *imp, vt.contiguous(), it.contiguous(), lex, 4, True)
        .view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_card_route_refuses_rows_off_a_16_byte_boundary(dtype):
    n = 4099
    vt = torch.zeros(6, n, dtype=dtype)          # contiguous: pitch n
    it = torch.zeros(4, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte aligned.*dim_major"):
        check_planes(vt, dim_major(it.T.contiguous()), aligned=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_planes(dim_major(vt.T.contiguous()), it, aligned=True)
    check_planes(vt, it, aligned=False)          # the CPU route takes them
    check_planes(dim_major(vt.T.contiguous()),
                 dim_major(it.T.contiguous()), aligned=True)
    ok = torch.zeros(6, 4096, dtype=dtype)       # contiguous, aligned pitch
    check_planes(ok, torch.zeros(4, 4096, dtype=torch.int8), aligned=True)
    with pytest.raises(ValueError, match="unit stride"):
        check_planes(ok[:, ::2], torch.zeros(4, 2048, dtype=torch.int8),
                     aligned=False)


# -- (d) the searcher over padded planes --------------------------------------


def _jax_both(packed, qv, qi, jax_extra=None, **cfg):
    idx = DeviceIndex.from_packed(PackedIndex(**vars(packed)), device="cpu")
    _assert_padded(idx.values_T, packed.num_rows)
    got = Searcher(idx, SearchConfig(**cfg), device="cpu").search(qv, qi)
    js, jr = JaxSearcher(JaxDeviceIndex.from_packed(packed),
                         JaxConfig(**cfg, **(jax_extra or {}))
                         ).search(qv, qi)
    return got, (np.asarray(js), np.asarray(jr))


@pytest.mark.parametrize("cfg", [
    dict(theta=0.0, topk=20, query_batch=4),
    dict(theta=0.3, rerank=True, agip_topk=200, topk=20, query_batch=4,
         max_important_dims=8, candidate_bf16=False),
])
def test_gip_search_over_padded_planes_matches_reference(rng, cfg):
    packed = build_corpus(rng, N=3001).quantize()
    qv, qi = build_queries(rng, B=9)
    got, want = _jax_both(packed, qv, qi, **cfg)
    _assert_rankings_equal(*got, *want)


@pytest.mark.parametrize("quantized", [False, True])
def test_ip_over_padded_dim_major_plane_matches_reference(rng, quantized):
    packed = build_corpus(rng, N=1001)
    if quantized:
        packed = packed.quantize()
    qv, qi = build_queries(rng, B=6)
    got, want = _jax_both(packed, qv, qi, mode="ip", topk=15, query_batch=3)
    _assert_rankings_equal(*got, *want)


def test_fused_search_over_padded_planes_matches_reference(rng):
    """N = 3000 rows (pitch 3072) on the port's side; the reference's fused
    kernel needs whole 128 G-row blocks, so its corpus carries 72 zero rows
    after the same 3,000.  Every row scores > 0 (positive values, open CLS
    gates), so a zero row wins no group and the candidates are the same."""
    n, lex, cls, G = 3000, 24, 8, 8
    values = (rng.random((n, lex + cls)) + 0.05).astype(np.float16)
    folds = rng.integers(0, 6, (n, lex)).astype(np.uint8)
    ids = np.asarray([f"d{i}" for i in range(n + 72)], dtype=object)
    port = JaxPacked(values, folds, ids[:n], lex_dim=lex)
    ref = JaxPacked(np.concatenate([values, np.zeros((72, lex + cls),
                                                     np.float16)]),
                    np.concatenate([folds, np.zeros((72, lex), np.uint8)]),
                    ids, lex_dim=lex)
    qv = values[:8].astype(np.float32)
    qi = folds[:8].astype(np.int32)
    cfg = dict(topk=10, mode="gip", theta=0.1, rerank=True, agip_topk=256,
               query_batch=8, fused_candidates=True, candidate_block=G,
               candidate_slices=4)
    idx = DeviceIndex.from_packed(PackedIndex(**vars(port)), device="cpu")
    _assert_padded(idx.values_T, n)
    searcher = Searcher(idx, SearchConfig(**cfg), device="cpu")
    assert searcher._fused and searcher._packed_ids
    got = searcher.search(qv, qi)
    want = JaxSearcher(JaxDeviceIndex.from_packed(ref), JaxConfig(
        **cfg, use_pallas=True, pallas_interpret=True, pallas_n_tile=1024,
        candidate_recall=0.99)).search(qv, qi)
    want = tuple(np.asarray(x) for x in want)
    assert want[1].max() < n
    _assert_rankings_equal(*got, *want)
