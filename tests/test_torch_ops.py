"""The port's GIP oracle ops and top-k against dhr_tpu on the same inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops import gip as jgip
from dhr_tpu.ops import topk as jtopk
from dhr_tpu_torch.ops import gip as tgip
from dhr_tpu_torch.ops import topk as ttopk

RTOL, ATOL = 1e-5, 1e-6


def _inputs(rng, B=5, N=40, lex=12, cls=4, k=4):
    D = lex + cls
    qv = rng.random((B, D)).astype(np.float32)
    pv = rng.random((N, D)).astype(np.float32)
    qi = np.concatenate([rng.integers(0, k, (B, lex)),
                         np.ones((B, cls))], 1).astype(np.int32)
    pi = np.concatenate([rng.integers(0, k, (N, lex)),
                         np.ones((N, cls))], 1).astype(np.int32)
    return qv, qi, pv, pi


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pad_and_scale_cls(rng):
    idx = rng.integers(0, 5, (3, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tgip.pad_indices_for_cls(torch.from_numpy(idx), 3).numpy(),
        np.asarray(jgip.pad_indices_for_cls(jnp.asarray(idx), 3)))
    assert tgip.pad_indices_for_cls(torch.from_numpy(idx), 0).shape == (3, 7)
    v = rng.random((3, 10)).astype(np.float32)
    for lam in (1.0, 0.3):
        _close(tgip.scale_cls_tail(torch.from_numpy(v), 7, lam),
               jgip.scale_cls_tail(jnp.asarray(v), 7, lam))


@pytest.mark.parametrize("B", [5, 70])  # 70 > q_chunk exercises chunking
def test_gip_scores_masked(rng, B):
    qv, qi, pv, pi = _inputs(rng, B=B)
    args = [torch.from_numpy(x) for x in (qv, qi, pv, pi)]
    _close(tgip.gip_scores_masked(*args),
           jgip.gip_scores_masked(*map(jnp.asarray, (qv, qi, pv, pi))))


def test_gip_subindex_pairwise_ip(rng):
    qv, qi, pv, pi = _inputs(rng)
    t = [torch.from_numpy(x) for x in (qv, qi, pv, pi)]
    j = [jnp.asarray(x) for x in (qv, qi, pv, pi)]
    _close(tgip.gip_scores_subindex(*t, num_folds=4),
           jgip.gip_scores_subindex(*j, num_folds=4))
    _close(tgip.gip_scores_pairwise(t[0], t[1], t[2][:5], t[3][:5]),
           jgip.gip_scores_pairwise(j[0], j[1], j[2][:5], j[3][:5]))
    _close(tgip.ip_scores(t[0], t[2]), jgip.ip_scores(j[0], j[2]))


@pytest.mark.parametrize("keep_cls", [False, True])
def test_threshold_query_values(rng, keep_cls):
    qv = rng.random((4, 16)).astype(np.float32)
    _close(tgip.threshold_query_values(torch.from_numpy(qv), 0.4, 12,
                                       keep_cls),
           jgip.threshold_query_values(jnp.asarray(qv), 0.4, 12, keep_cls))


@pytest.mark.parametrize("n,k,block", [(50, 7, 16384), (1000, 30, 64),
                                       (1001, 100, 64), (300, 80, 64)])
def test_blockwise_topk_matches(rng, n, k, block):
    s = rng.permutation(3 * n)[: 3 * n // 3 * 3].reshape(3, -1)[:, :n]
    s = s.astype(np.float32) / 7.0  # distinct values
    vt, it = ttopk.blockwise_topk(torch.from_numpy(s), k, block)
    vj, ij = jtopk.blockwise_topk(jnp.asarray(s), k, block)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_merge_topk_matches(rng):
    vals = rng.permutation(240).astype(np.float32).reshape(4, 60)
    idx = rng.integers(0, 10**6, (4, 60)).astype(np.int64)
    vt, it = ttopk.merge_topk(torch.from_numpy(vals), torch.from_numpy(idx),
                              9)
    vj, ij = jtopk.merge_topk(jnp.asarray(vals), jnp.asarray(idx), 9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
