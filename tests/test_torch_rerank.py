"""K2's plain version against the reference rerank: the Pallas kernel in
interpret mode and the searcher's gather + _rerank_gip."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops.pallas_rerank import pallas_rerank_gip
from dhr_tpu.retrieval.searcher import _rerank_gip
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.rerank_gip import rerank_gip


def _reference(qv, qi_full, rows, values, indices, lex):
    cand_v = jnp.take(jnp.asarray(values), jnp.asarray(rows), axis=0)
    cand_i = jnp.take(jnp.asarray(indices), jnp.asarray(rows), axis=0)
    return np.asarray(_rerank_gip(jnp.asarray(qv), jnp.asarray(qi_full),
                                  cand_v, cand_i, lex))


def _close(got, want, rel=1e-5):
    """Norm-wise: f32 sums of up to D products in another order than the
    reference differ by a few ulps of the largest score, not of each."""
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= rel * scale


def _port(qv, qi, rows, values, indices, lex):
    return rerank_gip(torch.from_numpy(qv), torch.from_numpy(qi),
                      torch.from_numpy(rows.astype(np.int64)),
                      torch.from_numpy(values), torch.from_numpy(indices),
                      lex).numpy()


@pytest.mark.parametrize("vdtype", [np.float32, np.int8])
def test_plain_k2_matches_pallas_and_gather(rng, vdtype):
    B, K, N, lex, cls = 3, 256, 512, 128, 128
    D = lex + cls
    if vdtype == np.int8:
        values = rng.integers(-127, 128, (N, D)).astype(np.int8)
    else:
        values = rng.random((N, D)).astype(np.float32)
    indices = rng.integers(0, 6, (N, lex)).astype(np.int8)
    qv = rng.random((B, D)).astype(np.float32)
    qi = rng.integers(0, 6, (B, lex)).astype(np.int32)
    rows = rng.integers(0, N, (B, K)).astype(np.int32)
    qi_full = np.concatenate([qi, np.ones((B, cls), np.int32)], axis=1)
    got = _port(qv, qi_full, rows, values, indices, lex)
    want_pallas = np.asarray(pallas_rerank_gip(
        jnp.asarray(qv), jnp.asarray(qi), jnp.asarray(rows),
        jnp.asarray(values), jnp.asarray(indices), lex, interpret=True))
    _close(got, want_pallas)
    _close(got, _reference(qv, qi_full, rows, values, indices, lex))


@pytest.mark.parametrize("idx_dtype", [np.int8, np.int16])
def test_plain_k2_unaligned_shapes(rng, idx_dtype):
    """D=20, lex=16, K=37: no multiple-of-128 rule on D, lex or K."""
    B, K, N, lex, D = 4, 37, 90, 16, 20
    values = rng.integers(-127, 128, (N, D)).astype(np.int8)
    indices = rng.integers(0, 5, (N, lex)).astype(idx_dtype)
    qv = rng.random((B, D)).astype(np.float32)
    qi = np.concatenate([rng.integers(0, 5, (B, lex)),
                         np.ones((B, D - lex))], 1).astype(np.int32)
    rows = rng.integers(0, N, (B, K))
    _close(_port(qv, qi, rows, values, indices, lex),
           _reference(qv, qi, rows.astype(np.int32), values, indices, lex))


def test_out_of_range_rows_score_minus_inf(rng):
    N, D, lex = 10, 6, 4
    values = rng.random((N, D)).astype(np.float32)
    indices = np.zeros((N, lex), np.int8)
    qv = rng.random((2, D)).astype(np.float32)
    qi = np.zeros((2, D), np.int32)
    rows = np.array([[0, N, 3], [-1, 9, N + 5]])
    got = _port(qv, qi, rows, values, indices, lex)
    assert np.isneginf(got[[0, 1, 1], [1, 0, 2]]).all()
    np.testing.assert_allclose(got[0, [0, 2]],
                               (values[[0, 3]] * qv[0]).sum(-1), rtol=1e-6)


def test_widened_gate_vs_reference_cast(rng):
    """Known divergence: the reference casts qi to the index plane's dtype
    before comparing (searcher.py:345), so a query fold of 300 on an int8
    plane wraps to 44 and gates open against a passage fold of 44.  The port
    compares widened int32: 300 != 44, the gate stays shut."""
    N, lex, D = 3, 4, 4
    values = np.ones((N, D), np.float32)
    indices = np.full((N, lex), 44, np.int8)
    qv = np.ones((1, D), np.float32)
    qi = np.full((1, D), 300, np.int32)
    rows = np.arange(N)[None, :]
    got = _port(qv, qi, rows, values, indices, lex)
    np.testing.assert_array_equal(got, np.zeros((1, N), np.float32))
    ref = _reference(qv, qi, rows.astype(np.int32), values, indices, lex)
    np.testing.assert_array_equal(ref, np.full((1, N), 4.0, np.float32))


def test_cpu_tensors_take_the_plain_path(rng):
    before = kernel_launches()["rerank_gip"]
    test_plain_k2_unaligned_shapes(rng, np.int8)
    assert kernel_launches()["rerank_gip"] == before
    with pytest.raises(TypeError):   # rows must be int64
        rerank_gip(torch.zeros(1, 4), torch.zeros(1, 4, dtype=torch.int32),
                   torch.zeros(1, 2, dtype=torch.int32), torch.zeros(5, 4),
                   torch.zeros(5, 3, dtype=torch.int8), 3)
