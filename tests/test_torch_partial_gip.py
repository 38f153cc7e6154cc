"""K1's plain version against the reference theta pass: the Pallas kernel in
interpret mode and the lax.scan twin, on the same numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops import gip_scores_masked, pad_indices_for_cls
from dhr_tpu.ops.pallas_gip import partial_gip_scores_pallas
from dhr_tpu.retrieval.searcher import _partial_gip_scores
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.partial_gip import partial_gip_scores


def _inputs(rng, B, N, lex, cls, k, idx_dtype=np.int8):
    D = lex + cls
    values_T = rng.random((D, N)).astype(np.float32)
    indices_T = rng.integers(0, k, (lex, N)).astype(idx_dtype)
    qv = np.where(rng.random((B, D)) > 0.5, rng.random((B, D)),
                  0.0).astype(np.float32)
    qi = np.concatenate([rng.integers(0, k, (B, lex)), np.ones((B, cls))],
                        axis=1).astype(np.int32)
    return qv, qi, values_T, indices_T


def _port(qv, qi, vt, it, lex, n_imp, out=torch.float32):
    t = [torch.from_numpy(np.array(x)) for x in (qv, qi, vt, it)]
    return partial_gip_scores(*t, lex, n_imp, out).float().numpy()


@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("lex,cls,k", [(16, 4, 5), (8, 0, 3)])
def test_plain_k1_matches_pallas_and_scan(rng, lex, cls, k, unroll):
    B, N, I = 4, 256, 6
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, k)
    j = [jnp.asarray(x) for x in (qv, qi, vt, it)]
    got = _port(qv, qi, vt, it, lex, I)
    want_scan = np.asarray(_partial_gip_scores(*j, lex, I))
    want_pallas = np.asarray(partial_gip_scores_pallas(
        *j, lex, I, n_tile=128, interpret=True, unroll=unroll))
    np.testing.assert_allclose(got, want_scan, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)


def test_plain_k1_brute_force_equals_masked_gip(rng):
    """I == D at theta=0 is exact GIP with the always-on CLS tail."""
    B, N, lex, cls, k = 3, 128, 8, 2, 4
    D = lex + cls
    pv = rng.random((N, D)).astype(np.float32)
    pi = rng.integers(0, k, (N, lex)).astype(np.int8)
    qv = rng.random((B, D)).astype(np.float32)
    qi = rng.integers(0, k, (B, lex)).astype(np.int32)
    qi_full = np.asarray(pad_indices_for_cls(jnp.asarray(qi), cls))
    pi_full = np.asarray(pad_indices_for_cls(
        jnp.asarray(pi.astype(np.int32)), cls))
    want = np.asarray(gip_scores_masked(
        jnp.asarray(qv), jnp.asarray(qi_full), jnp.asarray(pv),
        jnp.asarray(pi_full)))
    got = _port(qv, qi_full, pv.T.copy(), pi.T.copy(), lex, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plain_k1_bf16_out_matches_pallas_bf16(rng):
    """bf16 output: f32 accumulation, one rounding at the end — within
    bf16 rounding of the Pallas kernel's bf16 output and of f32."""
    B, N, I, lex, cls, k = 4, 512, 12, 16, 4, 5
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, k)
    j = [jnp.asarray(x) for x in (qv, qi, vt, it)]
    got = _port(qv, qi, vt, it, lex, I, torch.bfloat16)
    want16 = np.asarray(partial_gip_scores_pallas(
        *j, lex, I, n_tile=128, interpret=True, out_dtype=jnp.bfloat16),
        np.float32)
    want32 = np.asarray(_partial_gip_scores(*j, lex, I))
    np.testing.assert_allclose(got, want16, rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got, want32, rtol=8e-3, atol=8e-3)


def test_plain_k1_int16_indices(rng):
    """Folds >= 128 need an int16 plane; gates compare widened."""
    B, N, I, lex, cls, k = 3, 256, 10, 16, 4, 300
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, k, np.int16)
    it[:, ::3] = qi[0, :lex, None]  # guarantee some gates open
    j = [jnp.asarray(x) for x in (qv, qi, vt, it)]
    got = _port(qv, qi, vt, it, lex, I)
    np.testing.assert_allclose(got, np.asarray(_partial_gip_scores(
        *j, lex, I)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(partial_gip_scores_pallas(
        *j, lex, I, n_tile=128, interpret=True)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [1, 301])
def test_plain_k1_ragged_rows(rng, N):
    """No multiple-of-tile rule on N (the Pallas kernel needs N % n_tile
    == 0, so the scan twin is the reference here)."""
    qv, qi, vt, it = _inputs(rng, 5, N, 12, 4, 3)
    j = [jnp.asarray(x) for x in (qv, qi, vt, it)]
    np.testing.assert_allclose(
        _port(qv, qi, vt, it, 12, 7),
        np.asarray(_partial_gip_scores(*j, 12, 7)), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_path(rng):
    qv, qi, vt, it = _inputs(rng, 2, 64, 8, 2, 3)
    before = kernel_launches()["partial_gip"]
    _port(qv, qi, vt, it, 8, 4)
    _port(qv, qi, vt, it, 8, 10, torch.bfloat16)
    assert kernel_launches()["partial_gip"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    qv, qi, vt, it = (torch.from_numpy(x) for x in
                      _inputs(rng, 2, 64, 8, 2, 3))
    with pytest.raises(TypeError):
        partial_gip_scores(qv, qi, vt.to(torch.float64), it, 8, 4)
    with pytest.raises(TypeError):
        partial_gip_scores(qv, qi, vt, it.to(torch.int32), 8, 4)
    with pytest.raises(ValueError):
        partial_gip_scores(qv, qi, vt, it[:7], 8, 4)
    with pytest.raises(ValueError):
        partial_gip_scores(qv, qi, vt.T.contiguous().T, it, 8, 4)
