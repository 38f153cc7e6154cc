"""The port's densify / aggregate against dhr_tpu's, on random inputs and on
inputs with ties built in.  Values and indices must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhr_tpu.ops import aggregate as jax_aggregate
from dhr_tpu.ops import densify as jax_densify
from dhr_tpu.ops import merge_reps as jax_merge_reps
from dhr_tpu.ops.aggregate import cal_remove_dim as jax_cal_remove_dim
from dhr_tpu.ops.densify import REMOVE_DIMS_BY_MODEL as JAX_REMOVE_DIMS
from dhr_tpu.ops.densify import undensify as jax_undensify
from dhr_tpu_torch.ops import (
    aggregate,
    cal_remove_dim,
    densify,
    merge_reps,
    undensify,
)
from dhr_tpu_torch.ops.densify import REMOVE_DIMS_BY_MODEL


def lexical(seed, shape, ties=False):
    """Non-negative sparse-ish vocabulary vectors; with ``ties``, values
    drawn from 4 levels so many folds share the maximum (zeros included)."""
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 4, shape).astype(np.float32) * 0.25
    x = rng.exponential(size=shape).astype(np.float32)
    return np.where(rng.random(shape) < 0.3, x, 0.0).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,out_dim,remove", [
    ((5, 1024), 96, 64),
    ((3, 7, 1024), 96, 64),
    ((2, 30522), 768, 570),
])
def test_densify_matches_reference(shape, out_dim, remove, ties):
    x = lexical(0, shape, ties)
    jv, ji = jax_densify(jnp.asarray(x), out_dim, remove)
    tv, ti = densify(torch.from_numpy(x), out_dim, remove)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if ties:  # ties were built in: the lowest tied fold wins
        folded = x[..., remove:].reshape(*shape[:-1], -1, out_dim)
        assert (np.sum(folded == folded.max(-2, keepdims=True), -2) > 1).any()
        np.testing.assert_array_equal(ti.numpy(), folded.argmax(-2))


def test_densify_all_zero_slices_pick_fold_zero():
    tv, ti = densify(torch.zeros(2, 1024), 96, 64)
    assert not tv.any() and not ti.any()


def test_densify_rejects_uneven_folds():
    with pytest.raises(ValueError):
        densify(torch.zeros(2, 1000), 96, 64)


@pytest.mark.parametrize("ties", [False, True])
def test_undensify_matches_reference(ties):
    x = lexical(1, (4, 1024), ties)
    tv, ti = densify(torch.from_numpy(x), 96, 64)
    want = jax_undensify(jnp.asarray(tv.numpy()), jnp.asarray(ti.numpy()),
                         1024, 64)
    got = undensify(tv, ti, 1024, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back_v, back_i = densify(got, 96, 64)
    assert torch.equal(back_v, tv)


@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("vocab,dim", [
    (30522, 640),   # full: 30522 % 1280 = 1082 > 1000 -> pad the tail
    (1000, 48),     # trim the front
    (1024, 64),     # divides evenly
])
def test_aggregate_matches_reference(vocab, dim, full):
    for seed, ties in ((2, False), (3, True)):
        x = lexical(seed, (3, vocab), ties)
        if not ties:
            x = x - 0.5 * lexical(seed + 10, (3, vocab))  # negatives too
        want = jax_aggregate(jnp.asarray(x), dim, full=full)
        got = aggregate(torch.from_numpy(x), dim, full=full)
        assert got.shape == (3, dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cal_remove_dim_and_tables_match_reference():
    for dims in (48, 64, 640, 768, 1280):
        for vocab in (1000, 1024, 30522):
            assert cal_remove_dim(dims, vocab) == jax_cal_remove_dim(dims,
                                                                     vocab)
    assert REMOVE_DIMS_BY_MODEL == JAX_REMOVE_DIMS


def test_merge_reps_matches_reference():
    lex = lexical(4, (3, 64))
    sem = np.random.default_rng(5).standard_normal((3, 16))
    want = jax_merge_reps(jnp.asarray(lex), jnp.asarray(sem, jnp.float32))
    got = merge_reps(torch.from_numpy(lex), torch.from_numpy(sem))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
