"""K3's plain version against the reference's fused-candidates kernel
(``partial_gip_candidates_pallas`` in interpret mode) and its decoder, on
the same numpy inputs.

Values and weights are dyadic (multiples of 1/8, small), so every f32 sum is
exact in any order: rows must be equal and scores bit-equal although the
reference sums in its own unrolled order.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops.pallas_gip import decode_packed_candidates as jax_decode
from dhr_tpu.ops.pallas_gip import partial_gip_candidates_pallas
from dhr_tpu.retrieval.searcher import _partial_gip_scores
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.gip_candidates import (
    LANE,
    decode_packed_candidates,
    gip_candidates,
    gip_candidates_plain,
    partial_gip_candidates,
    reduced_lanes,
)
from dhr_tpu_torch.ops.partial_gip import select_important

LEX, CLS, FOLDS, I = 16, 4, 5, 6


def _inputs(rng, B, N, signed=True):
    D = LEX + CLS
    vt = np.round(rng.random((D, N)) * 8) / 8
    it = rng.integers(0, FOLDS, (LEX, N)).astype(np.int8)
    # distinct non-zero weights: lax.top_k and torch.topk order ties
    # differently, so tied weights could pick different important dims
    w = np.stack([rng.permutation(D) + 1 for _ in range(B)]) / 8
    w = w - (D / 16 if signed else 0.0)
    qv = np.where(rng.random((B, D)) > 0.5, w, 0.0)
    qi = np.concatenate([rng.integers(0, FOLDS, (B, LEX)),
                         np.ones((B, CLS))], axis=1).astype(np.int32)
    return (qv.astype(np.float32), qi, vt.astype(np.float32), it)


def _port(inputs, G, packed, out=torch.float32):
    t = [torch.from_numpy(np.array(x)) for x in inputs]
    return partial_gip_candidates(*t, LEX, I, G, packed, out)


def _ref(inputs, G, packed, out=jnp.float32):
    j = [jnp.asarray(x) for x in inputs]
    return partial_gip_candidates_pallas(
        *j, LEX, I, n_tile=128 * G, interpret=True, unroll=4,
        out_dtype=out, reduce_block=G, packed_ids=packed)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("G", [2, 4, 8, 3])
def test_two_planes_equal_reference(rng, G):
    inputs = _inputs(rng, 4, 128 * G * 3)
    got_v, got_r = _port(inputs, G, False)
    want_v, want_r = _ref(inputs, G, False)
    assert got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))


@pytest.mark.parametrize("G", [2, 4, 8])
def test_packed_plane_bit_equal_and_decodes_like_reference(rng, G):
    inputs = _inputs(rng, 4, 128 * G * 3)
    got = _port(inputs, G, True)
    want = _ref(inputs, G, True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # decode at every position: rows equal the two-plane rows and the
    # reference decoder's, scores the reference decoder's
    pos = torch.arange(got.shape[-1]).expand_as(got)
    s, r = decode_packed_candidates(got, pos, G)
    js, jr = jax_decode(jnp.asarray(want), jnp.asarray(pos.numpy()), G)
    _, rows2 = _port(inputs, G, False)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(r.numpy(), rows2.numpy())
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(js))


def test_bf16_two_plane_scores_equal_reference(rng):
    inputs = _inputs(rng, 3, 128 * 8 * 2)
    got_v, got_r = _port(inputs, 8, False, torch.bfloat16)
    want_v, want_r = _ref(inputs, 8, False, jnp.bfloat16)
    assert got_v.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v, np.float32))


@pytest.mark.parametrize("G,N", [(8, 1000), (3, 1), (4, 1537), (2, 256)])
def test_ragged_rows_against_numpy_block_reduce(rng, G, N):
    """No multiple of 128 G on N: rows >= N take no part; a group without a
    valid row is -inf with row N (two planes) or j = 0 (packed)."""
    inputs = _inputs(rng, 3, N)
    sums = np.asarray(_partial_gip_scores(
        *[jnp.asarray(x) for x in inputs], LEX, I))
    P = reduced_lanes(N, G)
    pad = np.full((3, P * G), -np.inf, np.float32)
    pad[:, :N] = sums
    x = pad.reshape(3, P // LANE, G, LANE)
    want_v = x.max(axis=2).reshape(3, P)
    j = x.argmax(axis=2).reshape(3, P)          # first max, like the kernel
    p = np.arange(P)
    want_r = (p // LANE) * G * LANE + j * LANE + p % LANE
    want_r = np.where(np.isneginf(want_v), N, want_r)
    got_v, got_r = _port(inputs, G, False)
    assert got_v.shape == (3, P)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    if G & (G - 1) == 0:
        packed = _port(inputs, G, True).numpy()
        np.testing.assert_array_equal(np.isneginf(packed),
                                      np.isneginf(want_v))
        bits = packed.view(np.int32) & (G - 1)
        np.testing.assert_array_equal(bits, np.where(np.isneginf(want_v),
                                                     0, j))


def test_first_max_wins_on_ties():
    """All-equal groups pick j = 0; torch's max(dim) keeps the first."""
    G, N = 4, 128 * 4
    vt = torch.ones(1, N)
    it = torch.zeros(1, N, dtype=torch.int8)
    imp = (torch.ones(1, 1), torch.zeros(1, 1, dtype=torch.int32),
           torch.zeros(1, 1, dtype=torch.int32))
    vals, rows = gip_candidates(*imp, vt, it, 1, G, False, torch.float32)
    assert torch.equal(rows[0], torch.arange(LANE, dtype=torch.int32))
    packed = gip_candidates_plain(*imp, vt, it, 1, G, True)
    assert torch.equal(packed.view(torch.int32) & (G - 1),
                       torch.zeros(1, LANE, dtype=torch.int32))


def test_cpu_tensors_take_the_plain_path(rng):
    inputs = _inputs(rng, 2, 512)
    before = kernel_launches()["gip_candidates"]
    _port(inputs, 4, True)
    _port(inputs, 4, False, torch.bfloat16)
    assert kernel_launches()["gip_candidates"] == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    qv, qi, vt, it = (torch.from_numpy(x) for x in _inputs(rng, 2, 512))
    imp = select_important(qv, qi, I)
    with pytest.raises(ValueError, match="power of two"):
        gip_candidates(*imp, vt, it, LEX, 3, True)
    with pytest.raises(ValueError):
        gip_candidates(*imp, vt, it, LEX, 0, False)
    with pytest.raises(TypeError):
        gip_candidates(*imp, vt.double(), it, LEX, 4, False)
    with pytest.raises(ValueError):
        gip_candidates(*imp, vt, it[:3], LEX, 4, False)
