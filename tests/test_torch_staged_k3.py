"""K3's staging plan, and a CPU emulation of the staged K3 built from it.

The kernel (``csrc/gip_candidates.cu``) owns ``T`` lanes of one group block
per thread block and walks, in j order, the group's steps that hold a
valid row: at step ``j`` it stages the rows ``gb 128 G + j 128 + l0 ..`` of
the plan's dims (zero past N), computes every query of a chunk from that
copy with K1's arithmetic, and keeps a running first maximum (strict
``>``) per (query, lane); rows past N take no part.  The emulation does the same with tensors: it must equal
``gip_candidates_plain`` bit for bit, and match the reference's
``partial_gip_candidates_pallas`` (interpret mode) and a numpy block reduce
of the reference scan.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops.pallas_gip import partial_gip_candidates_pallas
from dhr_tpu.retrieval.searcher import _partial_gip_scores
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.gip_candidates import (
    LANE,
    QUERY_ROWS,
    candidates_plan,
    gip_candidates,
    gip_candidates_plain,
    pick_candidates_tile,
    reduced_lanes,
)
from dhr_tpu_torch.ops.partial_gip import (
    SMEM_BYTES,
    SMEM_TWO_BLOCKS,
    select_important,
    staged_bytes,
    staging_plan,
)

NEG_INF = float("-inf")


def emulate_staged_k3(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                      lex_dim, G, packed, out_dtype, plan):
    """The kernel's schedule on the CPU, all tiles of a chunk at once.  A
    tile walks its steps that hold a valid row in j order; at each, each
    lane's staged row (zero past N), each query's ``counts[b]`` entries in
    order (a closed gate adds nothing; CLS slots gate against the zero fold
    row with gate 0), each product rounded before its f32 add; rows past N
    take no part; the running maximum takes step 0 and then a strictly
    larger sum."""
    B = imp_vals.shape[0]
    N = values_T.shape[1]
    P = reduced_lanes(N, G)
    best = torch.full((B, P), NEG_INF)
    best_j = torch.zeros(B, P, dtype=torch.int64)
    lane = torch.arange(P)
    gb = lane // LANE
    first = gb * LANE * G + lane % LANE                # the group's row, j = 0
    for c in plan.chunks:
        T = c.tile
        dims = c.dims.long()
        tile_row0 = gb * LANE * G + (lane % LANE) // T * T
        left = N - tile_row0
        n_steps = torch.where(left <= 0, 1,
                              torch.clamp(-(-left // LANE), max=G))
        # staged copies: every step's rows, zero past N (+ one zero fold row)
        pad = P * G + LANE
        s_v = torch.zeros(dims.numel(), pad, dtype=values_T.dtype)
        s_v[:, :N] = values_T[dims]
        s_i = torch.zeros(c.n_lex + 1, pad, dtype=indices_T.dtype)
        s_i[:c.n_lex, :N] = indices_T[dims[:c.n_lex]]
        for j in range(G):
            on = j < n_steps                       # the tile's walk
            rows = first + j * LANE
            for b in range(c.start, c.stop):
                acc = torch.zeros(P, dtype=torch.float32)
                for i in range(int(plan.counts[b])):
                    w = plan.entries[b, i, 0].view(torch.float32)
                    key = int(plan.entries[b, i, 1])
                    slot, gate = key & 0xFFFF, key >> 16
                    p = s_v[slot, rows].float() * w
                    opened = s_i[min(slot, c.n_lex), rows].int() == gate
                    acc = torch.where(opened, acc + p, acc)
                win = on & (rows < N) & ((j == 0) | (acc > best[b]))
                best[b] = torch.where(win, acc, best[b])
                best_j[b] = torch.where(win, j, best_j[b])
    if packed:
        bits = (best.view(torch.int32) & -G) | best_j.int()
        return bits.view(torch.float32)
    row = torch.where(first < N, first + best_j * LANE, N)
    return best.to(out_dtype), row.int()


def _inputs(rng, B, N, lex, cls, folds, n_imp):
    D = lex + cls
    vt = rng.standard_normal((D, N)).astype(np.float32)
    it = rng.integers(0, folds, (lex, N)).astype(np.int8)
    qv = np.where(rng.random((B, D)) > 0.4, rng.random((B, D)),
                  0.0).astype(np.float32)
    qi = np.concatenate([rng.integers(0, folds, (B, lex)),
                         np.ones((B, cls))], axis=1).astype(np.int32)
    return qv, qi, vt, it


def _imp(qv, qi, n_imp):
    return select_important(torch.from_numpy(qv), torch.from_numpy(qi),
                            n_imp)


def _equal(got, want, packed):
    if packed:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    else:
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].float().view(torch.int32),
                           want[0].float().view(torch.int32))


# -- the plan -----------------------------------------------------------------


@pytest.mark.parametrize("n_dims,n_lex,n_q,vb,ib,tile", [
    (753, 700, 128, 1, 1, 64),    # bench batch: 93 KB, two blocks an SM
    (896, 768, 64, 1, 1, 64),     # exact search (theta = 0)
    (896, 768, 128, 2, 2, 32),    # bf16 values, int16 folds
    (896, 768, 128, 4, 2, 16),    # f32 values
    (100, 90, 128, 1, 1, 64),     # 128 queries: at most 64 lanes a block
    (0, 0, 16, 1, 1, 128),
])
def test_pick_candidates_tile_at_published_widths(n_dims, n_lex, n_q, vb, ib,
                                                  tile):
    """A block holds QUERY_ROWS (query, row) pairs; of the tiles that
    allow the queries and fit, the largest at which two blocks share an
    SM, else the largest."""
    fp = lambda t: staged_bytes(n_dims, n_lex, t, vb, ib)  # noqa: E731
    assert pick_candidates_tile(n_dims, n_lex, n_q, vb, ib) == tile
    assert fp(tile) <= SMEM_BYTES and n_q * tile <= QUERY_ROWS
    for bigger in (t for t in (16, 32, 64, 128) if t > tile):
        limit = SMEM_TWO_BLOCKS if fp(tile) <= SMEM_TWO_BLOCKS else SMEM_BYTES
        assert n_q * bigger > QUERY_ROWS or fp(bigger) > limit


def test_candidates_plan_splits_past_a_blocks_queries(rng):
    """600 queries over a few dims: no tile holds them all (at most
    QUERY_ROWS / 16 = 512), so the batch splits where K1's plan does not;
    each chunk's tile holds its queries."""
    B, D, lex = 600, 8, 6
    imp_vals = torch.from_numpy(rng.random((B, 3)).astype(np.float32))
    imp_dims = torch.from_numpy(rng.integers(0, D, (B, 3)).astype(np.int32))
    gates = torch.zeros(B, 3, dtype=torch.int32)
    assert len(staging_plan(imp_vals, imp_dims, gates, D, lex, 1, 1).chunks) \
        == 1
    plan = candidates_plan(imp_vals, imp_dims, gates, D, lex, 1, 1)
    assert [(c.start, c.stop) for c in plan.chunks] == [(0, 512), (512, 600)]
    for c in plan.chunks:
        assert (c.stop - c.start) * c.tile <= QUERY_ROWS
        assert c.tile == pick_candidates_tile(c.dims.numel(), c.n_lex,
                                              c.stop - c.start, 1, 1)


# -- the emulated kernel ------------------------------------------------------


@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
@pytest.mark.parametrize("G", [2, 3, 4, 8])
@pytest.mark.parametrize("split", [False, True])
def test_emulated_k3_bit_equal_to_plain(rng, vdt, idt, G, split):
    """N = 1,000 rows (ragged at every G here), every output form."""
    B, N, lex, cls, n_imp = 5, 1000, 24, 8, 14
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, 4, n_imp)
    qi[:, :lex:3] += 256   # low byte a fold's, value beyond int8: never open
    if vdt == torch.int8:
        vt = np.clip(np.round(vt * 40), -127, 127)
    vt = torch.from_numpy(vt).to(vdt)
    it = torch.from_numpy(it).to(idt)
    imp = _imp(qv, qi, n_imp)
    vb, ib = vt.element_size(), it.element_size()
    # a split budget stages 20 dims of 16 rows: about one query
    budget = 16 * 20 * (vb + ib) if split else SMEM_BYTES
    plan = candidates_plan(*imp, lex + cls, lex, vb, ib, smem_bytes=budget)
    assert (len(plan.chunks) > 1) == split
    forms = [(False, torch.float32), (False, torch.bfloat16)]
    if G & (G - 1) == 0:
        forms.append((True, torch.float32))
    for packed, out in forms:
        got = emulate_staged_k3(*imp, vt, it, lex, G, packed, out, plan)
        want = gip_candidates_plain(*imp, vt, it, lex, G, packed, out)
        _equal(got, want, packed)


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_emulated_k3_any_tile_bit_equal_to_plain(rng, tile):
    """The tile changes where a block stops (its last valid step), never
    the result; N = 1,537 with G = 4 leaves whole tiles past N."""
    B, N, lex, cls, n_imp, G = 3, 1537, 12, 4, 8, 4
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, 3, n_imp)
    vt, it = torch.from_numpy(vt), torch.from_numpy(it)
    imp = _imp(qv, qi, n_imp)
    plan = candidates_plan(*imp, lex + cls, lex, 4, 1)
    plan = dataclasses.replace(plan, chunks=(
        dataclasses.replace(plan.chunks[0], tile=tile),))
    for packed in (False, True):
        got = emulate_staged_k3(*imp, vt, it, lex, G, packed, torch.float32,
                                plan)
        _equal(got, gip_candidates_plain(*imp, vt, it, lex, G, packed,
                                         torch.float32), packed)


def _dyadic_inputs(rng, B, N, lex=16, cls=4, folds=5):
    """Values and weights multiples of 1/8, distinct weights: every f32 sum
    is exact in any order, and the two top-k orders pick the same dims."""
    D = lex + cls
    vt = (np.round(rng.random((D, N)) * 8) / 8).astype(np.float32)
    it = rng.integers(0, folds, (lex, N)).astype(np.int8)
    w = np.stack([rng.permutation(D) + 1 for _ in range(B)]) / 8 - D / 16
    qv = np.where(rng.random((B, D)) > 0.5, w, 0.0).astype(np.float32)
    qi = np.concatenate([rng.integers(0, folds, (B, lex)),
                         np.ones((B, cls))], axis=1).astype(np.int32)
    return qv, qi, vt, it


@pytest.mark.parametrize("G,packed", [(2, True), (4, True), (8, True),
                                      (3, False), (8, False)])
def test_emulated_k3_matches_pallas_interpret(rng, G, packed):
    """N a multiple of 128 G: the reference kernel's partition exactly."""
    lex, n_imp = 16, 6
    inputs = _dyadic_inputs(rng, 4, 128 * G * 3, lex)
    t = [torch.from_numpy(x) for x in inputs]
    imp = select_important(t[0], t[1], n_imp)
    plan = candidates_plan(*imp, t[2].shape[0], lex, 4, 1)
    got = emulate_staged_k3(*imp, t[2], t[3], lex, G, packed, torch.float32,
                            plan)
    want = partial_gip_candidates_pallas(
        *[jnp.asarray(x) for x in inputs], lex, n_imp, n_tile=128 * G,
        interpret=True, unroll=4, out_dtype=jnp.float32, reduce_block=G,
        packed_ids=packed)
    if packed:
        np.testing.assert_array_equal(
            got.numpy().view(np.int32),
            np.asarray(want, np.float32).view(np.int32))
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(
            got[0].numpy().view(np.int32),
            np.asarray(want[0], np.float32).view(np.int32))


@pytest.mark.parametrize("G,N", [(8, 1000), (3, 1), (4, 1537), (2, 1),
                                 (8, 1537)])
def test_emulated_k3_ragged_rows_against_numpy_block_reduce(rng, G, N):
    """Rows >= N take no part; a group without a valid row is -inf with row
    N (two planes) or j = 0 (packed)."""
    lex, n_imp = 16, 6
    inputs = _dyadic_inputs(rng, 3, N, lex)
    sums = np.asarray(_partial_gip_scores(
        *[jnp.asarray(x) for x in inputs], lex, n_imp))
    P = reduced_lanes(N, G)
    pad = np.full((3, P * G), -np.inf, np.float32)
    pad[:, :N] = sums
    x = pad.reshape(3, P // LANE, G, LANE)
    want_v = x.max(axis=2).reshape(3, P)
    j = x.argmax(axis=2).reshape(3, P)          # the first maximum
    p = np.arange(P)
    want_r = (p // LANE) * G * LANE + j * LANE + p % LANE
    want_r = np.where(np.isneginf(want_v), N, want_r)
    t = [torch.from_numpy(x) for x in inputs]
    imp = select_important(t[0], t[1], n_imp)
    plan = candidates_plan(*imp, t[2].shape[0], lex, 4, 1)
    got_v, got_r = emulate_staged_k3(*imp, t[2], t[3], lex, G, False,
                                     torch.float32, plan)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    if G & (G - 1) == 0:
        packed = emulate_staged_k3(*imp, t[2], t[3], lex, G, True,
                                   torch.float32, plan).numpy()
        np.testing.assert_array_equal(np.isneginf(packed),
                                      np.isneginf(want_v))
        np.testing.assert_array_equal(packed.view(np.int32) & (G - 1),
                                      np.where(np.isneginf(want_v), 0, j))


@pytest.mark.parametrize("G", [3, 4, 8])
def test_emulated_k3_ties_take_the_smallest_j(G):
    """Every row of a group sums to the same value: the winner is j = 0,
    the reference's first maximum."""
    N = LANE * G * 3
    vt, it = torch.ones(2, N), torch.zeros(1, N, dtype=torch.int8)
    imp = (torch.ones(1, 2), torch.tensor([[0, 1]], dtype=torch.int32),
           torch.zeros(1, 2, dtype=torch.int32))
    plan = candidates_plan(*imp, 2, 1, 4, 1)
    vals, rows = emulate_staged_k3(*imp, vt, it, 1, G, False, torch.float32,
                                   plan)
    _equal((vals, rows), gip_candidates_plain(*imp, vt, it, 1, G, False,
                                              torch.float32), False)
    p = torch.arange(3 * LANE)
    assert torch.equal(rows[0].long(), (p // LANE) * LANE * G + p % LANE)


def test_plan_argument_on_the_cpu_takes_the_plain_path(rng):
    qv, qi, vt, it = _inputs(rng, 3, 700, 8, 2, 3, 4)
    imp = _imp(qv, qi, 4)
    vt, it = torch.from_numpy(vt), torch.from_numpy(it)
    plan = candidates_plan(*imp, 10, 8, 4, 1)
    before = kernel_launches()["gip_candidates"]
    got = gip_candidates(*imp, vt, it, 8, 4, True, plan=plan)
    assert kernel_launches()["gip_candidates"] == before
    _equal(got, gip_candidates_plain(*imp, vt, it, 8, 4, True), True)


# -- the ablation tool's source patches ---------------------------------------


def _variants():
    from dhr_tpu_torch.tools import k1_ablation as abl
    for main, variants in (("partial_gip.cu", abl.K1_VARIANTS),
                           ("gip_candidates.cu", abl.K3_VARIANTS),
                           ("rerank_gip.cu", abl.K2_VARIANTS)):
        for name, edits in variants.items():
            yield pytest.param(main, edits, id=name)


@pytest.mark.parametrize("main,edits", list(_variants()))
def test_ablation_variants_patch_todays_kernels(main, edits):
    """Each variant of tools/k1_ablation.py is an edit of today's kernel
    source: every text it replaces occurs there exactly once."""
    from dhr_tpu_torch.ops import _build
    src = (_build.CSRC / main).read_text()
    for old in edits:
        assert src.count(old) == 1, old
