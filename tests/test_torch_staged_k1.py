"""K1's staging plan, and a CPU emulation of the staged kernel built from it.

The kernel (``csrc/partial_gip.cu``) stages the batch's distinct used dim
rows (the plan's ``dims``) for a row tile in shared memory, zero past N,
and computes every query of a chunk from that copy, walking the query's
important dims in their order through the plan's keys.  The emulation does
the same with tensors: it must equal ``partial_gip_plain`` bit for bit on
non-dyadic inputs, and match the reference theta pass (the Pallas kernel in
interpret mode and the scan) at the tolerances of
``tests/test_torch_partial_gip.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dhr_tpu.ops.pallas_gip import partial_gip_scores_pallas
from dhr_tpu.retrieval.searcher import _partial_gip_scores
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.partial_gip import (
    SMEM_BYTES,
    SMEM_TWO_BLOCKS,
    kernel_entries,
    partial_gip,
    partial_gip_plain,
    pick_tile,
    select_important,
    staged_bytes,
    staging_plan,
)


def emulate_staged_kernel(imp_vals, imp_dims, imp_gates, values_T, indices_T,
                          lex_dim, out_dtype, plan):
    """The kernel's arithmetic on the CPU: per chunk, the staged rows padded
    with zeros to whole tiles; per query, its ``counts[b]`` entries in
    order (a lexical slot gated by the key's 16-bit gate), each product
    rounded before its f32 add."""
    B, n_imp = imp_vals.shape
    N = values_T.shape[1]
    entries, counts = plan.entries, plan.counts
    out = torch.empty(B, N, dtype=out_dtype)
    for c in plan.chunks:
        n_pad = -(-N // c.tile) * c.tile
        dims = c.dims.long()
        s_v = torch.zeros(dims.numel(), n_pad, dtype=values_T.dtype)
        s_v[:, :N] = values_T[dims]
        s_i = torch.zeros(c.n_lex, n_pad, dtype=indices_T.dtype)
        s_i[:, :N] = indices_T[dims[:c.n_lex]]
        for b in range(c.start, c.stop):
            acc = torch.zeros(n_pad, dtype=torch.float32)
            for i in range(int(counts[b])):
                w = entries[b, i, 0].view(torch.float32)
                key = int(entries[b, i, 1])
                slot = key & 0xFFFF
                p = s_v[slot].float() * w
                if slot < c.n_lex:
                    p = torch.where(s_i[slot].int() == key >> 16, p, 0.0)
                acc = acc + p
            out[b] = acc[:N].to(out_dtype)
    return out


def _inputs(rng, B, N, lex, cls, folds, n_imp, idx_dtype=np.int8):
    D = lex + cls
    vt = rng.standard_normal((D, N)).astype(np.float32)
    it = rng.integers(0, folds, (lex, N)).astype(idx_dtype)
    qv = np.where(rng.random((B, D)) > 0.4, rng.random((B, D)),
                  0.0).astype(np.float32)
    qi = np.concatenate([rng.integers(0, folds, (B, lex)),
                         np.ones((B, cls))], axis=1).astype(np.int32)
    return qv, qi, vt, it


def _imp(qv, qi, n_imp):
    return select_important(torch.from_numpy(qv), torch.from_numpy(qi),
                            n_imp)


# -- the plan -----------------------------------------------------------------


def _check_order(plan):
    for c in plan.chunks:
        o = plan.order[c.start:c.stop].long()
        assert sorted(o.tolist()) == list(range(c.stop - c.start))
        counts = plan.counts[c.start:c.stop][o]
        assert bool((counts[1:] >= counts[:-1]).all())


def _check_slots(plan, imp_vals, imp_dims, dim):
    used = (imp_vals != 0) & (imp_dims >= 0) & (imp_dims < dim)
    assert torch.equal(plan.slots < 0, ~used)
    for c in plan.chunks:
        dims = c.dims
        assert dims.dtype == torch.int32
        assert torch.equal(dims, torch.unique(dims))          # sorted, distinct
        s = plan.slots[c.start:c.stop]
        u = used[c.start:c.stop]
        assert torch.equal(dims[s[u].long()], imp_dims[c.start:c.stop][u])
        # every staged dim is used by a query of the chunk
        assert set(dims.tolist()) == set(imp_dims[c.start:c.stop][u].tolist())
    starts = [c.start for c in plan.chunks]
    stops = [c.stop for c in plan.chunks]
    assert starts[0] == 0 and stops[-1] == imp_vals.shape[0]
    assert starts[1:] == stops[:-1]


def test_plan_one_chunk_when_the_union_fits(rng):
    qv, qi, _, _ = _inputs(rng, 16, 8, 24, 8, 3, 12)
    imp = _imp(qv, qi, 12)
    plan = staging_plan(*imp, 32, 24, 1, 1)
    assert len(plan.chunks) == 1
    c = plan.chunks[0]
    _check_slots(plan, imp[0], imp[1], 32)
    _check_order(plan)
    assert c.n_lex == int((c.dims < 24).sum())
    assert c.tile == 128     # 32 dims fit two blocks an SM at 128 rows


@pytest.mark.parametrize("budget", [16 * 24, 16 * 36, 16 * 48])
def test_plan_splits_only_when_the_union_overflows(rng, budget):
    qv, qi, _, _ = _inputs(rng, 12, 8, 24, 8, 3, 10)
    imp = _imp(qv, qi, 10)
    plan = staging_plan(*imp, 32, 24, 1, 1, smem_bytes=budget)
    assert len(plan.chunks) > 1
    _check_slots(plan, imp[0], imp[1], 32)
    _check_order(plan)
    used = (imp[0] != 0)
    for c, nxt in zip(plan.chunks, plan.chunks[1:] + (None,)):
        n_lex = int((c.dims < 24).sum())
        assert c.n_lex == n_lex
        assert staged_bytes(c.dims.numel(), n_lex, c.tile, 1, 1) <= budget
        assert c.tile == pick_tile(c.dims.numel(), n_lex, 1, 1, budget)
        if nxt is not None:   # greedy: the next query would overflow
            grown = set(c.dims.tolist()) | set(
                imp[1][nxt.start][used[nxt.start]].tolist())
            n_l = sum(d < 24 for d in grown)
            assert pick_tile(len(grown), n_l, 1, 1, budget) is None
    assert staging_plan(*imp, 32, 24, 1, 1).chunks[0].stop == 12


def test_plan_all_zero_weights():
    imp_vals = torch.zeros(3, 5)
    imp_dims = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    plan = staging_plan(imp_vals, imp_dims, imp_dims, 20, 16, 1, 1)
    assert len(plan.chunks) == 1 and plan.chunks[0].dims.numel() == 0
    assert plan.chunks[0].n_lex == 0 and plan.chunks[0].tile == 128
    assert bool((plan.slots == -1).all())
    assert plan.counts.tolist() == [0, 0, 0]
    assert bool((plan.entries[..., 1] == 0xFFFF).all())


def test_plan_skips_dims_outside_the_planes():
    imp_vals = torch.ones(2, 3)
    imp_dims = torch.tensor([[0, -1, 5], [20, 5, 7]], dtype=torch.int32)
    plan = staging_plan(imp_vals, imp_dims, imp_dims, 8, 6, 2, 1)
    assert plan.slots.tolist() == [[0, -1, 1], [-1, 1, 2]]
    assert plan.chunks[0].dims.tolist() == [0, 5, 7]
    assert plan.chunks[0].n_lex == 2


def test_a_query_too_wide_for_any_tile_raises():
    imp_vals = torch.ones(1, 8)
    imp_dims = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="alone uses 8 dims"):
        staging_plan(imp_vals, imp_dims, imp_dims, 8, 8, 1, 1,
                     smem_bytes=16 * 15)


@pytest.mark.parametrize("n_dims,n_lex,vb,ib,tile", [
    (753, 700, 1, 1, 64),     # bench batch: 91 KB, two blocks an SM
    (896, 768, 1, 1, 64),     # every dim (theta = 0): 104 KB
    (896, 768, 2, 2, 64),     # bf16 values, int16 folds: one block an SM
    (896, 768, 4, 2, 32),     # f32 values: 160 KB, one block an SM
    (100, 90, 1, 1, 128),
    (0, 0, 1, 1, 128),
])
def test_pick_tile_at_published_widths(n_dims, n_lex, vb, ib, tile):
    assert pick_tile(n_dims, n_lex, vb, ib) == tile
    assert staged_bytes(n_dims, n_lex, tile, vb, ib) <= SMEM_BYTES
    if tile < 128:
        assert staged_bytes(n_dims, n_lex, 2 * tile, vb, ib) > \
            SMEM_TWO_BLOCKS


def test_entries_keep_the_order_and_drop_what_adds_nothing():
    """lex = 4.  Dim 1 has weight 0; dim 3's gate lies beyond int16 and
    dim 2's beyond int8, so neither can open on such folds; dims 4-6 are
    CLS, whose gates are never read."""
    imp_vals = torch.tensor([[0.5, 0.0, 0.25, 0.125, 2.0, 1.0, 4.0]])
    imp_dims = torch.tensor([[0, 1, 2, 5, 3, 4, 6]], dtype=torch.int32)
    gates = torch.tensor([[-3, 1, 200, 99999, 70000, 7, 1 << 20]],
                         dtype=torch.int32)
    for index_bytes, order in ((1, [0, 5, 4, 6]), (2, [0, 2, 5, 4, 6])):
        plan = staging_plan(imp_vals, imp_dims, gates, 8, 4, 1, index_bytes)
        assert plan.chunks[0].dims.tolist() == [0, 2, 3, 4, 5, 6]
        slot = {0: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5}
        n = len(order)
        assert plan.counts.tolist() == [n]
        w = plan.entries[0, :n, 0].view(torch.float32).tolist()
        keys = plan.entries[0, :, 1].tolist()
        weight = dict(zip(imp_dims[0].tolist(), imp_vals[0].tolist()))
        assert w == [weight[d] for d in order]                # their order
        assert [k & 0xFFFF for k in keys] == \
            [slot[d] for d in order] + [0xFFFF] * (7 - n)
        assert keys[0] >> 16 == -3                            # 16-bit gate
        if index_bytes == 2:
            assert keys[1] >> 16 == 200
        assert all(k >> 16 == 0 for k in keys[n - 3:n])     # CLS: gate 0
        entries, counts = kernel_entries(plan.slots, imp_vals, imp_dims,
                                         gates, 4, index_bytes)
        assert torch.equal(entries, plan.entries)
        assert torch.equal(counts, plan.counts)


# -- the emulated kernel ------------------------------------------------------


@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [False, True])
def test_emulated_kernel_bit_equal_to_plain(rng, vdt, idt, out, split):
    B, N, lex, cls, n_imp = 6, 333, 24, 8, 14
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, 4, n_imp)
    qi[:, :lex:3] += 256   # low byte a fold's, value beyond int8: never open
    if vdt == torch.int8:
        vt = np.clip(np.round(vt * 40), -127, 127)
    vt = torch.from_numpy(vt).to(vdt)
    it = torch.from_numpy(it).to(idt)
    imp = _imp(qv, qi, n_imp)
    vb, ib = vt.element_size(), it.element_size()
    # a split budget stages 20 dims of 16 rows: one query, not the batch
    budget = 16 * 20 * (vb + ib) if split else SMEM_BYTES
    plan = staging_plan(*imp, lex + cls, lex, vb, ib,
                        smem_bytes=budget)
    assert (len(plan.chunks) > 1) == split
    got = emulate_staged_kernel(*imp, vt, it, lex, out, plan)
    want = partial_gip_plain(*imp, vt, it, lex, out)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_imp", [7, 20])
def test_emulated_kernel_matches_pallas_and_scan(rng, n_imp):
    B, N, lex, cls = 4, 256, 16, 4
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, 5, n_imp)
    imp = _imp(qv, qi, n_imp)
    vt_t, it_t = torch.from_numpy(vt), torch.from_numpy(it)
    plan = staging_plan(*imp, lex + cls, lex, 4, 1)
    j = [jnp.asarray(x) for x in (qv, qi, vt, it)]
    want_scan = np.asarray(_partial_gip_scores(*j, lex, n_imp))
    want_pallas = np.asarray(partial_gip_scores_pallas(
        *j, lex, n_imp, n_tile=128, interpret=True))
    got = emulate_staged_kernel(*imp, vt_t, it_t, lex, torch.float32,
                                plan).numpy()
    np.testing.assert_allclose(got, want_scan, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)
    got16 = emulate_staged_kernel(*imp, vt_t, it_t, lex, torch.bfloat16,
                                  plan).float().numpy()
    want16 = np.asarray(partial_gip_scores_pallas(
        *j, lex, n_imp, n_tile=128, interpret=True,
        out_dtype=jnp.bfloat16), np.float32)
    np.testing.assert_allclose(got16, want16, rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got16, want_scan, rtol=8e-3, atol=8e-3)


def test_emulated_kernel_ragged_rows_against_scan(rng):
    """N = 301: the last tile is zero-filled past N."""
    B, N, lex, cls, n_imp = 5, 301, 12, 4, 7
    qv, qi, vt, it = _inputs(rng, B, N, lex, cls, 3, n_imp)
    imp = _imp(qv, qi, n_imp)
    plan = staging_plan(*imp, lex + cls, lex, 4, 1)
    got = emulate_staged_kernel(*imp, torch.from_numpy(vt),
                                torch.from_numpy(it), lex, torch.float32,
                                plan)
    want = _partial_gip_scores(*[jnp.asarray(x) for x in (qv, qi, vt, it)],
                               lex, n_imp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_plan_argument_on_the_cpu_takes_the_plain_path(rng):
    qv, qi, vt, it = _inputs(rng, 3, 64, 8, 2, 3, 4)
    imp = _imp(qv, qi, 4)
    vt, it = torch.from_numpy(vt), torch.from_numpy(it)
    plan = staging_plan(*imp, 10, 8, 4, 1)
    before = kernel_launches()["partial_gip"]
    got = partial_gip(*imp, vt, it, 8, torch.float32, plan=plan)
    assert kernel_launches()["partial_gip"] == before
    assert torch.equal(got, partial_gip_plain(*imp, vt, it, 8))
