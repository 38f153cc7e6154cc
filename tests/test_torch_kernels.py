"""CUDA kernels K1 / K2 / K3 / K4 against their plain PyTorch versions, on
the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a GPU and no JAX it runs with
``python -m pytest --noconftest tests/test_torch_kernels.py``.  Dim-major
planes are built as ``DeviceIndex`` builds them (``dim_major``: a padded,
16-byte aligned row pitch).
"""

import functools

import numpy as np
import pytest
import torch

from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.gip_candidates import (
    MAX_GROUP,
    QUERY_ROWS,
    candidates_plan,
    decode_packed_candidates,
    gip_candidates,
    gip_candidates_plain,
    kernel_limits,
)
from dhr_tpu_torch.ops.lexical_pool import lexical_pool, lexical_pool_plain
from dhr_tpu_torch.ops.partial_gip import (
    partial_gip,
    partial_gip_plain,
    select_important,
    staging_plan,
)
from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain
from dhr_tpu_torch.retrieval.index import dim_major
from dhr_tpu_torch.retrieval.searcher import _ip_scores


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _planes(seed, D, lex, N, vdt, idt, n_folds=5):
    rng = np.random.default_rng(seed)
    vt = torch.from_numpy(rng.integers(-127, 128, (D, N)).astype(np.float32))
    it = torch.from_numpy(rng.integers(0, n_folds, (lex, N)))
    return vt.to(vdt), it.to(idt)


def _queries(seed, B, D, lex, n_folds=5):
    rng = np.random.default_rng(seed + 1)
    qv = np.where(rng.random((B, D)) > 0.5, rng.random((B, D)), 0.0)
    qi = np.concatenate([rng.integers(0, n_folds, (B, lex)),
                         np.ones((B, D - lex))], axis=1)
    return (torch.from_numpy(qv.astype(np.float32)),
            torch.from_numpy(qi.astype(np.int32)))


def _close(got, want, rel):
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want[torch.isfinite(want)].abs().max()), 1.0)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert float((got[fin] - want[fin]).abs().max()) <= rel * scale


def _on_card(vt, it, device):
    """Padded dim-major planes on the card from (D, N) host planes."""
    return (dim_major(vt.T.contiguous().to(device)),
            dim_major(it.T.contiguous().to(device)))


@functools.lru_cache(maxsize=1)
def _wide_rows(N, D, lex):
    """Row-major int8 value and fold planes at full width, made on the
    card (numpy would take seconds at 204,803 x 896)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(N)
    v = torch.randint(-127, 128, (N, D), generator=g, device="cuda",
                      dtype=torch.int8)
    f = torch.randint(0, 5, (N, lex), generator=g, device="cuda",
                      dtype=torch.int8)
    return v, f


@pytest.mark.parametrize("N", [16, 65, 204_800, 204_803])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float16,
                                 torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_partial_gip_kernel_matches_plain(cuda, N, vdt, idt, out):
    """Full width (D = 896, lex = 768), I = 48 and 896; N = 16 (one
    ragged tile), 65 (one 64-row tile + 1), 204,800 and 204,803.  Bit-equal
    to the plain version on the card, f32 and bf16 out."""
    D, lex, B = 896, 768, 6
    v, f = _wide_rows(N, D, lex)
    vt, it = dim_major(v.to(vdt)), dim_major(f.to(idt))
    qv, qi = _queries(0, B, D, lex)
    qi[:, :lex:7] += 256   # low byte a fold's, value beyond int8: never open
    qi[:, 1:lex:11] -= 1 << 16   # low 16 bits a fold's: never open
    for n_imp in (48, D):
        imp = [x.to(cuda) for x in select_important(qv, qi, n_imp)]
        before = kernel_launches()["partial_gip"]
        got = partial_gip(*imp, vt, it, lex, out)
        torch.cuda.synchronize()
        assert kernel_launches()["partial_gip"] == before + 1
        want = partial_gip_plain(*imp, vt, it, lex, out)
        assert torch.equal(got, want)


@pytest.mark.parametrize("N", [65, 204_803])
def test_partial_gip_kernel_split_batch(cuda, N):
    """A shared-memory budget that holds about one query's dims splits the
    batch into chunks, one launch each; the sums stay bit-equal."""
    D, lex, B = 896, 768, 6
    v, f = _wide_rows(N, D, lex)
    vt, it = dim_major(v), dim_major(f)
    qv, qi = _queries(0, B, D, lex)
    imp = [x.to(cuda) for x in select_important(qv, qi, 48)]
    plan = staging_plan(*imp, D, lex, 1, 1, smem_bytes=16 * 2 * 64)
    assert len(plan.chunks) > 1
    before = kernel_launches()["partial_gip"]
    got = partial_gip(*imp, vt, it, lex, torch.float32, plan=plan)
    torch.cuda.synchronize()
    assert kernel_launches()["partial_gip"] == before + len(plan.chunks)
    assert torch.equal(got, partial_gip_plain(*imp, vt, it, lex))


def test_ip_scores_over_a_padded_bf16_plane(cuda):
    """The dim-major ip GEMM reads the padded plane in place (bf16 x bf16
    -> f32); small integers and dyadic weights make every sum exact."""
    rng = np.random.default_rng(3)
    n, d = 1001, 96
    values = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32))
    qv = torch.from_numpy(rng.integers(-16, 17, (5, d)).astype(np.float32)
                          / 8)
    plane = dim_major(values.to(torch.bfloat16).to(cuda))
    assert plane.stride(0) == 1024
    got = _ip_scores(qv.to(cuda), plane, row_major=False)
    assert torch.equal(got.cpu(), qv @ values.T)


@pytest.mark.parametrize("K", [37, 1001])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
def test_rerank_gip_kernel_matches_plain(cuda, K, vdt, idt):
    D, lex, N, B = 20, 16, 300, 5
    vt, it = _planes(1, D, lex, N, vdt, idt)
    values, indices = vt.T.contiguous(), it.T.contiguous()
    qv, qi = _queries(1, B, D, lex)
    rows = torch.from_numpy(
        np.random.default_rng(2).integers(0, N, (B, K)).astype(np.int64))
    rows[0, 0] = N       # out of range: never read, scores -inf
    rows[1, 1] = -1
    before = kernel_launches()["rerank_gip"]
    got = rerank_gip(qv.to(cuda), qi.to(cuda), rows.to(cuda),
                     values.to(cuda), indices.to(cuda), lex)
    torch.cuda.synchronize()
    assert kernel_launches()["rerank_gip"] == before + 1
    want = rerank_gip_plain(qv, qi, rows, values, indices, lex)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("N", [4096, 4099, 20011])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
@pytest.mark.parametrize("G,packed,out", [
    (8, True, torch.float32), (8, False, torch.float32),
    (8, False, torch.bfloat16), (2, True, torch.float32),
    (3, False, torch.float32), (16, True, torch.float32)])
def test_gip_candidates_kernel_matches_plain(cuda, N, vdt, idt, G, packed,
                                             out):
    """Rows equal and scores bit-equal (the group sums are K1's exact
    sums); packed winners decode to the two-plane rows."""
    D, lex, B = 40, 32, 6
    vt, it = _planes(0, D, lex, N, vdt, idt)
    vt_d, it_d = _on_card(vt, it, cuda)
    qv, qi = _queries(0, B, D, lex)
    for n_imp in (12, D):
        imp = select_important(qv, qi, n_imp)
        imp_d = [x.to(cuda) for x in imp]
        before = kernel_launches()["gip_candidates"]
        got = gip_candidates(*imp_d, vt_d, it_d, lex, G, packed, out)
        torch.cuda.synchronize()
        assert kernel_launches()["gip_candidates"] == before + 1
        want = gip_candidates_plain(*imp, vt, it, lex, G, packed, out)
        if packed:
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))
            pos = torch.arange(got.shape[1], device=cuda).expand_as(got)
            _, rows = decode_packed_candidates(got, pos, G)
            _, rows2 = gip_candidates(*imp_d, vt_d, it_d, lex, G, False,
                                      torch.float32)
            valid = rows2 < N
            assert torch.equal(rows[valid], rows2[valid].long())
            assert bool((rows[~valid] >= N).all())
        else:
            assert torch.equal(got[1].cpu(), want[1])
            assert torch.equal(got[0].cpu().float().view(torch.int32),
                               want[0].float().view(torch.int32))


@pytest.mark.parametrize("D", [896, 890])
@pytest.mark.parametrize("vdt", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idt", [torch.int8, torch.int16])
def test_rerank_gip_kernel_full_width(cuda, D, vdt, idt):
    """D = 896 (rows of whole 16-byte words: the word path) and 890 (not:
    the element path), lex = 768; row ids out of range on both sides and
    gates beyond the folds' range."""
    lex, N, B, K = 768, 5000, 4, 1001
    v, f = _wide_rows(N, 896, lex)
    values = v[:, :D].to(vdt).contiguous()
    indices = f.to(idt)
    qv, qi = _queries(4, B, D, lex)
    qi[:, :lex:7] += 256      # low byte a fold's, value beyond int8
    qi[:, 1:lex:11] -= 1 << 16   # low 16 bits a fold's: never open
    rows = torch.from_numpy(
        np.random.default_rng(5).integers(0, N, (B, K)).astype(np.int64))
    rows[0, 0], rows[1, 17], rows[2, K - 1] = N, -1, 1 << 40
    qv, qi, rows = qv.to(cuda), qi.to(cuda), rows.to(cuda)
    before = kernel_launches()["rerank_gip"]
    got = rerank_gip(qv, qi, rows, values, indices, lex)
    torch.cuda.synchronize()
    assert kernel_launches()["rerank_gip"] == before + 1
    want = rerank_gip_plain(qv, qi, rows, values, indices, lex)
    assert bool(torch.isneginf(got[[0, 1, 2], [0, 17, K - 1]]).all())
    _close(got, want, 1e-4)


@pytest.mark.parametrize("N", [65, 204_700, 204_803])
@pytest.mark.parametrize("G", [8, 3])
@pytest.mark.parametrize("split", [False, True])
def test_gip_candidates_kernel_full_width(cuda, N, G, split):
    """D = 896, lex = 768, int8 planes; N = 204,700 leaves the last group
    block partial (and, at G = 3, whole lane tiles past N); a small
    shared-memory budget splits the batch into query chunks, one launch
    each.  Every output form bit-equal to the plain version."""
    D, lex, B = 896, 768, 6
    v, f = _wide_rows(N, D, lex)
    vt, it = dim_major(v), dim_major(f)
    qv, qi = _queries(2, B, D, lex)
    imp = [x.to(cuda) for x in select_important(qv, qi, 48)]
    plan = candidates_plan(*imp, D, lex, 1, 1,
                           smem_bytes=4096 if split else 227 * 1024)
    assert (len(plan.chunks) > 1) == split
    forms = [(False, torch.float32), (False, torch.bfloat16)]
    if G & (G - 1) == 0:
        forms.append((True, torch.float32))
    for packed, out in forms:
        before = kernel_launches()["gip_candidates"]
        got = gip_candidates(*imp, vt, it, lex, G, packed, out, plan=plan)
        torch.cuda.synchronize()
        assert kernel_launches()["gip_candidates"] == before + len(plan.chunks)
        want = gip_candidates_plain(*imp, vt, it, lex, G, packed, out)
        if packed:
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0].float().view(torch.int32),
                               want[0].float().view(torch.int32))


def test_gip_candidates_plan_limits_are_the_kernels(cuda):
    """The host plans chunks by the limits the built kernel enforces."""
    assert kernel_limits() == (QUERY_ROWS, MAX_GROUP)


@pytest.mark.parametrize("G", [3, 8])
def test_gip_candidates_kernel_ties_take_the_first_j(cuda, G):
    """Equal sums across a group: the winner is j = 0 in every group block
    (strict > over the steps, as the reference's first maximum)."""
    N = 128 * G * 5 + 77
    vt = torch.ones(2, N, dtype=torch.int8)
    it = torch.zeros(1, N, dtype=torch.int8)
    imp = (torch.ones(1, 2), torch.tensor([[0, 1]], dtype=torch.int32),
           torch.zeros(1, 2, dtype=torch.int32))
    vt_d, it_d = dim_major(vt.T.contiguous().to(cuda)), \
        dim_major(it.T.contiguous().to(cuda))
    got = gip_candidates(*[x.to(cuda) for x in imp], vt_d, it_d, 1, G, False,
                         torch.float32)
    want = gip_candidates_plain(*imp, vt, it, 1, G, False, torch.float32)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


def test_kernels_raise_on_bad_input(cuda):
    D, lex, N = 40, 32, 512
    vt, it = _planes(0, D, lex, N, torch.int8, torch.int8)
    qv, qi = _queries(0, 2, D, lex)
    imp = [x.to(cuda) for x in select_important(qv, qi, 4)]
    with pytest.raises(ValueError):
        partial_gip(*imp, vt.to(cuda).T, it.to(cuda), lex)   # not (D, N)
    odd_v, odd_i = _planes(0, D, lex, N + 3, torch.int8, torch.int8)
    for fn in (partial_gip, gip_candidates):   # contiguous, pitch N + 3
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(*imp, odd_v.to(cuda), odd_i.to(cuda), lex)
    with pytest.raises(TypeError):
        partial_gip(*imp, vt.to(cuda).to(torch.int32), it.to(cuda), lex)
    with pytest.raises(ValueError):
        partial_gip(*imp, vt.to(cuda), it, lex)              # mixed devices
    with pytest.raises(ValueError):
        gip_candidates(*imp, vt.to(cuda), it.to(cuda), lex, 3, True)
    with pytest.raises(ValueError):
        gip_candidates(*imp, vt.to(cuda), it, lex, 8, False)  # mixed devices


# ---- K4: the lexical head's pool ------------------------------------------

# The pool's sums of V exponentials run in another order than PyTorch's
# softmax (a lane adds its groups of 16, ~V / 512 of them, then a warp
# tree), and its exponential may differ from PyTorch's by an ulp or two:
# each value within 3e-5 of its own magnitude.  The floor covers values
# in the subnormal range, where a relative bound means nothing.
POOL_RTOL, POOL_ATOL = 3e-5, 1e-30


def _pool_inputs(B, T, V, dtype, pitch=None, seed=0):
    """A projection plane (B, T, V) of ``dtype`` on the card with row
    pitch ``pitch`` (>= V), the bias, and weights with a ragged mask,
    negative and zero term weights and, from B = 3 on, a passage with
    every position masked."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    P = pitch or V
    proj = (torch.randn(B, T, P, generator=g, device="cuda") * 3
            ).to(dtype)[..., :V]
    bias = torch.randn(V, generator=g, device="cuda").to(dtype)
    tw = torch.randn(B, T, generator=g, device="cuda") * 0.5 + 1
    tw[0, ::3] = -tw[0, ::3].abs()
    tw[:, 1::7] = 0.0
    lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    mask = torch.arange(T, device="cuda")[None] < lengths[:, None]
    if B >= 3:
        mask[2] = False
    return proj, bias, tw * mask.float()


def _pool_close(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=POOL_RTOL, atol=POOL_ATOL), \
        float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


@pytest.mark.parametrize("B,T,V,pitch,dtype", [
    (256, 79, 30522, None, torch.bfloat16),   # the encode cell's batch
    (1, 7, 30522, None, torch.bfloat16),
    (3, 511, 30522, None, torch.bfloat16),    # the longest rows BERT takes
    (4, 33, 30522, 30525, torch.bfloat16),    # an odd pitch: element loads
    (5, 12, 1001, None, torch.bfloat16),      # an odd vocabulary
    (2, 3, 30, 32, torch.bfloat16),           # under one strip, padded
    (3, 17, 30522, None, torch.float16),
    (3, 17, 30522, None, torch.float32),
    (3, 17, 1001, 1003, torch.float32),
])
def test_lexical_pool_kernel_matches_plain(cuda, B, T, V, pitch, dtype):
    proj, bias, w = _pool_inputs(B, T, V, dtype, pitch)
    got = lexical_pool(proj, bias, w)
    torch.cuda.synchronize()
    want = lexical_pool_plain(proj, bias, w)
    _pool_close(got, want)
    if B >= 3:   # all positions masked: the max of zeros
        assert torch.equal(got[2], torch.zeros_like(got[2]))


def test_lexical_pool_counts_one_launch_per_call(cuda):
    proj, bias, w = _pool_inputs(2, 5, 30522, torch.bfloat16)
    before = kernel_launches()["lexical_pool"]
    for _ in range(3):
        lexical_pool(proj, bias, w)
    torch.cuda.synchronize()
    assert kernel_launches()["lexical_pool"] == before + 3


def test_lexical_pool_refuses_autograd_and_bad_input(cuda):
    proj, bias, w = _pool_inputs(2, 5, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        lexical_pool(proj, bias, w.requires_grad_())
    with pytest.raises(ValueError):
        lexical_pool(proj, bias.cpu(), w.detach())      # mixed devices
    with pytest.raises(ValueError, match="contiguous"):
        lexical_pool(proj.transpose(1, 2), bias[:5],
                     torch.ones(2, 64, device="cuda"))


@pytest.mark.parametrize("family", ["dhr", "agg"])
def test_encode_goes_through_lexical_pool_without_autograd(cuda, family):
    """``Encoder.encode_batch`` (inference mode) launches K4 once a batch
    and matches the eager passes; a forward with autograd on does not
    launch it."""
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig

    cfg = RetrieverConfig(model_type=family, add_pooler=True, agg_dim=640,
                          encoder=EncoderConfig.tiny(vocab_size=30522))
    torch.manual_seed(0)
    enc = Encoder(BiEncoder(cfg), cfg, EncodeConfig(batch_size=8),
                  device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 30522, (8, 20))
    mask = (np.arange(20)[None] < rng.integers(2, 21, 8)[:, None]
            ).astype(np.int64)
    before = kernel_launches()["lexical_pool"]
    enc.encode_batch(ids, mask, "passage")
    torch.cuda.synchronize()
    assert kernel_launches()["lexical_pool"] == before + 1
    tower = enc.model.encoder("passage")
    x, m = torch.from_numpy(ids).to(cuda), torch.from_numpy(mask).to(cuda)
    with torch.no_grad():
        hidden = tower.hidden_states(x, m)
        got = tower.reps(hidden, x, m).lexical
    want = tower.reps(hidden, x, m).lexical     # autograd on: the passes
    torch.cuda.synchronize()
    assert want.requires_grad
    assert kernel_launches()["lexical_pool"] == before + 2
    _pool_close(got, want.detach())


def test_grad_cache_step_keeps_the_eager_head(cuda, monkeypatch):
    """The gradient cache's pass 1 runs in training mode without autograd:
    it takes the eager head, as its pass 2 does, so K4 does not launch and
    every chunk's pass-2 reps equal its pass-1 reps bit for bit (dropout
    on).  With dropout off the step's loss and gradients match the plain
    step's on the same batch."""
    from dhr_tpu_torch.data.collate import collate_train
    from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig
    from dhr_tpu_torch.train import step as tstep

    rng = np.random.default_rng(3)
    ex = [(rng.integers(570, 30522, 7).tolist(),
           [rng.integers(570, 30522, rng.integers(4, 20)).tolist()
            for _ in range(4)], None) for _ in range(4)]
    batch = tstep.to_device(collate_train(ex, 16, 32, cls_id=101,
                                          sep_id=102), cuda)
    loss_cfg = tstep.LossConfig(n_passages=4, remove_dims=570)

    def model_of(dropout):
        cfg = RetrieverConfig(
            model_type="dhr", add_pooler=True, dlr_out_dim=768,
            encoder=EncoderConfig.tiny(vocab_size=30522,
                                       hidden_dropout=dropout,
                                       attention_dropout=dropout))
        torch.manual_seed(0)
        return BiEncoder(cfg).to(cuda).train(), cfg

    seen, real = [], tstep._encode

    def record(model, chunk, is_query, gen):
        r = real(model, chunk, is_query, gen)
        seen.append((torch.is_grad_enabled(),
                     {f: getattr(r, f).detach().clone()
                      for f in tstep.REP_FIELDS
                      if getattr(r, f) is not None}))
        return r

    model, cfg = model_of(0.1)
    monkeypatch.setattr(tstep, "_encode", record)
    before = kernel_launches()["lexical_pool"]
    tstep.grad_cache_backward(model, cfg, loss_cfg, batch, seed=3, step=5,
                              q_chunks=2, p_chunks=4)
    torch.cuda.synchronize()
    assert kernel_launches()["lexical_pool"] == before
    first = [r for g, r in seen if not g]
    second = [r for g, r in seen if g]
    assert len(first) == len(second) == 6
    for a, b in zip(first, second):
        assert a.keys() == b.keys() and "lexical" in a
        for f in a:
            assert torch.equal(a[f], b[f]), f
    monkeypatch.setattr(tstep, "_encode", real)

    model, cfg = model_of(0.0)
    want_loss = tstep.plain_loss(model, cfg, loss_cfg, batch)[0]
    want_loss.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}
    model.zero_grad(set_to_none=True)
    # one chunk a side: the plain step's shapes, so that no fold's winner
    # turns on the rounding of other GEMM shapes (the tiny model's lexical
    # values lie close together)
    loss = tstep.grad_cache_backward(model, cfg, loss_cfg, batch, seed=0,
                                     step=0, q_chunks=1, p_chunks=1)
    assert kernel_launches()["lexical_pool"] == before
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-5, atol=0)
    got = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
    assert got.keys() == want.keys()
    for n in want:
        err = float((got[n] - want[n]).norm() / want[n].norm().clamp_min(
            1e-30))
        assert err < 1e-4, (n, err)
