"""CUDA kernels K1 / K2 / K3 / K4 / K5 / K6 against their plain PyTorch
versions, on the card (K6 alone also in ``tests/test_torch_mla_attention.py``).

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
from dhr_tpu_torch.ops.mla_attention import mla_attention
from dhr_tpu_torch.ops.moe_combine import combine, moe_combine
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


# -- the decoder's MoE layer: grouped GEMMs (torch._grouped_mm) -------------


def _moe_inputs(cuda, N, E=64, H=2048, F=1408, k=6, seed=0):
    from dhr_tpu_torch.models import decoder as dec

    torch.manual_seed(seed)
    experts = dec.Experts(E, H, F, torch.bfloat16).to(cuda)
    dec.init_weights(experts, 0.006)
    gate = (torch.randn(E, H, device=cuda) * 0.006).bfloat16()
    x = torch.randn(N, H, device=cuda).bfloat16()
    idx, w = dec.route(x, gate, k)
    return experts, x, idx, w


@pytest.mark.parametrize("N", [1, 300, 4096])
def test_moe_grouped_path_matches_the_loop_on_the_card(cuda, N):
    """At DeepSeek-V2-Lite's widths (64 experts of 1,408, top 6): the
    grouped path makes no device-to-host read (sync debug mode 'error'),
    gives the same bits twice, and matches the per-expert loop within
    bf16's round-off of two GEMM kernels (2e-2 of the largest value)."""
    from dhr_tpu_torch.models import decoder as dec

    experts, x, idx, w = _moe_inputs(cuda, N)
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = dec.routed_experts_grouped(x, idx, w, experts)
            again = dec.routed_experts_grouped(x, idx, w, experts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        loop = dec.routed_experts_loop(x, idx, w, experts)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), loop.float(), rtol=2e-2,
                               atol=2e-2 * float(loop.abs().max()))


def test_moe_layer_on_the_card_reads_nothing_and_launches_three(cuda):
    """A whole MoE layer (router, routed and shared experts) over a
    batch's real rows: no host read, 3 grouped GEMMs, one K5 combine, a
    zero ``moe.host_reads`` record."""
    from dhr_tpu_torch.models import decoder as dec
    from dhr_tpu_torch.utils import profiling

    cfg = dec.DecoderConfig.deepseek_v2_lite(param_dtype=torch.bfloat16)
    torch.manual_seed(1)
    with torch.device(cuda):
        layer = dec.MoE(cfg)
    dec.init_weights(layer, 0.006)
    x = torch.randn(4, 32, 2048, device=cuda).bfloat16()
    rows = torch.arange(0, 4 * 32, 2, device=cuda)
    before = profiling.counters()
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = layer(x, rows)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = profiling.counters()
    assert after["launches.moe_grouped_mm"] - before.get(
        "launches.moe_grouped_mm", 0) == 3
    assert after["launches.moe_combine"] - before.get(
        "launches.moe_combine", 0) == 1
    assert after["moe.host_reads"] == before.get("moe.host_reads", 0)
    flat = y.reshape(-1, 2048)
    assert flat[1::2].abs().max() == 0 and flat[0::2].abs().max() > 0


# ---- K5: the MoE layer's combine ------------------------------------------

# K5 sums a token's k products in slot order, PyTorch's reduction in its
# own: each value within an ulp of its dtype at the larger of the two
# results, plus the two f32 sums' round-off (2 k 2^-24 of the sum of the
# products' magnitudes), which only a sum that cancels makes visible.  In
# 16-bit dtypes nearly every value is bit-equal (a rounding turns on the
# sum's order at ~1e-4 of them): at least 99%, which truncating instead of
# rounding would miss.


def _combine_inputs(N, k, H, dtype, seed=0, offset=0):
    """Rows in expert order (N * k, H) of ``dtype`` on the card, starting
    ``offset`` elements into their allocation, ``slot`` a random
    permutation of them (N, k) and f32 weights with zeros and
    negatives."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = torch.randn(N * k * H + offset, generator=g, device="cuda").to(
        dtype)[offset:].view(N * k, H)
    slot = torch.randperm(N * k, generator=g, device="cuda").view(N, k)
    w = torch.rand(N, k, generator=g, device="cuda") * 1.5 - 0.5
    w[::3, 0] = 0.0
    return rows, slot, w


def _combine_close(got, rows, slot, w):
    """Assert K5's ``got`` against the eager ``combine``; returns the share
    of values that are bit-equal."""
    want = combine(rows, slot, w)
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.numel() == 0:
        return 1.0
    fi = torch.finfo(got.dtype)
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(big)
    ulp = (torch.ldexp(torch.ones_like(big), e - 1) * fi.eps).clamp_min(
        fi.tiny * fi.eps)
    picked = rows[slot.reshape(-1)].view(*slot.shape, rows.shape[1])
    mag = (picked.float().abs() * w.abs()[..., None]).sum(dim=1)
    tol = ulp + 2 * slot.shape[1] * 2.0 ** -24 * mag
    gap = (got.float() - want.float()).abs()
    assert (gap <= tol).all(), float((gap / tol).max())
    return float((got == want).float().mean())


@pytest.mark.parametrize("N,k,H,dtype,offset", [
    (19000, 6, 2048, torch.bfloat16, 0),   # the dsv2 cell's batch
    (0, 6, 2048, torch.bfloat16, 0),
    (1, 6, 2048, torch.bfloat16, 0),
    (300, 1, 2048, torch.bfloat16, 0),
    (300, 2, 2048, torch.bfloat16, 0),
    (333, 6, 64, torch.bfloat16, 0),       # 8 tokens a block
    (257, 6, 61, torch.bfloat16, 0),       # H not a multiple of 8
    (129, 6, 64, torch.bfloat16, 3),       # rows not 16-byte aligned
    (100, 16, 128, torch.bfloat16, 0),     # the most slots: two groups
    (999, 6, 2048, torch.float16, 0),
    (999, 6, 2048, torch.float32, 0),
    (99, 6, 61, torch.float32, 0),
])
def test_moe_combine_kernel_matches_plain(cuda, N, k, H, dtype, offset):
    rows, slot, w = _combine_inputs(N, k, H, dtype, offset=offset)
    before = kernel_launches()["moe_combine"]
    got = moe_combine(rows, slot, w)
    torch.cuda.synchronize()
    assert kernel_launches()["moe_combine"] == before + (N > 0)
    equal = _combine_close(got, rows, slot, w)
    if dtype != torch.float32:
        assert equal >= 0.99, equal


def test_moe_combine_refuses_autograd_and_bad_input(cuda):
    rows, slot, w = _combine_inputs(4, 6, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        moe_combine(rows.requires_grad_(), slot, w)
    rows = rows.detach()
    with pytest.raises(ValueError):
        moe_combine(rows, slot.cpu(), w)                  # mixed devices
    with pytest.raises(ValueError, match="contiguous"):
        moe_combine(rows.t().contiguous().t(), slot, w)
    with pytest.raises(ValueError, match="1 to 16"):
        moe_combine(*_combine_inputs(2, 17, 64, torch.bfloat16))


def test_decoder_encode_launches_k5_once_a_moe_layer(cuda):
    """``Encoder.encode_batch`` on the decoder backbone (inference mode)
    launches K5 once per MoE layer of a batch and K6 once per layer (3 a
    ``tiny`` batch); a forward with autograd on takes the eager combine
    and the plain attention core and launches neither."""
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.models import decoder as dec
    from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig

    dc = dec.DecoderConfig.tiny(dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    cfg = RetrieverConfig(model_type="dhr", encoder=dc, add_pooler=True,
                          projection_dim=16, dlr_out_dim=64)
    torch.manual_seed(0)
    with torch.device(cuda):
        model = BiEncoder(cfg)
    dec.init_weights(model, 0.02)
    enc = Encoder(model, cfg, EncodeConfig(batch_size=4,
                                           remove_dims=1024 - 15 * 64),
                  device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1024, (4, 12))
    mask = (np.arange(12)[None] < rng.integers(3, 13, 4)[:, None]
            ).astype(np.int64)
    n_moe = sum(dc.is_moe(i) for i in range(dc.num_layers))
    before = kernel_launches()["moe_combine"]
    before_mla = kernel_launches()["mla_attention"]
    enc.encode_batch(ids, mask, "passage")
    torch.cuda.synchronize()
    assert kernel_launches()["moe_combine"] == before + n_moe
    assert dc.num_layers == 3
    assert kernel_launches()["mla_attention"] == before_mla + 3
    model.train()
    x = torch.from_numpy(ids).to(cuda)
    model.encoder("passage")(x, torch.from_numpy(mask).to(cuda))
    assert kernel_launches()["moe_combine"] == before + n_moe
    assert kernel_launches()["mla_attention"] == before_mla + 3


# ---- K6: the MLA core -------------------------------------------------------


def _mla_layer(cuda):
    """A DeepSeek-V2-Lite MLA layer in bf16 on the card (init 0.006, the
    cell's), a ragged right-padded batch of 8 x 79 and its rotary."""
    from dhr_tpu_torch.models import decoder as dec

    cfg = dec.DecoderConfig.deepseek_v2_lite(param_dtype=torch.bfloat16)
    torch.manual_seed(3)
    with torch.device(cuda):
        layer = dec.MLA(cfg)
    dec.init_weights(layer, 0.006)
    B, L = 8, 79
    x = torch.randn(B, L, cfg.hidden_size, device=cuda).bfloat16()
    lengths = torch.tensor([79, 1, 8, 40, 64, 65, 78, 17], device=cuda)
    mask = (torch.arange(L, device=cuda)[None] < lengths[:, None]).long()
    cos, sin = dec.rotary(cfg, L, cuda)
    return layer, x, mask, cos, sin


def test_mla_layer_takes_k6_without_autograd_and_reads_nothing(cuda):
    """The layer in inference launches K6 once, with no device-to-host
    read (sync debug mode 'error'), the same bits twice; with autograd on
    it takes the plain core and launches none.  The two outputs agree
    within 2^-6 of the plain one's norm (relative L2): the cores differ
    by ~2^-9 (K6) and ~2^-7 (the plain one's bf16 scores) of their scale
    against f64 (``tests/test_torch_mla_attention.py``), and o_proj mixes
    2,048 of them."""
    layer, x, mask, cos, sin = _mla_layer(cuda)
    before = kernel_launches()["mla_attention"]
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = layer(x, mask, cos, sin)
            again = layer(x, mask, cos, sin)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernel_launches()["mla_attention"] == before + 2
    assert torch.equal(got, again)
    plain = layer(x, mask, cos, sin)
    assert plain.requires_grad
    assert kernel_launches()["mla_attention"] == before + 2
    gap = (got.float() - plain.detach().float()).norm() / plain.float().norm()
    assert float(gap) <= 2.0 ** -6, float(gap)


def test_mla_attention_refuses_autograd_and_bad_input(cuda):
    layer, x, mask, cos, sin = _mla_layer(cuda)
    q = layer.q_proj(x)
    c, k_pe = layer.kv_a_proj_with_mqa(x).split([512, 64], dim=-1)
    kv = layer.kv_b_proj(layer.kv_a_layernorm(c))
    with pytest.raises(RuntimeError, match="no backward"):
        mla_attention(q, kv, k_pe, cos, sin, mask, 16, 128, layer.scale)
    q, kv, k_pe = q.detach(), kv.detach(), k_pe.detach()
    with pytest.raises(ValueError, match="one device"):
        mla_attention(q, kv, k_pe, cos, sin, mask.cpu(), 16, 128, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):
        mla_attention(q.float(), kv, k_pe, cos, sin, mask, 16, 128, 0.1)
    odd = torch.zeros(*k_pe.shape[:2], 68, device=cuda).bfloat16()[..., 4:]
    with pytest.raises(ValueError, match="pitch"):
        mla_attention(q, kv, odd, cos, sin, mask, 16, 128, 0.1)
    with pytest.raises(ValueError, match="head dims"):
        mla_attention(q[..., :-16 * 8], kv, k_pe, cos, sin, mask, 16, 128,
                      0.1)
