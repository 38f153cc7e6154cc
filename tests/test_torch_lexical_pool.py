"""The lexical head's pool (``ops/lexical_pool.py``) on the CPU.

The plain version is the eager formula the lexical head ran before the
pool existed: the bias add in the projection's dtype, the f32 softmax over
the vocabulary, the weighting by term weight x mask and the max over
positions.  It must equal that formula bit for bit, and so must the
model's lexical reps with autograd on and off, and the head's gradient.
The CUDA kernel is held against the plain version on the card in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from dhr_tpu_torch.models import BiEncoder, EncoderConfig, RetrieverConfig
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.lexical_pool import lexical_pool, lexical_pool_plain
from dhr_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _before(logits, tw, mask):
    """The lexical head's formula before the pool, written out."""
    probs = torch.softmax(logits, dim=-1, dtype=torch.float32)
    return (probs * (tw.float() * mask.float())).amax(dim=-2)


# (B, T, V, how the mask and the term weights are drawn)
POOL_CASES = {
    "one_position": (3, 1, 64, "ragged"),
    "ragged_mask": (4, 9, 97, "ragged"),
    "all_masked_passage": (3, 6, 50, "all_masked"),
    "negative_and_zero_weights": (4, 7, 64, "signs"),
    "odd_vocab": (2, 5, 1001, "ragged"),
    "bert_vocab": (2, 4, 30522, "signs"),
}


def _pool_inputs(case, dtype, seed=0):
    B, T, V, kind = POOL_CASES[case]
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.normal(0, 3, (B, T, V)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 1, V).astype(np.float32))
    tw = torch.from_numpy(rng.normal(1, 0.5, (B, T, 1)).astype(np.float32))
    lengths = rng.integers(1, T + 1, B)
    mask = torch.from_numpy(
        (np.arange(T)[None] < lengths[:, None]).astype(np.int64))
    if kind == "all_masked":
        mask[1] = 0
    if kind == "signs":
        tw[0, ::2] = -tw[0, ::2].abs()   # negative weights, some masked
        tw[1, 1] = 0.0
        tw[1, 2] = -0.0
        tw[-1] = -tw[-1].abs()           # a passage with none positive
    return proj.to(dtype), bias.to(dtype), tw.to(dtype), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_plain_pool_equals_the_eager_formula(case, dtype):
    """Bit for bit, signed zeros included, with and without autograd,
    and through the routing wrapper on the CPU (no launch counted)."""
    proj, bias, tw, mask = _pool_inputs(case, dtype)
    want = _before(proj + bias, tw, mask[..., None])
    w = tw[..., 0].float() * mask.float()
    profiling.reset()
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            for got in (lexical_pool_plain(proj, bias, w),
                        lexical_pool(proj, bias, w)):
                assert got.dtype == torch.float32
                assert torch.equal(got, want)
                assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert kernel_launches()["lexical_pool"] == 0


def _model(model_type, dtype, seed=0, **kw):
    enc = EncoderConfig.tiny(vocab_size=211, dtype=dtype)
    cfg = RetrieverConfig(model_type=model_type, encoder=enc, **kw)
    torch.manual_seed(seed)
    model = BiEncoder(cfg)
    with torch.no_grad():
        for p in model.parameters():   # no parameter at its init value
            p.add_(torch.randn_like(p) * 0.05)
    return model.encoder("passage")


def _batch(seed=1, B=4, L=10, V=211):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, V, (B, L)))
    lengths = rng.integers(2, L + 1, B)
    mask = torch.from_numpy(
        (np.arange(L)[None] < lengths[:, None]).astype(np.int64))
    return ids, mask


def _reps_before(enc, hidden, mask):
    """The lexical rep as ``_lexical_reps`` computed it before the pool."""
    tw = enc.term_weight(hidden[:, 1:])
    return _before(enc.backbone.logits(hidden[:, 1:]), tw, mask[:, 1:, None])


MODELS = {
    "dhr": dict(model_type="dhr", add_pooler=True),
    "dlr": dict(model_type="dlr"),
    "agg": dict(model_type="agg", add_pooler=True, agg_dim=48),
}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_lexical_reps_are_unchanged(family, dtype, grad):
    enc = _model(dtype=dtype, **MODELS[family])
    ids, mask = _batch()
    with torch.set_grad_enabled(grad):
        hidden = enc.hidden_states(ids, mask)
        got = enc.reps(hidden, ids, mask)
        want = _reps_before(enc, hidden, mask)
    assert torch.equal(got.lexical, want)
    assert torch.equal(torch.signbit(got.lexical), torch.signbit(want))
    cls = hidden[:, 0]
    with torch.set_grad_enabled(grad):
        cls = enc.pooler(cls) if enc.use_pooler else cls
    assert torch.equal(got.semantic, cls.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_head_gradient_is_unchanged(family, dtype):
    """With autograd on the head keeps its eager passes: the gradients of
    every parameter equal those of the formula before the pool."""
    enc = _model(dtype=dtype, **MODELS[family])
    ids, mask = _batch()
    ct = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (ids.shape[0], enc.cfg.encoder.vocab_size)).astype(np.float32))

    def grads(lexical_of):
        enc.zero_grad()
        (lexical_of() * ct).sum().backward()
        return {n: p.grad.clone() for n, p in enc.named_parameters()
                if p.grad is not None}

    def now():
        return enc(ids, mask).lexical

    def before():
        return _reps_before(enc, enc.hidden_states(ids, mask), mask)

    got, want = grads(now), grads(before)
    assert got.keys() == want.keys() and "backbone.mlm.bias" in got
    for n in got:
        assert torch.equal(got[n], want[n]), n


def test_mlm_logits_are_projection_plus_bias():
    enc = _model("dhr", torch.bfloat16)
    ids, mask = _batch()
    with torch.no_grad():
        hidden = enc.hidden_states(ids, mask)
        proj = enc.backbone.projection(hidden)
        bias = enc.backbone.mlm.bias
        assert proj.dtype == torch.bfloat16
        assert torch.equal(enc.backbone.logits(hidden),
                           proj + bias.to(proj.dtype))


@pytest.mark.parametrize("bad", ["proj_2d", "no_positions", "bias_shape",
                                 "weight_shape", "weight_dtype", "int_proj"])
def test_pool_refuses_bad_input(bad):
    proj, bias = torch.zeros(2, 3, 8), torch.zeros(8)
    w = torch.ones(2, 3)
    if bad == "proj_2d":
        proj = proj[0]
    elif bad == "no_positions":
        proj, w = proj[:, :0], w[:, :0]
    elif bad == "bias_shape":
        bias = bias[:5]
    elif bad == "weight_shape":
        w = w[:, :2]
    elif bad == "weight_dtype":
        w = w.double()
    elif bad == "int_proj":
        proj = proj.long()
    with pytest.raises((ValueError, TypeError)):
        lexical_pool(proj, bias, w)


def _spy_pool(monkeypatch):
    """Count the lexical head's calls of the pool, which it still makes."""
    from dhr_tpu_torch.models import retrievers

    calls, real = [], retrievers.lexical_pool

    def spy(*a):
        calls.append(torch.is_grad_enabled())
        return real(*a)

    monkeypatch.setattr(retrievers, "lexical_pool", spy)
    return calls


@pytest.mark.parametrize("training,grad", [(False, False), (False, True),
                                           (True, False), (True, True)])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_pool_serves_inference_alone(family, training, grad, monkeypatch):
    """The pool serves an eval-mode module with autograd off; a module in
    training (a train step's no-grad pass included) or autograd on keeps
    the eager passes.  Either way the reps are the formula's."""
    calls = _spy_pool(monkeypatch)
    enc = _model(dtype=torch.float32, **MODELS[family])
    ids, mask = _batch()
    with torch.no_grad():
        hidden = enc.hidden_states(ids, mask)
    enc.train(training)
    with torch.set_grad_enabled(grad):
        got = enc.reps(hidden, ids, mask).lexical
    want = _reps_before(enc, hidden, mask)
    assert calls == ([False] if not (training or grad) else [])
    assert torch.equal(got, want.detach())


def test_grad_cache_step_keeps_the_eager_head(monkeypatch):
    """The gradient cache's pass 1 runs without autograd in training mode:
    it must take the eager passes, as its pass 2 does, and not the pool;
    an eval-mode encode of the same model takes the pool."""
    from dhr_tpu_torch.data.collate import collate_train
    from dhr_tpu_torch.train.step import LossConfig, grad_cache_backward

    calls = _spy_pool(monkeypatch)
    enc = EncoderConfig.tiny(vocab_size=1024)
    cfg = RetrieverConfig(model_type="dhr", add_pooler=True, dlr_out_dim=96,
                          encoder=enc)
    torch.manual_seed(0)
    model = BiEncoder(cfg)
    rng = np.random.default_rng(3)
    ex = [(rng.integers(64, 1024, 5).tolist(),
           [rng.integers(64, 1024, rng.integers(2, 8)).tolist()
            for _ in range(4)], None) for _ in range(2)]
    batch = collate_train(ex, 8, 16, cls_id=1, sep_id=2)
    batch = {k: ({n: torch.as_tensor(t) for n, t in v.items()}
                 if isinstance(v, dict) else v) for k, v in batch.items()}
    model.train()
    loss = grad_cache_backward(model, cfg, LossConfig(n_passages=4,
                                                      remove_dims=64),
                               batch, seed=0, step=0, q_chunks=2, p_chunks=4)
    assert torch.isfinite(loss) and calls == []
    model.eval()
    with torch.no_grad():
        model(query=batch["query"], passage=batch["passage"])
    assert calls == [False, False]
