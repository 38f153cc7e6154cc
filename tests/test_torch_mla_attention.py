"""The MLA core (``ops/mla_attention.py``) on the CPU, and K6 on the card.

The plain version, ``mla_attention_plain``, is the eager chain the decoder's
``MLA.forward`` ran between its projections and ``o_proj``; the CPU and
autograd take it, bit for bit what the layer computed before.  K6 rotates
each interleaved rope pair in place instead of de-interleaving, reading
the first half of the rotary tables alone; the first tests hold that
rotation to ``apply_rope``'s in f32.  The wrapper refuses
what the kernel does not take on any device and sends a CPU tensor to the
plain version.

Card tests (skipped without a CUDA device; this file imports no JAX, so
``python -m pytest --noconftest tests/test_torch_mla_attention.py`` runs
them there) hold K6 against an f64 evaluation of the same function from
the same bf16 inputs (``tests/mla_reference.py``, which ``chip_smoke.py``
shares) and against the plain version.  The decoder computes on the card
in bf16 alone: ``Encoder``, the rerank scorer and the CLI refuse another
dtype there.  Tolerances, each
with its reason:

- K6 within ``2^-7`` of the output's scale of the f64 value: P is rounded
  to bf16 (2^-9 relative) before P V, and the output to bf16 (2^-9);
  its scores are f32;
- K6 no farther from the f64 value than the plain version is, plus one
  bf16 ulp of the output's scale: the plain version rounds the scores to
  bf16 twice (the product's output, the scaled score) before its softmax.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.ops import kernel_launches
from dhr_tpu_torch.ops.mla_attention import (
    HEAD_DIMS,
    apply_rope,
    causal_bias,
    mla_attention,
    mla_attention_plain,
)
from mla_reference import f64_core, mla_inputs


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(B, L, seed):
    """Ragged row lengths in [1, L], the first row full."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, B)
    lengths[0] = L
    return lengths


def _mask(B, L, seed, dtype=torch.int64):
    """Right-padded rows of :func:`_lengths`."""
    m = np.arange(L)[None] < _lengths(B, L, seed)[:, None]
    return torch.from_numpy(m).to(dtype)


def _inputs(B, L, heads, dims, seed=0, rank=16, dtype=torch.bfloat16,
            device="cpu"):
    """:func:`mla_inputs` of ``B`` ragged rows of up to ``L`` tokens."""
    return mla_inputs(_lengths(B, L, seed), heads, dims, seed=seed,
                      rank=rank, dtype=dtype, device=device)


def _old_forward(mla, x, bias, cos, sin):
    """``MLA.forward`` as it was before K6, verbatim."""
    B, L, _ = x.shape
    n = mla.n
    q = mla.q_proj(x).view(B, L, n, -1).transpose(1, 2)
    q_nope, q_pe = q.split([mla.d_nope, mla.d_rope], dim=-1)
    c, k_pe = mla.kv_a_proj_with_mqa(x).split([mla.rank, mla.d_rope], dim=-1)
    kv = mla.kv_b_proj(mla.kv_a_layernorm(c)).view(B, L, n, -1) \
        .transpose(1, 2)
    k_nope, v = kv.split([mla.d_nope, mla.d_v], dim=-1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, None], cos, sin)          # (B, 1, L, d)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, n, L, mla.d_rope)], dim=-1)
    scores = torch.matmul(q, k.transpose(-1, -2)) * mla.scale + bias
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, -1)
    return mla.o_proj(out)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_gives_its_previous_output_bit_for_bit(dtype, grad):
    """``MLA.forward`` on the CPU (``DecoderConfig.tiny``, ragged
    right-padded rows) equals the pre-K6 forward bit for bit, with
    autograd off and on."""
    cfg = DecoderConfig.tiny(dtype=dtype, param_dtype=dtype)
    torch.manual_seed(0)
    mla = dec.MLA(cfg)
    dec.init_weights(mla, 0.2)
    B, L = 5, 13
    x = torch.randn(B, L, cfg.hidden_size).to(dtype)
    mask = _mask(B, L, seed=1)
    cos, sin = dec.rotary(cfg, L, "cpu")
    with torch.set_grad_enabled(grad):
        got = mla(x, mask, cos, sin)
        want = _old_forward(mla, x, causal_bias(mask, dtype), cos, sin)
    assert got.dtype == dtype and got.requires_grad == grad
    assert torch.equal(got, want)


def test_decoder_hidden_states_are_unchanged_bit_for_bit():
    """A whole tiny decoder: its hidden states equal those of the layers
    run with the pre-K6 attention and the bias built once."""
    cfg = DecoderConfig.tiny(dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16)
    torch.manual_seed(2)
    model = dec.DecoderModel(cfg)
    B, L = 4, 11
    ids = torch.randint(3, cfg.vocab_size, (B, L))
    mask = _mask(B, L, seed=3)
    with torch.no_grad():
        got = model(ids, mask)
        x = torch.nn.functional.embedding(ids, model.embed_tokens.weight)
        bias = causal_bias(mask, cfg.dtype)
        cos, sin = dec.rotary(cfg, L, "cpu")
        for layer in model.layers:
            h = layer.input_layernorm(x)
            x = x + _old_forward(layer.self_attn, h, bias, cos, sin)
            h = layer.post_attention_layernorm(x)
            x = x + layer.mlp(h)
        want = model.norm(x)
    assert torch.equal(got, want)


def _pairwise_rope(t, cos, sin):
    """K6's rope: each interleaved pair rotated in place by the first
    halves of ``cos`` and ``sin``, in f32 with each product and sum
    rounded, returning ``t``'s dtype in interleaved order."""
    d = t.shape[-1]
    x = t.float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., :d // 2], sin[..., :d // 2]
    y0 = x0 * c + (-x1) * s
    y1 = x1 * c + x0 * s
    return torch.stack([y0, y1], dim=-1).flatten(-2).to(t.dtype)


@pytest.mark.parametrize("d,L", [(64, 129), (8, 13)])
def test_rotary_tables_repeat_their_first_half(d, L):
    """K6 reads the first half of each row of ``cos`` and ``sin``: the
    second halves of :func:`rotary`'s tables are the same values, bit for
    bit (the same angles)."""
    cfg = DecoderConfig.deepseek_v2_lite(qk_rope_head_dim=d)
    for t in dec.rotary(cfg, L, "cpu"):
        assert torch.equal(t[:, :d // 2], t[:, d // 2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,L", [(64, 79), (8, 13), (16, 200)])
def test_pairwise_rotation_is_apply_ropes_values_interleaved(d, L, dtype):
    """The rotated pairs are ``apply_rope``'s values bit for bit, in
    interleaved order (its de-interleaving permutation undone)."""
    cfg = DecoderConfig.deepseek_v2_lite(qk_rope_head_dim=d)
    cos, sin = dec.rotary(cfg, L, "cpu")
    t = torch.randn(3, 2, L, d, generator=torch.Generator().manual_seed(d))
    t = t.to(dtype)
    ref = apply_rope(t, cos, sin)
    got = _pairwise_rope(t, cos, sin)
    perm = torch.arange(d).view(2, d // 2).T.reshape(-1)  # 0, d/2, 1, ...
    assert torch.equal(got, ref[..., perm])


@pytest.mark.parametrize("d,L", [(64, 79), (8, 13), (64, 130)])
def test_pairwise_rotation_gives_apply_ropes_scores_in_f32(d, L):
    """``q_pe . k_pe`` in f32 of the pairwise rotation equals that of
    ``apply_rope``'s de-interleaved form, each over all (query, key)
    pairs: the same products summed in another order (round-off of the
    sum, 1e-6 of the sum of the products' magnitudes)."""
    cfg = DecoderConfig.deepseek_v2_lite(qk_rope_head_dim=d)
    cos, sin = dec.rotary(cfg, L, "cpu")
    g = torch.Generator().manual_seed(L)
    q, k = torch.randn(2, 4, L, d, generator=g), torch.randn(2, 1, L, d,
                                                            generator=g)
    want = apply_rope(q, cos, sin) @ apply_rope(k, cos, sin).transpose(-1,
                                                                      -2)
    got = _pairwise_rope(q, cos, sin) @ _pairwise_rope(k, cos, sin) \
        .transpose(-1, -2)
    mag = apply_rope(q, cos, sin).abs() @ apply_rope(k, cos, sin).abs() \
        .transpose(-1, -2)
    assert ((got - want).abs() <= 1e-6 * mag).all()


@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32,
                                        torch.int64, torch.float32])
def test_causal_bias_is_the_visibility_rule(mask_dtype):
    """``causal_bias``: 0 exactly where ``j <= i`` and ``mask[b, j] > 0``
    (a negative entry hides its key too), -1e9 elsewhere."""
    mask = _mask(3, 9, seed=4).to(mask_dtype)
    if mask_dtype != torch.bool:
        mask[1, 0] = -1
    got = causal_bias(mask, torch.float32)
    assert got.shape == (3, 1, 9, 9)
    for b in range(3):
        for i in range(9):
            for j in range(9):
                seen = j <= i and float(mask[b, j]) > 0
                assert float(got[b, 0, i, j]) == (0.0 if seen else -1e9)


@pytest.mark.parametrize("dims", HEAD_DIMS)
def test_plain_core_sees_only_the_visible_keys(dims):
    """The plain core under a ragged mask: changing the keys and values of
    padded positions leaves every real query's output bit-equal, changing
    those of position j leaves every query before j bit-equal, and each
    real query's output is the f64 softmax-weighted values of its
    visible keys (bf16 round-off of the scores and probabilities)."""
    B, L, n = 3, 11, 2
    q, kv, k_pe, cos, sin, mask = _inputs(B, L, n, dims, seed=5,
                                          dtype=torch.float32)
    scale = 0.2
    base = mla_attention_plain(q, kv, k_pe, cos, sin, mask, n, dims[0], scale)
    real = mask.bool()
    kv2, a2 = kv.clone(), k_pe.clone()
    kv2[~real] += 3.0
    a2[~real] -= 2.0
    moved = mla_attention_plain(q, kv2, a2, cos, sin, mask, n, dims[0],
                                scale)
    assert torch.equal(moved[real], base[real])
    j = 6
    kv3 = kv.clone()
    kv3[:, j] += 1.0
    later = mla_attention_plain(q, kv3, k_pe, cos, sin, mask, n, dims[0],
                                scale)
    assert torch.equal(later[:, :j], base[:, :j])
    assert not torch.equal(later[:, j:][real[:, j:]], base[:, j:][
        real[:, j:]])
    ref = f64_core(q, kv, k_pe, cos, sin, mask, n, dims, scale)
    torch.testing.assert_close(base[real].double(), ref[real], rtol=1e-5,
                               atol=1e-5)


def test_wrapper_on_the_cpu_is_the_plain_core():
    """Through the wrapper on the CPU: the plain version bit for bit, no
    launch counted."""
    from dhr_tpu_torch.utils import profiling

    args = _inputs(4, 13, 2, (8, 8, 8), seed=6)
    profiling.reset()
    with torch.no_grad():
        got = mla_attention(*args, 2, 8, 0.3)
    want = mla_attention_plain(*args, 2, 8, 0.3)
    assert got.shape == (4, 13, 16) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert kernel_launches()["mla_attention"] == 0


def _bad(kind):
    """Inputs that the kernel does not take, one fault each; the head
    dims of DecoderConfig.tiny otherwise."""
    n, dims = 2, (8, 8, 8)
    if kind == "head_dims":
        dims = (16, 16, 16)
    q, kv, k_pe, cos, sin, mask = _inputs(2, 9, n, dims, seed=7)
    if kind == "dtype":
        q = q.float()
    elif kind == "k_pe_dtype":
        k_pe = k_pe.half()
    elif kind == "pitch":     # k_pe rows 12 elements apart
        k_pe = torch.zeros(2, 9, 12, dtype=torch.bfloat16)[..., 4:]
    elif kind == "batch_pitch":
        k_pe = torch.zeros(9, 2, 24, dtype=torch.bfloat16)[..., 16:] \
            .transpose(0, 1)
    elif kind == "q_strided":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif kind == "cos_shape":
        cos = cos[:-1]
    elif kind == "cos_dtype":
        cos = cos.double()
    elif kind == "mask_dtype":
        mask = mask.to(torch.complex64)
    elif kind == "mask_shape":
        mask = mask[:, :-1]
    elif kind == "q_heads":
        q = q[..., :-16]
    elif kind == "kv_length":
        kv = kv[:, :-1]
    elif kind == "device_mix":
        mask = mask.to("meta")
    elif kind == "other_device":
        q, kv, k_pe, cos, sin, mask = (t.to("meta") for t in (
            q, kv, k_pe, cos, sin, mask))
    elif kind == "autograd":
        q = q.requires_grad_()
    return (q, kv, k_pe, cos, sin, mask, n, dims[0], 0.3)


@pytest.mark.parametrize("kind,match", [
    ("head_dims", "head dims"), ("dtype", "bfloat16"),
    ("k_pe_dtype", "bfloat16"), ("pitch", "pitch"),
    ("batch_pitch", "pitch"), ("q_strided", "contiguous"),
    ("cos_shape", "cos"), ("cos_dtype", "cos"), ("mask_dtype", "mask"),
    ("mask_shape", "mask"), ("q_heads", "head dims"),
    ("kv_length", "match"), ("device_mix", "one device"),
    ("other_device", "cuda or cpu"), ("autograd", "no backward")])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind, match):
    with pytest.raises((ValueError, TypeError, RuntimeError), match=match):
        mla_attention(*_bad(kind))


def _spy(monkeypatch):
    """Record which core ``MLA.forward`` calls."""
    calls = []
    for name in ("mla_attention", "mla_attention_plain"):
        real = getattr(dec, name)

        def call(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(dec, name, call)
    return calls


@pytest.mark.parametrize("grad", [False, True])
def test_a_cpu_layer_takes_the_plain_core(grad, monkeypatch):
    """On the CPU ``MLA.forward`` calls the plain core, whatever autograd
    does; no launch is counted."""
    cfg = DecoderConfig.tiny(dtype=torch.bfloat16,
                             param_dtype=torch.bfloat16)
    mla = dec.MLA(cfg)
    x = torch.randn(2, 7, cfg.hidden_size).bfloat16()
    cos, sin = dec.rotary(cfg, 7, "cpu")
    calls = _spy(monkeypatch)
    before = kernel_launches()["mla_attention"]
    with torch.set_grad_enabled(grad):
        mla(x, _mask(2, 7, seed=8), cos, sin)
    assert calls == ["mla_attention_plain"]
    assert kernel_launches()["mla_attention"] == before


# ---- the decoder's dtype on the card ---------------------------------------


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_check_card_dtype_refuses_a_non_bf16_decoder_on_the_card(dtype,
                                                                 device):
    """K6 takes bf16 alone, so a decoder that would run inference on the
    card in another compute dtype is refused, naming the way out; the CPU
    takes every dtype."""
    cfg = DecoderConfig.tiny(dtype=dtype, param_dtype=dtype)
    if device == "cuda" and dtype != torch.bfloat16:
        with pytest.raises(ValueError, match="bfloat16.*--bf16"):
            dec.check_card_dtype(cfg, device)
    else:
        dec.check_card_dtype(cfg, device)


@pytest.mark.parametrize("flags,want", [
    ([], "refused"),
    (["--bf16"], torch.bfloat16),
    (["--device", "cpu"], torch.float32),
])
def test_cli_asks_for_bf16_before_loading_a_decoder_for_the_card(
        tmp_path, flags, want):
    """A ``deepseek_v2`` checkpoint on the card without ``--bf16`` stops
    at its config, before any weight is read; with ``--bf16``, or on the
    CPU, the config is built in the dtype asked for."""
    import json

    from dhr_tpu_torch.cli.main import _model_cfg_from_args, build_parser
    from test_torch_decoder import hf_config

    (tmp_path / "config.json").write_text(json.dumps(hf_config(
        DecoderConfig.tiny())))
    args = build_parser().parse_args(
        ["encode", "--model", "dhr", "--model-name-or-path",
         str(tmp_path), "--input", "in.jsonl", "--output", "out.npz",
         *flags])
    if want == "refused":
        with pytest.raises(SystemExit, match="--bf16"):
            _model_cfg_from_args(args)
    else:
        cfg = _model_cfg_from_args(args)
        assert cfg.causal and cfg.encoder.dtype == want


# ---- K6 on the card --------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check_k6(got, args, n, dims, scale):
    """Assert K6's ``got`` against the f64 core and the plain version
    (the module docstring's tolerances); returns the two gaps over the
    output's scale."""
    plain = mla_attention_plain(*args, n, dims[0], scale)
    ref = f64_core(*args, n, dims, scale)
    assert got.shape == plain.shape and got.dtype == plain.dtype
    assert torch.isfinite(got.float()).all()
    top = float(ref.abs().max())
    gap = float((got.double() - ref).abs().max()) / top
    plain_gap = float((plain.double() - ref).abs().max()) / top
    assert gap <= 2.0 ** -7, gap
    assert gap <= plain_gap + 2.0 ** -8, (gap, plain_gap)
    return gap, plain_gap


@pytest.mark.parametrize("B,L,n,dims,mask_dtype", [
    (32, 8, 16, (128, 64, 128), torch.int64),
    (32, 79, 16, (128, 64, 128), torch.int64),
    (32, 128, 16, (128, 64, 128), torch.int64),
    (32, 200, 16, (128, 64, 128), torch.int64),
    (3, 79, 16, (128, 64, 128), torch.bool),
    (4, 12, 2, (8, 8, 8), torch.int64),
    (3, 70, 2, (8, 8, 8), torch.int32),
    (2, 1, 2, (8, 8, 8), torch.float32),
])
def test_k6_matches_the_f64_core_and_the_plain_one(cuda, B, L, n, dims,
                                                   mask_dtype):
    q, kv, k_pe, cos, sin, mask = _inputs(B, L, n, dims, seed=L,
                                          rank=512 if dims[0] == 128
                                          else 16, device=cuda)
    args = (q, kv, k_pe, cos, sin, mask.to(mask_dtype))
    m = dec.yarn_mscale(40.0, 0.707)        # DeepSeek-V2-Lite's scale
    scale = (dims[0] + dims[1]) ** -0.5 * m * m
    before = kernel_launches()["mla_attention"]
    with torch.no_grad():
        got = mla_attention(*args, n, dims[0], scale)
    torch.cuda.synchronize()
    assert kernel_launches()["mla_attention"] == before + 1
    check_k6(got, args, n, dims, scale)


def test_a_non_bf16_decoder_is_refused_on_the_card(cuda):
    """An f32 decoder: ``Encoder`` and the rerank scorer refuse it on the
    card where they are built, naming ``--bf16``; a layer run there
    anyway, autograd off, is refused by K6's wrapper; with autograd on it
    takes the plain core.  The same model encodes on the CPU."""
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.eval.rerank import make_pair_scorer
    from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig

    dc = DecoderConfig.tiny(dtype=torch.float32)
    cfg = RetrieverConfig(model_type="dhr", encoder=dc, add_pooler=True,
                          projection_dim=16, dlr_out_dim=64)
    torch.manual_seed(0)
    model = BiEncoder(cfg)
    ecfg = EncodeConfig(batch_size=4, remove_dims=1024 - 15 * 64)
    with pytest.raises(ValueError, match="bfloat16.*--bf16"):
        Encoder(model, cfg, ecfg, device=cuda)
    with pytest.raises(ValueError, match="bfloat16.*--bf16"):
        make_pair_scorer(model, cfg, remove_dims=1024 - 15 * 64,
                         device=cuda)
    mla = dec.MLA(dc).to(cuda)
    x = torch.randn(2, 7, dc.hidden_size, device=cuda)
    cos, sin = dec.rotary(dc, 7, cuda)
    mask = _mask(2, 7, seed=9).to(cuda)
    with torch.no_grad(), pytest.raises(TypeError, match="bfloat16"):
        mla(x, mask, cos, sin)
    before = kernel_launches()["mla_attention"]
    assert torch.isfinite(mla(x, mask, cos, sin)).all()
    assert kernel_launches()["mla_attention"] == before
    ids = np.random.default_rng(0).integers(3, 1024, (4, 12))
    planes = Encoder(model, cfg, ecfg, device="cpu").encode_batch(
        ids, np.ones((4, 12), np.int64), "passage")
    assert all(np.isfinite(np.asarray(p, np.float32)).all()
               for p in planes if p is not None)
