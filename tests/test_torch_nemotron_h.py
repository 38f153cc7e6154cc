"""The Nemotron-H decoder (``dhr_tpu_torch/models/decoder.py``: blocks of
one mixer each, Mamba-2 and its chunked SSD scan, attention with grouped
key / value heads and no positions, relu^2 experts) and the DHR retriever
on it, against the plain f32 reference ``tests/nemotron_h_reference.py``,
on the CPU at a tiny size (``DecoderConfig.tiny_nemotron_h``: blocks
``MEM*EME``, 4 Mamba heads of 8 with state 16 in 2 groups and chunks of
16, 4 query and 2 key / value heads of 8, 8 relu^2 experts top-3 and one
shared), seeded weights.

Bars, each with its reason:

- the chunked SSD scan against the token-by-token recurrence in f32
  within rtol 1e-5 of the output's largest value: the same sums regrouped
  into chunks; with decays of about -10 a token over half of each chunk
  too (a cumulative log-decay near -640 before positions that still weigh
  about 1), where a difference of two cumulative sums reads 5e-5 off;
- the model's hidden states and DHR planes within rtol 1e-5 (atol 1e-5 of
  the largest value): f32 round-off of regrouped sums, 7 blocks deep;
- a right-padded batch's real positions within 1e-6 of each row run
  alone: causal order keeps the pads out, so only the batched products'
  round-off differs;
- the relu^2 grouped path within 1e-6 of its loop twin: the same f32
  products, gathered in another order;
- on the card, the SDPA core within 2e-2 of an f64 one (bf16 P V) and the
  chunked scan within 1e-4 of its CPU twin (f32 products in another
  order).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import nemotron_h_reference as ref
from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.models.hf_io import (
    hf_decoder_to_state_dict,
    nemotron_h_config_from_hf,
    nemotron_h_state_dict_to_hf,
)
from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.utils import profiling

OUT_DIM, REMOVE = 64, 1024 - 15 * 64      # 15 folds of the tiny vocabulary
# the published config.json's keys (the model-configs catalog's row)
PUBLISHED = {
    "attention_bias": False, "chunk_size": 128, "conv_kernel": 4,
    "expand": 2, "head_dim": 128, "hidden_size": 2688,
    "hybrid_override_pattern":
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    "intermediate_size": 1856, "layer_norm_epsilon": 1e-05,
    "mamba_head_dim": 64, "mamba_hidden_act": "silu", "mamba_num_heads": 64,
    "mamba_proj_bias": False, "max_position_embeddings": 262144,
    "mlp_bias": False, "mlp_hidden_act": "relu2", "model_type": "nemotron_h",
    "moe_intermediate_size": 1856,
    "moe_shared_expert_intermediate_size": 3712, "n_group": 1,
    "n_groups": 8, "n_routed_experts": 128, "n_shared_experts": 1,
    "norm_eps": 1e-05, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts_per_tok": 6, "num_hidden_layers": 52,
    "num_key_value_heads": 2, "num_logits_to_keep": 1,
    "partial_rotary_factor": 1, "rescale_prenorm_residual": True,
    "residual_in_fp32": False, "rope_theta": 10000,
    "routed_scaling_factor": 2.5, "sliding_window": None,
    "ssm_state_size": 128, "tie_word_embeddings": False,
    "time_step_floor": 0.0001, "time_step_max": 0.1, "time_step_min": 0.001,
    "topk_group": 1, "use_bias": False, "use_conv_bias": True,
    "use_mamba_kernels": True, "vocab_size": 131072}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(dc: DecoderConfig) -> dict:
    """The ``nemotron_h`` config.json of a :class:`DecoderConfig`."""
    return {
        "model_type": "nemotron_h", "vocab_size": dc.vocab_size,
        "hidden_size": dc.hidden_size, "num_hidden_layers": dc.num_layers,
        "hybrid_override_pattern": dc.hybrid_override_pattern,
        "num_attention_heads": dc.num_heads,
        "num_key_value_heads": dc.num_key_value_heads,
        "head_dim": dc.head_dim, "attention_bias": False,
        "mamba_num_heads": dc.mamba_num_heads,
        "mamba_head_dim": dc.mamba_head_dim,
        "ssm_state_size": dc.ssm_state_size, "n_groups": dc.n_groups,
        "conv_kernel": dc.conv_kernel, "use_conv_bias": True,
        "chunk_size": dc.chunk_size, "mamba_hidden_act": "silu",
        "mamba_proj_bias": False, "use_bias": False,
        "intermediate_size": dc.intermediate_size,
        "moe_intermediate_size": dc.moe_intermediate_size,
        "moe_shared_expert_intermediate_size":
            dc.moe_shared_expert_intermediate_size,
        "n_routed_experts": dc.n_routed_experts,
        "n_shared_experts": dc.n_shared_experts,
        "num_experts_per_tok": dc.num_experts_per_tok, "n_group": 1,
        "topk_group": 1, "norm_topk_prob": dc.norm_topk_prob,
        "routed_scaling_factor": dc.routed_scaling_factor,
        "mlp_hidden_act": "relu2", "mlp_bias": False,
        "layer_norm_epsilon": dc.rms_norm_eps,
        "max_position_embeddings": dc.max_position_embeddings,
        "rope_theta": dc.rope_theta, "residual_in_fp32": False,
        "sliding_window": None, "tie_word_embeddings": False,
        "initializer_range": dc.initializer_range}


def hf_weights(dc: DecoderConfig, seed: int = 0, std: float = 0.1) -> dict:
    """A seeded ``nemotron_h`` state dict under the checkpoint's names
    (numpy f32, one tensor per expert) with the DHR head's tensors:
    weights ``N(0, std)``, norm scales ``1 + N(0, std)``, Mamba-2's
    published inits (``A_log = log(1..h)``, ``dt_bias =
    softplus^-1(exp U(log 1e-3, log 0.1))``) with ``D = 1 + N(0, std)``,
    the convolution's weight and bias ``U(+-0.5)``, the correction bias
    ``N(0, 0.1)``, the term-weight bias about 2."""
    r = np.random.default_rng(seed)
    H = dc.hidden_size
    h, P, g, N = (dc.mamba_num_heads, dc.mamba_head_dim, dc.n_groups,
                  dc.ssm_state_size)
    D, conv = h * P, h * P + 2 * g * N
    n, kv, d = dc.num_heads, dc.num_key_value_heads, dc.head_dim
    shapes = {"backbone.embeddings.weight": (dc.vocab_size, H),
              "backbone.norm_f.weight": (H,),
              "lm_head.weight": (dc.vocab_size, H),
              "term_weight.linear.weight": (1, H),
              "term_weight.linear.bias": (1,),
              "pooler.linear.weight": (16, H), "pooler.linear.bias": (16,)}
    for i, kind in enumerate(dc.hybrid_override_pattern):
        p = f"backbone.layers.{i}."
        a = p + "mixer."
        shapes[p + "norm.weight"] = (H,)
        if kind == "M":
            shapes.update({a + "in_proj.weight": (D + conv + h, H),
                           a + "conv1d.weight": (conv, 1, dc.conv_kernel),
                           a + "conv1d.bias": (conv,), a + "dt_bias": (h,),
                           a + "A_log": (h,), a + "D": (h,),
                           a + "norm.weight": (D,),
                           a + "out_proj.weight": (H, D)})
        elif kind == "*":
            shapes.update({a + "q_proj.weight": (n * d, H),
                           a + "k_proj.weight": (kv * d, H),
                           a + "v_proj.weight": (kv * d, H),
                           a + "o_proj.weight": (H, n * d)})
        else:
            E, F_ = dc.n_routed_experts, dc.moe_intermediate_size
            S = dc.moe_shared_expert_intermediate_size
            shapes.update({a + "gate.weight": (E, H),
                           a + "gate.e_score_correction_bias": (E,),
                           a + "shared_experts.up_proj.weight": (S, H),
                           a + "shared_experts.down_proj.weight": (H, S)})
            for e in range(E):
                shapes.update({f"{a}experts.{e}.up_proj.weight": (F_, H),
                               f"{a}experts.{e}.down_proj.weight": (H, F_)})
    out = {}
    for name, shape in shapes.items():
        if name.endswith("A_log"):
            a = np.log(np.arange(1, shape[0] + 1, dtype=np.float64))
        elif name.endswith("dt_bias"):
            dt = np.exp(r.uniform(np.log(1e-3), np.log(0.1), shape))
            a = dt + np.log(-np.expm1(-dt))
        elif name.endswith(("conv1d.weight", "conv1d.bias")):
            a = r.uniform(-0.5, 0.5, shape)
        else:
            a = r.normal(0.0, std, shape)
            if name.endswith(("norm.weight", "norm_f.weight", ".D")):
                a += 1.0
            elif name == "term_weight.linear.bias":
                a += 2.0
        out[name] = a.astype(np.float32)
    return out


def port_model(dc: DecoderConfig, sd: dict) -> BiEncoder:
    cfg = RetrieverConfig(model_type="dhr", encoder=dc, add_pooler=True,
                          projection_dim=16, dlr_out_dim=OUT_DIM)
    model = BiEncoder(cfg)
    enc = model.encoder_q
    enc.backbone.load_state_dict(hf_decoder_to_state_dict(sd, dc),
                                 strict=True)
    for head in ("term_weight", "pooler"):
        getattr(enc, head).linear.load_state_dict({
            k: torch.from_numpy(sd[f"{head}.linear.{k}"]).to(dc.param_dtype)
            for k in ("weight", "bias")})
    return model


def batch(seed: int = 1, lengths=(9, 5, 12, 3)):
    """Right-padded rows: BOS 1, content ids, EOS 2."""
    r = np.random.default_rng(seed)
    L = max(lengths) + 2
    ids = np.zeros((len(lengths), L), np.int64)
    mask = np.zeros_like(ids)
    for b, n in enumerate(lengths):
        ids[b, :n + 2] = [1, *r.integers(3, 1024, n), 2]
        mask[b, :n + 2] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def tiny():
    dc = DecoderConfig.tiny_nemotron_h(dtype=torch.float32)
    sd = hf_weights(dc)
    W = {k: torch.from_numpy(v) for k, v in sd.items()}
    return dc, sd, W, port_model(dc, sd)


def scan_inputs(B, L, h=4, P=8, g=2, N=16, seed=0, rate=1.0):
    """Post-convolution-like inputs; ``dt A`` about ``-rate`` a token on
    average over the heads."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, h, P, generator=gen)
    Bm, Cm = (torch.randn(B, L, g, N, generator=gen) for _ in range(2))
    dt = torch.rand(B, L, h, generator=gen) * 2 * rate / (h + 1) * 2
    A = -torch.arange(1, h + 1, dtype=torch.float32)
    D = 1 + torch.randn(h, generator=gen) * 0.1
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("L", [1, 15, 16, 17, 40])
def test_chunked_ssd_equals_the_recurrence(L):
    """Row 0 is ``L`` real positions; row 1 is ``L // 2 + 1`` real ones
    padded to ``L``, straddling the chunks of 16: each real output equals
    the recurrence over the row's real positions alone, and whatever the
    pads hold changes none."""
    x, dt, A, B, C, D = scan_inputs(2, L, seed=L)
    n1 = L // 2 + 1
    got = dec.ssd_scan(x, dt, A, B, C, D, chunk=16)
    assert got.shape == (2, L, 4, 8) and got.dtype == torch.float32
    full = ref.ssd_recurrence(x[:1], dt[:1], A, B[:1], C[:1], D)
    part = ref.ssd_recurrence(x[1:, :n1], dt[1:, :n1], A, B[1:, :n1],
                              C[1:, :n1], D)
    for have, want in ((got[0], full[0]), (got[1, :n1], part[0])):
        torch.testing.assert_close(have, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    other = [t.clone() for t in (x, dt, B, C)]
    for t in other:
        t[1, n1:] = torch.rand_like(t[1, n1:]) * 3
    moved = dec.ssd_scan(other[0], other[1], A, other[2], other[3], D,
                         chunk=16)
    torch.testing.assert_close(moved[1, :n1], got[1, :n1], rtol=1e-6,
                               atol=1e-6 * float(got.abs().max()))


def test_strong_decays_sum_each_exponent_over_its_span():
    """``dt A`` about -10 a token over the first half of each chunk of
    128, then about -1e-3: the cumulative log-decay is near -640 where the
    second half's many positions still weigh about 1 on each other, and a
    difference of two cumulative sums there keeps only ~1e-4 of each such
    exponent.  Summed over its span each stays exact: the scan equals the
    recurrence (in f64) to 1e-5 of the scale, with nothing inf or nan."""
    x, dt, A, B, C, D = scan_inputs(2, 256, seed=9)
    gen = torch.Generator().manual_seed(10)
    first = (torch.arange(256) % 128 < 64)[None, :, None]
    rate = torch.where(first, 10.0, 1e-3)
    dt = rate / -A * (0.5 + torch.rand(2, 256, 4, generator=gen))
    assert float((dt * A)[:, :64].mean()) < -9.0
    got = dec.ssd_scan(x, dt, A, B, C, D, chunk=128)
    assert torch.isfinite(got).all()
    want = ref.ssd_recurrence(*(t.double() for t in (x, dt, A, B, C, D)))
    torch.testing.assert_close(got.double(), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_the_chunk_blocks_do_not_change_the_result(monkeypatch):
    """One block of all chunks or a block a chunk: the same states passed
    on, the same output within round-off."""
    args = scan_inputs(2, 100, seed=3)
    one = dec.ssd_scan(*args, chunk=16)
    monkeypatch.setattr(dec, "SSD_BLOCK_BYTES", 1)
    many = dec.ssd_scan(*args, chunk=16)
    torch.testing.assert_close(one, many, rtol=1e-6,
                               atol=1e-6 * float(one.abs().max()))


@pytest.mark.parametrize("real_rows", [False, True])
def test_hidden_states_and_reps_match_the_reference(tiny, real_rows):
    dc, _, W, model = tiny
    ids, mask = batch()
    rows = torch.nonzero(mask.reshape(-1))[:, 0] if real_rows else None
    enc = model.encoder_q
    with torch.no_grad():
        hidden = enc.hidden_states(ids, mask, real_rows=rows)
        reps = enc.reps(hidden, ids, mask)
    want_h, lex, sem = ref.dhr_reps(hf_config(dc), W, ids, mask)
    real = mask.bool()
    torch.testing.assert_close(hidden[real], want_h[real], rtol=1e-5,
                               atol=1e-5 * float(want_h.abs().max()))
    torch.testing.assert_close(reps.lexical, lex, rtol=1e-5,
                               atol=1e-5 * float(lex.abs().max()))
    torch.testing.assert_close(reps.semantic, sem, rtol=1e-5,
                               atol=1e-5 * float(sem.abs().max()))


def test_a_padded_batch_equals_each_row_alone(tiny):
    """Lengths 1, 15, 16, 17 and 40 (straddling the chunks of 16) right-
    padded into one batch: every real position's hidden state equals the
    row's run alone, unpadded."""
    dc, _, _, model = tiny
    lengths = (1, 15, 16, 17, 40)
    ids, mask = batch(seed=5, lengths=[n - 2 if n > 2 else 0
                                       for n in lengths])
    ids, mask = ids[:, :40], mask[:, :40]
    ids[0, 1:] = 0
    mask[0, 1:] = 0
    assert mask.sum(1).tolist() == [1, 15, 16, 17, 40]
    enc = model.encoder_q
    rows = torch.nonzero(mask.reshape(-1))[:, 0]
    with torch.no_grad():
        padded = enc.hidden_states(ids, mask, real_rows=rows)
        for b, n in enumerate(lengths):
            alone = enc.hidden_states(ids[b:b + 1, :n], mask[b:b + 1, :n])
            torch.testing.assert_close(padded[b, :n], alone[0], rtol=1e-6,
                                       atol=1e-6 * float(alone.abs().max()))


def test_blocks_and_spans_follow_the_pattern(tiny):
    dc, _, _, model = tiny
    layers = model.encoder_q.backbone.model.layers
    assert [type(b.mixer).__name__ for b in layers] == [
        "Mamba2", "MoE", "Mamba2", "GQA", "MoE", "Mamba2", "MoE"]
    moe = layers[1].mixer
    assert not moe.experts.gated and not hasattr(moe.experts, "gate_proj")
    assert not moe.shared_experts.gated
    assert not hasattr(moe.shared_experts, "gate_proj")
    assert moe.shared_experts.up_proj.weight.shape == (24, 32)
    profiling.reset()
    ids, mask = batch()
    with torch.no_grad():
        model.encoder_q(ids, mask)
    assert len(profiling.spans("mamba.mixer")) == 3
    assert len(profiling.spans("mamba.scan")) == 3
    assert len(profiling.spans("gqa.attention")) == 1
    assert len(profiling.spans("moe.route")) == 3
    for name in ("mla.attention", "kda.attention", "kda.scan"):
        assert not profiling.spans(name), name
    profiling.reset()


@pytest.mark.parametrize("relu2", [True, False])
def test_the_grouped_path_matches_the_loop_and_counts_its_gemms(relu2):
    """relu^2 experts take two grouped GEMMs a layer (SwiGLU's three, as
    before), and equal the loop twin over the same experts."""
    torch.manual_seed(0)
    experts = dec.Experts(8, 16, 12, torch.float32,
                          "relu2" if relu2 else "silu")
    dec.init_weights(experts, 0.2)
    x = torch.randn(40, 16)
    idx, w = dec.route_sigmoid(x, torch.randn(8, 16) * 0.3,
                               torch.randn(8) * 0.1, 3, 2.5)
    profiling.reset()
    with torch.no_grad():
        got = dec.routed_experts_grouped(x, idx, w, experts)
        assert profiling.counters()["launches.moe_grouped_mm"] == \
            (2 if relu2 else 3)
        want = dec.routed_experts_loop(x, idx, w, experts)
    profiling.reset()
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    if relu2:
        e = int(idx[0, 0])
        up, down = experts.weights(torch.float32)
        one = torch.relu(x[0] @ up[e].T).square() @ down[e].T
        alone = dec.routed_experts_loop(x[:1], idx[:1, :1],
                                        torch.ones(1, 1), experts)
        torch.testing.assert_close(alone[0], one, rtol=1e-6, atol=1e-7)


def test_gqa_is_causal_softmax_attention_without_positions():
    """The plain core: query head ``j`` against key / value head ``j //
    2``, causal softmax at ``d ** -0.5``, against f64 einsums."""
    g = torch.Generator().manual_seed(1)
    B, n, kv, L, d = 2, 4, 2, 9, 8
    q = torch.randn(B, n, L, d, generator=g)
    k, v = (torch.randn(B, kv, L, d, generator=g) for _ in range(2))
    got = dec.gqa_attention_plain(q, k, v, d ** -0.5)
    kh, vh = (t.double().repeat_interleave(n // kv, dim=1) for t in (k, v))
    s = torch.einsum("bnid,bnjd->bnij", q.double(), kh) * d ** -0.5
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    want = torch.einsum("bnij,bnjd->bnid", p, vh)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_the_published_config_and_its_round_trip(tiny):
    dc, _, _, _ = tiny
    assert nemotron_h_config_from_hf(hf_config(dc), torch.float32) == dc
    full = DecoderConfig.nemotron_3_nano_30b_a3b()
    assert nemotron_h_config_from_hf(PUBLISHED) == full
    pattern = full.hybrid_override_pattern
    assert (pattern.count("M"), pattern.count("E"), pattern.count("*")) \
        == (23, 23, 6)
    assert [i + 1 for i, c in enumerate(pattern) if c == "*"] == [
        6, 13, 20, 27, 34, 43]
    with torch.device("meta"):
        lm = dec.DecoderLM(full)
    assert sum(p.numel() for p in lm.parameters()) == 31_577_937_344
    mixer = lm.model.layers[0].mixer
    assert mixer.in_proj.weight.shape == (4096 + 6144 + 64, 2688)
    assert mixer.conv1d.bias.shape == (6144,)
    for key, value in (("hybrid_override_pattern", "M-" * 26),
                       ("n_group", 8), ("mlp_hidden_act", "silu"),
                       ("attention_bias", True), ("sliding_window", 4096),
                       ("use_conv_bias", False), ("time_step_limit", [0, 5]),
                       ("tie_word_embeddings", True)):
        with pytest.raises(ValueError, match=key):
            nemotron_h_config_from_hf({**PUBLISHED, key: value})
    with pytest.raises(ValueError, match="hybrid_override_pattern"):
        DecoderConfig.tiny_nemotron_h(hybrid_override_pattern="MEM*EM")
    with pytest.raises(ValueError, match="bfloat16"):
        dec.check_card_dtype(full.__class__.nemotron_3_nano_30b_a3b(
            dtype=torch.float32), "cuda")
    dec.check_card_dtype(full, "cuda")


def test_names_round_trip_to_the_checkpoint_layout(tiny):
    """Checkpoint -> port -> checkpoint gives every backbone tensor back
    under its name (each expert's projections split out of their stack),
    norms, ``A_log``, ``dt_bias`` and ``D`` in f32."""
    dc, sd, _, model = tiny
    state = hf_decoder_to_state_dict(sd, dc)
    assert state["model.layers.1.mixer.experts.up_proj"].shape == (8, 16, 32)
    assert set(state) == set(model.encoder_q.backbone.state_dict())
    back = nemotron_h_state_dict_to_hf(state, dc)
    body = {k: v for k, v in sd.items()
            if not k.startswith(("term_weight", "pooler"))}
    assert set(back) == set(body)
    for k, v in body.items():
        assert torch.equal(back[k], torch.from_numpy(v)), k
    bf = hf_decoder_to_state_dict(sd, DecoderConfig.tiny_nemotron_h(
        param_dtype=torch.bfloat16))
    for name in ("model.layers.0.mixer.A_log", "model.layers.0.mixer.D",
                 "model.layers.0.mixer.dt_bias", "model.layers.0.norm.weight",
                 "model.layers.0.mixer.norm.weight", "model.norm.weight",
                 "model.layers.1.mixer.gate.e_score_correction_bias"):
        assert bf[name].dtype == torch.float32, name
    assert bf["model.layers.0.mixer.conv1d.bias"].dtype == torch.bfloat16


def test_nemotron_checkpoint_loads_through_the_encode_verb(tmp_path, tiny):
    """A tiny ``nemotron_h`` checkpoint written by the test (two
    safetensors shards with an index, the published names, and the DHR
    sidecars) goes down the ``encode`` verb's bucketed path; its planes
    equal the f32 reference's."""
    from safetensors.numpy import save_file

    from dhr_tpu_torch.cli.main import main as cli
    from dhr_tpu_torch.models.hf_io import save_sidecar_head
    from dhr_tpu_torch.retrieval.index import PackedIndex

    dc, sd, W, _ = tiny
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(hf_config(dc)))
    body = {k: v for k, v in sd.items()
            if not k.startswith(("term_weight", "pooler"))}
    keys = sorted(body)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    for f, ks in shards.items():
        save_file({k: body[k] for k in ks}, str(ckpt / f))
    (ckpt / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    for name, key, out in (("TermWeightTrans", "term_weight", 1),
                           ("pooler", "pooler", 16)):
        lin = torch.nn.Linear(dc.hidden_size, out)
        lin.weight.data = W[f"{key}.linear.weight"].clone()
        lin.bias.data = W[f"{key}.linear.bias"].clone()
        save_sidecar_head(str(ckpt), name, lin, None, dc.hidden_size, out)

    ids, mask = batch(seed=7, lengths=(9, 40, 3, 36))
    corpus = tmp_path / "corpus.jsonl"
    with open(corpus, "w") as f:
        for i, row in enumerate(ids.tolist()):
            n = int(mask[i].sum())
            f.write(json.dumps({"text_id": str(i), "text": row[1:n - 1]})
                    + "\n")
    out = tmp_path / "enc.npz"
    cli(["encode", "--model", "dhr", "--add-pooler", "--projection-dim",
         "16", "--dlr-out-dim", str(OUT_DIM), "--remove-dims", str(REMOVE),
         "--model-name-or-path", str(ckpt), "--input", str(corpus),
         "--output", str(out), "--cls-token-id", "1", "--sep-token-id", "2",
         "--length-bucketing", "--device", "cpu", "--p-max-len", "80",
         "--batch-size", "2"])
    got = PackedIndex.load(str(out))
    _, lex, sem = ref.dhr_reps(hf_config(dc), W, ids, mask)
    want_v, _ = densify(lex, OUT_DIM, REMOVE)
    order = [int(d) for d in got.docids]
    vals = got.values.astype(np.float32)
    np.testing.assert_allclose(vals[:, :OUT_DIM], want_v.numpy()[order],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(vals[:, OUT_DIM:], sem.numpy()[order],
                               rtol=2e-3, atol=2e-3 * float(sem.abs().max()))


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (SDPA and the scan on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_sdpa_gqa_at_the_published_widths(cuda):
    """The card's core (SDPA, causal, 32 query heads over 2 key / value
    heads of 128, bf16) at 2,048 positions against an f64 one; no further
    from it than the plain twin."""
    g = torch.Generator().manual_seed(3)
    B, n, kv, L, d = 2, 32, 2, 2048, 128
    q = torch.randn(B, n, L, d, generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn(B, kv, L, d, generator=g).to(cuda, torch.bfloat16)
            for _ in range(2))
    with torch.no_grad():
        got = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=d ** -0.5, enable_gqa=True)
        plain = dec.gqa_attention_plain(q, k, v, d ** -0.5)
        want = ref.causal_gqa(*(t.double().transpose(1, 2)
                                for t in (q, k, v)), d ** -0.5
                              ).transpose(1, 2)
    top = float(want.abs().max())
    gap = float((got.double() - want).abs().max()) / top
    plain_gap = float((plain.double() - want).abs().max()) / top
    assert gap < 2e-2 and gap <= 2 * plain_gap + 1e-3, (gap, plain_gap)


def test_the_scan_on_the_card_matches_its_cpu_twin(cuda):
    """The chunked scan at the cell's largest bucket (2,048 positions, 64
    heads of 64, 8 groups of state 128, chunks of 128, a short row padded)
    on the card against the same on the CPU, both f32."""
    args = scan_inputs(2, 2048, h=64, P=64, g=8, N=128, seed=5, rate=0.5)
    for t in (args[0], args[1], args[3], args[4]):
        t[1, 1500:] = 0.0
    want = dec.ssd_scan(*args, chunk=128)
    got = dec.ssd_scan(*(t.to(cuda) for t in args), chunk=128)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_relu2_moe_on_the_card(cuda):
    """A relu^2 MoE layer on the card (bf16, two grouped GEMMs and one K5
    launch) against the CPU loop over the same weights in f32."""
    from dhr_tpu_torch import ops

    torch.manual_seed(0)
    cfg = DecoderConfig.tiny_nemotron_h(hidden_size=256,
                                        moe_intermediate_size=128,
                                        moe_shared_expert_intermediate_size=64,
                                        param_dtype=torch.bfloat16)
    moe = dec.MoE(cfg)
    dec.init_weights(moe, 0.05)
    x = torch.randn(3, 100, 256).to(torch.bfloat16)
    profiling.reset()
    with torch.no_grad():
        got = moe.to(cuda)(x.to(cuda))
        grouped = profiling.counters()["launches.moe_grouped_mm"]
        launches = ops.kernel_launches()["moe_combine"]
        want = moe.cpu().float()(x.float())
    profiling.reset()
    assert (grouped, launches) == (2, 1)
    torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))
