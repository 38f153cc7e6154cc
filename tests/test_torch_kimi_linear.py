"""The Kimi Linear decoder (``dhr_tpu_torch/models/decoder.py``: KDA, MLA
without positions, the sigmoid router, a layer holding a share of the
experts) and the DHR retriever on it, against the plain f32 reference
``tests/kimi_linear_reference.py``, on the CPU at a tiny size
(``DecoderConfig.tiny_kimi_linear``: KDA layers 1, 2 and 4, MLA layer 3,
8 experts top-3 and one shared), seeded weights.

Bars, each with its reason:

- the chunked KDA against the token-by-token recurrence in f32 within
  rtol 1e-5 of the output's largest value: the same sums regrouped into
  chunks, a triangular solve and three products a chunk;
- the model's hidden states and DHR planes within rtol 1e-5 (atol 1e-5 of
  the largest value): f32 round-off of regrouped sums, 4 layers deep;
- routes equal exactly, as sets, and weights within 1e-6: in f32 the
  router's scores differ by round-off alone, far below their seeded gaps;
- the expert shares' sum within 1e-6 of the uncut layer: the same f32
  terms summed in another order;
- on the card, K6 without positions within 2e-2 of an f64 core (its bf16
  P V) and no further from it than the eager chain; the chunked KDA
  within 1e-4 of its CPU twin (f32 products in another order).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import kimi_linear_reference as ref
from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.models.hf_io import (
    hf_decoder_to_state_dict,
    kimi_config_from_hf,
)
from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.ops.mla_attention import mla_attention_plain

OUT_DIM, REMOVE = 64, 1024 - 15 * 64      # 15 folds of the tiny vocabulary


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread each, so test workers sharing the
    machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(dc: DecoderConfig) -> dict:
    """The ``kimi_linear`` config.json of a :class:`DecoderConfig`."""
    full = [i for i in range(1, dc.num_layers + 1)
            if i not in dc.kda_layers]
    return {
        "model_type": "kimi_linear", "vocab_size": dc.vocab_size,
        "hidden_size": dc.hidden_size, "num_hidden_layers": dc.num_layers,
        "num_attention_heads": dc.num_heads,
        "num_key_value_heads": dc.num_heads,
        "intermediate_size": dc.intermediate_size,
        "moe_intermediate_size": dc.moe_intermediate_size,
        "num_experts": dc.n_routed_experts,
        "num_shared_experts": dc.n_shared_experts,
        "num_experts_per_token": dc.num_experts_per_tok,
        "first_k_dense_replace": dc.first_k_dense_replace,
        "moe_layer_freq": dc.moe_layer_freq,
        "moe_renormalize": dc.norm_topk_prob,
        "moe_router_activation_func": dc.router,
        "routed_scaling_factor": dc.routed_scaling_factor,
        "num_expert_group": 1, "topk_group": 1, "use_grouped_topk": True,
        "q_lora_rank": None, "kv_lora_rank": dc.kv_lora_rank,
        "qk_nope_head_dim": dc.qk_nope_head_dim,
        "qk_rope_head_dim": dc.qk_rope_head_dim,
        "v_head_dim": dc.v_head_dim, "mla_use_nope": True,
        "rope_theta": dc.rope_theta, "rope_scaling": None,
        "model_max_length": dc.max_position_embeddings,
        "rms_norm_eps": dc.rms_norm_eps, "tie_word_embeddings": False,
        "hidden_act": "silu", "initializer_range": dc.initializer_range,
        "linear_attn_config": {
            "kda_layers": list(dc.kda_layers), "full_attn_layers": full,
            "num_heads": dc.kda_num_heads, "head_dim": dc.kda_head_dim,
            "short_conv_kernel_size": dc.kda_conv_size}}


def hf_weights(dc: DecoderConfig, seed: int = 0, std: float = 0.1) -> dict:
    """A seeded ``kimi_linear`` state dict under the published names (numpy
    f32, one tensor per expert) with the DHR head's tensors: weights
    ``N(0, std)``, RMSNorm scales ``1 + N(0, std)``, KDA's published inits
    (``A_log = log U(1, 16)``, ``dt_bias = softplus^-1(U(1e-3, 0.1))``,
    convolutions ``U(+-0.5)``), the correction bias ``N(0, 0.1)``, the
    term-weight bias about 2."""
    r = np.random.default_rng(seed)
    H, n = dc.hidden_size, dc.num_heads
    h, d = dc.kda_num_heads, dc.kda_head_dim
    D = h * d
    shapes = {"model.embed_tokens.weight": (dc.vocab_size, H),
              "model.norm.weight": (H,),
              "lm_head.weight": (dc.vocab_size, H),
              "term_weight.linear.weight": (1, H),
              "term_weight.linear.bias": (1,),
              "pooler.linear.weight": (16, H), "pooler.linear.bias": (16,)}
    for i in range(dc.num_layers):
        p, a = f"model.layers.{i}.", f"model.layers.{i}.self_attn."
        shapes.update({p + "input_layernorm.weight": (H,),
                       p + "post_attention_layernorm.weight": (H,)})
        if dc.is_kda(i):
            shapes.update({
                **{f"{a}{c}_proj.weight": (D, H) for c in "qkv"},
                **{f"{a}{c}_conv1d.weight": (D, 1, dc.kda_conv_size)
                   for c in "qkv"},
                a + "A_log": (1, 1, h, 1), a + "dt_bias": (D,),
                a + "f_a_proj.weight": (d, H), a + "f_b_proj.weight": (D, d),
                a + "b_proj.weight": (h, H), a + "g_a_proj.weight": (d, H),
                a + "g_b_proj.weight": (D, d), a + "g_b_proj.bias": (D,),
                a + "o_norm.weight": (d,), a + "o_proj.weight": (H, D)})
        else:
            shapes.update({
                a + "q_proj.weight": (n * (dc.qk_nope_head_dim
                                           + dc.qk_rope_head_dim), H),
                a + "kv_a_proj_with_mqa.weight": (dc.kv_lora_rank
                                                  + dc.qk_rope_head_dim, H),
                a + "kv_a_layernorm.weight": (dc.kv_lora_rank,),
                a + "kv_b_proj.weight": (n * (dc.qk_nope_head_dim
                                              + dc.v_head_dim),
                                         dc.kv_lora_rank),
                a + "o_proj.weight": (H, n * dc.v_head_dim)})
        if dc.is_moe(i):
            m = p + "block_sparse_moe."
            shapes[m + "gate.weight"] = (dc.n_routed_experts, H)
            shapes[m + "gate.e_score_correction_bias"] = (dc.n_routed_experts,)
            F_ = dc.moe_intermediate_size
            for e in range(dc.n_routed_experts):
                q = f"{m}experts.{e}."
                shapes.update({q + "w1.weight": (F_, H),
                               q + "w3.weight": (F_, H),
                               q + "w2.weight": (H, F_)})
            S = F_ * dc.n_shared_experts
            q = m + "shared_experts."
        else:
            S, q = dc.intermediate_size, p + "mlp."
        shapes.update({q + "gate_proj.weight": (S, H),
                       q + "up_proj.weight": (S, H),
                       q + "down_proj.weight": (H, S)})
    out = {}
    for name, shape in shapes.items():
        if name.endswith("A_log"):
            a = np.log(r.uniform(1, 16, shape))
        elif name.endswith("dt_bias"):
            dt = r.uniform(1e-3, 1e-1, shape)
            a = dt + np.log(-np.expm1(-dt))
        elif name.endswith("conv1d.weight"):
            a = r.uniform(-0.5, 0.5, shape)
        else:
            a = r.normal(0.0, std, shape)
            if name.endswith("norm.weight"):
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
    dc = DecoderConfig.tiny_kimi_linear(dtype=torch.float32)
    sd = hf_weights(dc)
    W = {k: torch.from_numpy(v) for k, v in sd.items()}
    return dc, sd, W, port_model(dc, sd)


def scan_inputs(B, L, h=3, d=8, seed=0, decay=2.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, L, h, d, generator=g) for _ in range(3))
    gl = -torch.rand(B, L, h, d, generator=g) * decay
    beta = torch.rand(B, L, h, generator=g)
    return q, k, v, gl, beta


def recurrence(q, k, v, g, beta):
    d = k.shape[-1]
    return ref.kda_recurrence(ref.l2norm(q.float()) * d ** -0.5,
                              ref.l2norm(k.float()), v.float(), g, beta)


@pytest.mark.parametrize("L", [1, 63, 64, 65, 130])
def test_chunked_kda_equals_the_recurrence(L, monkeypatch):
    """Row 0 is ``L`` real positions; row 1 is ``L // 2 + 1`` real ones
    padded to ``L``: each real output equals the recurrence over the row's
    real positions alone, and whatever the pads hold changes none."""
    q, k, v, g, beta = scan_inputs(2, L, seed=L)
    n1 = L // 2 + 1
    monkeypatch.setattr(dec, "KDA_BLOCK_BYTES", 1 << 16)
    got = dec.kda_scan(q, k, v, g, beta)
    assert got.shape == (2, L, 3, 8) and got.dtype == torch.float32
    full = recurrence(q[:1], k[:1], v[:1], g[:1], beta[:1])
    part = recurrence(q[1:, :n1], k[1:, :n1], v[1:, :n1], g[1:, :n1],
                      beta[1:, :n1])
    for have, want in ((got[0], full[0]), (got[1, :n1], part[0])):
        torch.testing.assert_close(have, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    other = [t.clone() for t in (q, k, v, g, beta)]
    for t in other:
        t[1, n1:] = torch.randn_like(t[1, n1:]).abs().neg()
    moved = dec.kda_scan(*other)
    torch.testing.assert_close(moved[1, :n1], got[1, :n1], rtol=1e-6,
                               atol=1e-6 * float(got.abs().max()))


def test_the_chunk_blocks_do_not_change_the_result(monkeypatch):
    """One block of all chunks or a block a chunk: the same state passed
    on, the same output within round-off."""
    args = scan_inputs(2, 200, seed=3)
    one = dec.kda_scan(*args)
    monkeypatch.setattr(dec, "KDA_BLOCK_BYTES", 1)
    many = dec.kda_scan(*args)
    torch.testing.assert_close(one, many, rtol=1e-6,
                               atol=1e-6 * float(one.abs().max()))


def test_a_strongly_decaying_a_log_stays_finite(tiny):
    """``A_log`` = log 1,000 and large ``dt_bias``: cumulative log-decays
    of ~-10^5 in a chunk, every exponent taken <= 0, so no inf or nan, and
    the scan still equals the recurrence."""
    q, k, v, g, beta = scan_inputs(1, 150, seed=9, decay=4000.0)
    got = dec.kda_scan(q, k, v, g, beta)
    assert torch.isfinite(got).all()
    want = recurrence(q, k, v, g, beta)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    dc, _, _, _ = tiny
    layer = dec.KDA(dc)
    dec.init_weights(layer, 0.3)
    with torch.no_grad():
        layer.A_log.fill_(np.log(1000.0))
        layer.dt_bias.fill_(8.0)
        out = layer(torch.randn(2, 130, dc.hidden_size))
    assert torch.isfinite(out).all()


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


def test_layer_kinds_and_spans_follow_the_config(tiny):
    from dhr_tpu_torch.utils import profiling

    dc, _, _, model = tiny
    layers = model.encoder_q.backbone.model.layers
    assert [type(layer.self_attn).__name__ for layer in layers] == [
        "KDA", "KDA", "MLA", "KDA"]
    assert [type(layer.mlp).__name__ for layer in layers] == [
        "MLP", "MoE", "MoE", "MoE"]
    profiling.reset()
    ids, mask = batch()
    with torch.no_grad():
        model.encoder_q(ids, mask)
    assert len(profiling.spans("kda.attention")) == 3
    assert len(profiling.spans("kda.scan")) == 3
    assert len(profiling.spans("mla.attention")) == 1
    assert len(profiling.spans("moe.route")) == 3


def test_the_sigmoid_router_matches_the_reference():
    """Choice by score + bias, weights the chosen scores renormalised x
    2.446; the bias moves the choice away from the plain top-k."""
    g = torch.Generator().manual_seed(4)
    E, H, k, N = 16, 32, 4, 50
    x = torch.randn(N, H, generator=g)
    gate = torch.randn(E, H, generator=g) * 0.3
    bias = torch.randn(E, generator=g) * 0.5
    idx, w = dec.route_sigmoid(x, gate, bias, k, 2.446)
    cfg = {"num_experts_per_token": k, "moe_renormalize": True,
           "routed_scaling_factor": 2.446}
    plain = torch.topk(torch.sigmoid(x @ gate.T), k).indices
    assert any(set(a.tolist()) != set(b.tolist())
               for a, b in zip(idx, plain))
    for t in range(N):
        want_i, want_w = ref.route(cfg, x[t], gate, bias)
        assert set(idx[t].tolist()) == set(want_i.tolist())
        torch.testing.assert_close(w[t].sort().values,
                                   want_w.sort().values, rtol=1e-6,
                                   atol=1e-7)
    torch.testing.assert_close(w.sum(-1), torch.full((N,), 2.446))


def _moe(dc, sd, layer, held):
    """The port's MoE of ``layer`` holding ``held`` (None: all), loaded
    from ``sd`` through hf_io."""
    cfg = DecoderConfig.tiny_kimi_linear(dtype=torch.float32,
                                         experts_held=held)
    state = hf_decoder_to_state_dict(sd, cfg)
    moe = dec.MoE(cfg)
    p = f"model.layers.{layer}.mlp."
    moe.load_state_dict({k.removeprefix(p): v for k, v in state.items()
                         if k.startswith(p)}, strict=True)
    return moe


@pytest.mark.parametrize("grouped", [False, True])
def test_held_expert_shares_add_up_to_the_whole_layer(tiny, grouped):
    """The share test: the two halves' held-expert parts, with the shared
    expert (which each computes whole) counted once, equal the uncut
    layer; and each half equals the reference told to hold that half."""
    dc, sd, W, _ = tiny
    layer = 2
    x = torch.randn(3, 7, dc.hidden_size, generator=torch.Generator()
                    .manual_seed(2))
    mask = torch.ones(3, 7, dtype=torch.long)
    whole, low, high = (_moe(dc, sd, layer, h)
                        for h in (None, (0, 4), (4, 8)))
    shared = whole.shared_experts(x)

    def run(m):
        if not grouped:
            return m(x)
        t = x.reshape(-1, dc.hidden_size)
        idx, w = m.gate(t)
        y = dec.routed_experts_grouped(t, idx, w, m.experts, m.first)
        return (y + m.shared_experts(t)).view(x.shape)

    with torch.no_grad():
        full, a, b = run(whole), run(low), run(high)
    torch.testing.assert_close(a + b - shared, full, rtol=1e-6,
                               atol=1e-6 * float(full.abs().max()))
    m = f"model.layers.{layer}.block_sparse_moe."
    for got, held in ((a, (0, 4)), (b, (4, 8))):
        want = ref.moe(hf_config(dc), W, m, x, mask, held)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    assert low.experts.gate_proj.shape[0] == 4


def test_a_share_with_no_slot_held_adds_nothing():
    """Every token routed away from the held experts: the grouped path's
    unwritten rows are never read, the routed part is exactly 0."""
    torch.manual_seed(0)
    experts = dec.Experts(4, 16, 8, torch.float32)
    dec.init_weights(experts, 0.2)
    x = torch.randn(9, 16)
    idx = torch.tensor([[5, 6, 7]] * 9)
    w = torch.rand(9, 3)
    with torch.no_grad():
        y = dec.routed_experts_grouped(x, idx, w, experts, first=0)
    assert torch.equal(y, torch.zeros_like(y))


def test_nope_mla_is_softmax_attention_without_positions():
    """MLA's plain core given the identity tables: causal softmax of
    ``[q_nope | q_pe] . [k_nope | k_pe]`` at the given scale over the real
    keys, unrotated, in f64."""
    dc = DecoderConfig.tiny_kimi_linear(dtype=torch.float32)
    dn, dr, dv, n = 8, 8, 8, 2
    B, L = 2, 9
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, L, n * (dn + dr), generator=g)
    kv = torch.randn(B, L, n * (dn + dv), generator=g)
    k_pe = torch.randn(B, L, dr, generator=g)
    mask = torch.ones(B, L, dtype=torch.long)
    mask[1, 6:] = 0
    cos, sin = dec.position_tables(dc, L, "cpu")
    assert torch.equal(cos, torch.ones(L, dr))
    assert torch.equal(sin, torch.zeros(L, dr))
    scale = (dn + dr) ** -0.5
    assert dec.MLA(dc).scale == scale
    got = mla_attention_plain(q, kv, k_pe, cos, sin, mask, n, dn, scale)
    qh = q.double().view(B, L, n, dn + dr)
    kvh = kv.double().view(B, L, n, dn + dv)
    kh = torch.cat([kvh[..., :dn],
                    k_pe.double()[:, :, None].expand(B, L, n, dr)], -1)
    s = torch.einsum("bind,bjnd->bnij", qh, kh) * scale
    ok = torch.ones(L, L, dtype=torch.bool).tril()[None, None] \
        & (mask[:, None, None, :] > 0)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), -1)
    want = torch.einsum("bnij,bjnd->bind", p, kvh[..., dn:]).reshape(B, L, -1)
    real = mask.bool()
    torch.testing.assert_close(got[real].double(), want[real], rtol=1e-5,
                               atol=1e-6)


def test_kimi_config_round_trips_and_refuses_what_it_lacks(tiny):
    dc, _, _, _ = tiny
    hf = hf_config(dc)
    assert kimi_config_from_hf(hf, torch.float32) == dc
    assert kimi_config_from_hf(hf, torch.float32, experts_held=(0, 4)) \
        == DecoderConfig.tiny_kimi_linear(dtype=torch.float32,
                                          experts_held=(0, 4))
    full = DecoderConfig.kimi_linear_48b_a3b()
    assert (full.num_layers, len(full.kda_layers), full.n_routed_experts,
            full.num_experts_per_tok) == (27, 20, 256, 8)
    assert [i for i in range(27) if not full.is_kda(i)] == [
        3, 7, 11, 15, 19, 23, 26]
    for key, value in (("mla_use_nope", False), ("num_expert_group", 2),
                       ("q_lora_rank", 64),
                       ("moe_router_activation_func", "tanh")):
        with pytest.raises(ValueError, match=key):
            kimi_config_from_hf({**hf, key: value})
    with pytest.raises(ValueError, match="experts_held"):
        DecoderConfig.tiny_kimi_linear(experts_held=(4, 9))


def test_kimi_checkpoint_loads_through_the_encode_verb(tmp_path, tiny):
    """A tiny ``kimi_linear`` checkpoint written by the test (two
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

    ids, mask = batch(seed=7, lengths=(9, 70, 3, 66))
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
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_k6_without_positions_at_32_heads(cuda):
    """K6 given the identity tables at Kimi Linear's 32 heads of (128, 64,
    128) and 2,048 positions, against an f64 core and the eager chain."""
    from mla_reference import f64_core, mla_inputs

    from dhr_tpu_torch.ops.mla_attention import mla_attention

    dims, n = (128, 64, 128), 32
    q, kv, k_pe, _, _, mask = mla_inputs([2048, 1500], n, dims, seed=3,
                                         device="cuda")
    cos, sin = dec.position_tables(DecoderConfig.kimi_linear_48b_a3b(),
                                   2048, "cuda")
    scale = 192 ** -0.5
    with torch.no_grad():
        got = mla_attention(q, kv, k_pe, cos, sin, mask, n, 128, scale)
        chain = mla_attention_plain(q, kv, k_pe, cos, sin, mask, n, 128,
                                    scale)
    want = f64_core(q, kv, k_pe, cos, sin, mask, n, dims, scale)
    real = mask.bool()
    top = float(want[real].abs().max())
    gap = float((got[real].double() - want[real]).abs().max()) / top
    chain_gap = float((chain[real].double() - want[real]).abs().max()) / top
    assert gap < 2e-2 and gap <= chain_gap, (gap, chain_gap)


def test_chunked_kda_on_the_card_matches_its_cpu_twin(cuda):
    """The chunked scan at the cell's largest bucket (2,048 positions, 32
    heads of 128, a short row padded) on the card against the same on the
    CPU, both f32."""
    args = scan_inputs(2, 2048, h=32, d=128, seed=5)
    for t in args:
        t[1, 1500:] = 0.0
    want = dec.kda_scan(*args)
    got = dec.kda_scan(*(t.to(cuda) for t in args))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def test_a_held_share_on_the_card_matches_the_cpu_loop(cuda):
    """The grouped path holding experts 2-5 of 8 on the card (bf16; the
    slots of other experts a group no GEMM computes) against the CPU's
    loop over the same share in f32 from the same weights; a batch with no
    slot held gives exactly 0."""
    torch.manual_seed(0)
    experts = dec.Experts(4, 256, 128, torch.bfloat16)
    dec.init_weights(experts, 0.05)
    x = torch.randn(300, 256).to(torch.bfloat16)
    gate, bias = torch.randn(8, 256) * 0.1, torch.randn(8) * 0.1
    idx, w = dec.route_sigmoid(x, gate, bias, 3, 2.446)
    with torch.no_grad():
        want = dec.routed_experts_loop(x.float(), idx, w, experts.float(),
                                       first=2)
        got = dec.routed_experts_grouped(x.to(cuda), idx.to(cuda),
                                         w.to(cuda), experts.to(cuda),
                                         first=2)
        none = dec.routed_experts_grouped(
            x.to(cuda), torch.full_like(idx, 7).to(cuda), w.to(cuda),
            experts, first=2)
    torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2,
                               atol=2e-2 * float(want.abs().max()))
    assert torch.equal(none, torch.zeros_like(none))


def test_long_documents_bucket_in_steps_of_256():
    """Above the reference's largest bucket (512) documents pad to the next
    multiple of 256, up to ``max_len``: the Kimi cell's 2,048-token
    documents do not all pad to 2,048."""
    from dhr_tpu_torch.encode import plan_length_buckets

    plan, _ = plan_length_buckets([600, 700, 1100, 1900, 2048, 300], 1,
                                  2048)
    assert [b for _, b in plan] == [384, 768, 768, 1280, 2048, 2048]
    plan, _ = plan_length_buckets([600, 3000], 2, 1000)
    assert [b for _, b in plan] == [1000]
