"""The decoder backbone (``dhr_tpu_torch/models/decoder.py``) and the DHR
retriever on it, against the plain f32 reference ``tests/decoder_reference
.py``, on the CPU at a tiny size (3 layers: 1 dense + 2 MoE, 8 experts
top-2 plus 1 shared, small MLA widths, YaRN on), seeded weights.

Bars, each with its reason:

- hidden states and DHR reps in f32 within rtol 1e-5 (and atol 1e-5 of
  the largest value): the same f32 maths summed in another order (the
  reference attends, routes and sums token by token) differs by round-off
  of a few ulps a layer, 3 layers deep;
- routes equal exactly, as sets: in f32 the gate scores differ by
  round-off alone, far below the seeded gaps between them;
- the grouped path equal to the per-expert loop within rtol 1e-6: one
  f32 product each, blocked differently;
- YaRN's frequencies within rtol 1e-6 of the closed form in float64: f32
  rounding of a power and a ramp.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from decoder_reference import dhr_reps as ref_dhr_reps
from decoder_reference import yarn_inv_freq
from dhr_tpu_torch.encode import EncodeConfig, Encoder
from dhr_tpu_torch.models import decoder as dec
from dhr_tpu_torch.models.decoder import DecoderConfig
from dhr_tpu_torch.models.hf_io import (
    decoder_config_from_hf,
    hf_decoder_to_state_dict,
)
from dhr_tpu_torch.models.retrievers import BiEncoder, RetrieverConfig
from dhr_tpu_torch.models.transformer import EncoderConfig
from dhr_tpu_torch.ops.densify import densify
from dhr_tpu_torch.utils import profiling
from oracle import densify_oracle

OUT_DIM, REMOVE = 64, 1024 - 15 * 64      # 15 folds of the tiny vocabulary


def hf_config(dc: DecoderConfig) -> dict:
    """The ``deepseek_v2`` config.json of a :class:`DecoderConfig`."""
    return {
        "model_type": "deepseek_v2", "vocab_size": dc.vocab_size,
        "hidden_size": dc.hidden_size, "num_hidden_layers": dc.num_layers,
        "num_attention_heads": dc.num_heads,
        "num_key_value_heads": dc.num_heads,
        "intermediate_size": dc.intermediate_size,
        "moe_intermediate_size": dc.moe_intermediate_size,
        "n_routed_experts": dc.n_routed_experts,
        "n_shared_experts": dc.n_shared_experts,
        "num_experts_per_tok": dc.num_experts_per_tok,
        "first_k_dense_replace": dc.first_k_dense_replace,
        "moe_layer_freq": dc.moe_layer_freq,
        "norm_topk_prob": dc.norm_topk_prob,
        "routed_scaling_factor": dc.routed_scaling_factor,
        "q_lora_rank": None, "kv_lora_rank": dc.kv_lora_rank,
        "qk_nope_head_dim": dc.qk_nope_head_dim,
        "qk_rope_head_dim": dc.qk_rope_head_dim,
        "v_head_dim": dc.v_head_dim, "rope_theta": dc.rope_theta,
        "rope_scaling": {
            "type": "yarn", "factor": dc.rope_factor,
            "original_max_position_embeddings":
                dc.rope_original_max_position,
            "beta_fast": dc.rope_beta_fast, "beta_slow": dc.rope_beta_slow,
            "mscale": dc.rope_mscale,
            "mscale_all_dim": dc.rope_mscale_all_dim},
        "max_position_embeddings": dc.max_position_embeddings,
        "rms_norm_eps": dc.rms_norm_eps, "topk_method": "greedy",
        "scoring_func": "softmax", "n_group": 1, "topk_group": 1,
        "tie_word_embeddings": False, "hidden_act": "silu",
        "attention_bias": False,
        "initializer_range": dc.initializer_range}


def hf_weights(dc: DecoderConfig, seed: int = 0, std: float = 0.1) -> dict:
    """A seeded ``deepseek_v2`` state dict (numpy f32, one tensor per
    expert) with the DHR head's tensors: weights ``N(0, std)``, RMSNorm
    scales ``1 + N(0, std)``, the term-weight bias about 2."""
    r = np.random.default_rng(seed)
    H, n = dc.hidden_size, dc.num_heads
    shapes = {"model.embed_tokens.weight": (dc.vocab_size, H),
              "model.norm.weight": (H,),
              "lm_head.weight": (dc.vocab_size, H),
              "term_weight.linear.weight": (1, H),
              "term_weight.linear.bias": (1,),
              "pooler.linear.weight": (16, H), "pooler.linear.bias": (16,)}
    for i in range(dc.num_layers):
        p, a = f"model.layers.{i}.", f"model.layers.{i}.self_attn."
        shapes.update({
            p + "input_layernorm.weight": (H,),
            p + "post_attention_layernorm.weight": (H,),
            a + "q_proj.weight": (n * (dc.qk_nope_head_dim
                                       + dc.qk_rope_head_dim), H),
            a + "kv_a_proj_with_mqa.weight": (dc.kv_lora_rank
                                              + dc.qk_rope_head_dim, H),
            a + "kv_a_layernorm.weight": (dc.kv_lora_rank,),
            a + "kv_b_proj.weight": (n * (dc.qk_nope_head_dim
                                          + dc.v_head_dim), dc.kv_lora_rank),
            a + "o_proj.weight": (H, n * dc.v_head_dim)})
        mlps = {p + "mlp.": dc.intermediate_size}
        if dc.is_moe(i):
            shapes[p + "mlp.gate.weight"] = (dc.n_routed_experts, H)
            mlps = {f"{p}mlp.experts.{e}.": dc.moe_intermediate_size
                    for e in range(dc.n_routed_experts)}
            mlps[p + "mlp.shared_experts."] = (dc.moe_intermediate_size
                                               * dc.n_shared_experts)
        for q, w in mlps.items():
            shapes.update({q + "gate_proj.weight": (w, H),
                           q + "up_proj.weight": (w, H),
                           q + "down_proj.weight": (H, w)})
    out = {}
    for name, shape in shapes.items():
        a = r.normal(0.0, std, shape).astype(np.float32)
        if name.endswith("norm.weight"):
            a += 1.0
        elif name == "term_weight.linear.bias":
            a += 2.0
        out[name] = a
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
    dc = DecoderConfig.tiny(dtype=torch.float32)
    sd = hf_weights(dc)
    ref = {k: torch.from_numpy(v) for k, v in sd.items()}
    return dc, sd, ref, port_model(dc, sd)


@pytest.mark.parametrize("real_rows", [False, True])
def test_hidden_states_and_reps_match_the_reference(tiny, real_rows):
    dc, _, ref, model = tiny
    ids, mask = batch()
    rows = torch.from_numpy(np.flatnonzero(mask.numpy())) if real_rows \
        else None
    routes = []
    h_ref, lex_ref, sem_ref = ref_dhr_reps(hf_config(dc), ref, ids, mask,
                                           routes)
    enc = model.encoder_q
    with torch.no_grad():
        h = enc.hidden_states(ids, mask, real_rows=rows)
        reps = enc(ids, mask, real_rows=rows)
    real = mask.bool()
    torch.testing.assert_close(h[real], h_ref[real], rtol=1e-5,
                               atol=1e-5 * float(h_ref.abs().max()))
    for got, want in ((reps.lexical, lex_ref), (reps.semantic, sem_ref)):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_routes_match_the_reference_as_sets(tiny, monkeypatch):
    dc, _, ref, model = tiny
    ids, mask = batch(seed=3)
    want = []
    ref_dhr_reps(hf_config(dc), ref, ids, mask, want)
    got = []
    real = np.flatnonzero(mask.numpy())
    route = dec.route

    def recording(x, *a, **k):
        idx, w = route(x, *a, **k)
        got.append(idx.clone())
        return idx, w

    monkeypatch.setattr(dec, "route", recording)
    with torch.no_grad():
        model.encoder_q(ids, mask, real_rows=torch.from_numpy(real))
    L = ids.shape[1]
    moe_layers = [i for i in range(dc.num_layers) if dc.is_moe(i)]
    assert len(got) == len(moe_layers)
    mine = {(i, int(r) // L, int(r) % L, frozenset(idx.tolist()))
            for i, layer in zip(moe_layers, got)
            for r, idx in zip(real, layer)}
    assert mine == set(want) and len(want) == len(moe_layers) * len(real)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_path_equals_the_per_expert_loop(dtype):
    torch.manual_seed(0)
    E, H, F_, k, N = 8, 32, 16, 2, 37
    experts = dec.Experts(E, H, F_, dtype)
    dec.init_weights(experts, 0.2)
    gate = torch.randn(E, H, dtype=dtype) * 0.5
    x = torch.randn(N, H, dtype=dtype)
    idx, w = dec.route(x, gate, k)
    torch.set_grad_enabled(False)
    before = profiling.counters().get("launches.moe_grouped_mm", 0)
    grouped = dec.routed_experts_grouped(x, idx, w, experts)
    again = dec.routed_experts_grouped(x, idx, w, experts)
    assert profiling.counters()["launches.moe_grouped_mm"] - before == 6
    loop = dec.routed_experts_loop(x, idx, w, experts)
    torch.set_grad_enabled(True)
    assert torch.equal(grouped, again)             # deterministic
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(grouped.float(), loop.float(), rtol=tol,
                               atol=tol * float(loop.abs().max()))


def test_dispatch_orders_rows_by_expert_and_inverts():
    idx = torch.tensor([[3, 0], [0, 2], [3, 1], [2, 0]])
    d = dec.dispatch(idx, 5)
    assert d.offs.tolist() == [3, 4, 6, 8, 8]
    assert d.token.tolist() == [0, 1, 3, 2, 1, 3, 0, 2]
    # each (token, slot)'s ordered row holds that token
    assert (d.token[d.slot] == torch.arange(4)[:, None]).all()


def test_yarn_inv_freq_matches_the_closed_form():
    dc = DecoderConfig.deepseek_v2_lite()
    assert dec.yarn_range(dc) == (10, 23)     # floor 10.47, ceil 22.5
    got = dec.inv_freq(dc, "cpu").double()
    want = yarn_inv_freq(hf_config(dc))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * np.log(40) + 1
    assert abs(dec.MLA(DecoderConfig.tiny()).scale
               - (16 ** -0.5) * m * m) < 1e-12
    cos, sin = dec.rotary(dc, 4, "cpu")
    assert cos.dtype == torch.float32 and cos.shape == (4, 64)
    torch.testing.assert_close(cos[1, :32], torch.cos(got.float()))


def test_semantic_rep_reads_the_last_real_token(tiny):
    dc, _, _, model = tiny
    ids, mask = batch(seed=5, lengths=(7, 3))
    enc = model.encoder_q
    with torch.no_grad():
        h = enc.hidden_states(ids, mask)
        reps = enc(ids, mask)
        last = mask.sum(1) - 1
        want = enc.pooler(h[torch.arange(2), last]).float()
        torch.testing.assert_close(reps.semantic, want)
        padded = ids.clone()
        padded[1, 5:] = 77                   # pads carry other ids
        # (the pads share the experts' matmuls: round-off alone differs)
        torch.testing.assert_close(enc(padded, mask).semantic,
                                   reps.semantic, rtol=1e-6, atol=1e-7)
        moved = ids.clone()
        moved[1, int(last[1])] = 5          # the EOS slot itself
        assert not torch.equal(enc(moved, mask).semantic[1],
                               reps.semantic[1])


def test_densify_at_the_decoder_vocabulary():
    lex = torch.rand(2, 102400)
    vals, folds = densify(lex, 768, 256)
    assert (102400 - 256) // 768 == 133 and (102400 - 256) % 768 == 0
    assert int(folds.max()) <= 132 and folds.to(torch.uint8).max() == \
        folds.max()
    want_v, want_f = densify_oracle(lex.numpy(), 768, 256)
    np.testing.assert_allclose(vals.numpy(), want_v, rtol=0)
    np.testing.assert_array_equal(folds.numpy(), want_f)


def test_a_resident_model_passes_through_the_encoder_without_a_copy():
    dc = DecoderConfig.tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    cfg = RetrieverConfig(model_type="dhr", encoder=dc, add_pooler=True,
                          projection_dim=16, dlr_out_dim=OUT_DIM)
    model = BiEncoder(cfg)
    norms = [p for n, p in model.named_parameters() if "norm" in n]
    assert norms and all(p.dtype == torch.float32 for p in norms)
    assert all(p.dtype == torch.bfloat16 for n, p in
               model.named_parameters() if "norm" not in n
               and "term_weight" not in n and "pooler" not in n)
    ptrs = [p.data_ptr() for p in model.parameters()]
    enc = Encoder(model, cfg, EncodeConfig(batch_size=4, remove_dims=REMOVE),
                  device="cpu")
    assert enc.model is model
    assert [p.data_ptr() for p in enc.model.parameters()] == ptrs
    ids, mask = batch()
    vals, folds = enc.encode_batch(ids.numpy(), mask.numpy(), "passage")
    assert vals.shape == (4, OUT_DIM + 16) and folds.dtype == torch.uint8
    assert torch.isfinite(vals.float()).all()


def test_the_bert_encoder_path_still_copies():
    cfg = RetrieverConfig(model_type="dhr", add_pooler=True,
                          encoder=EncoderConfig.tiny(dtype=torch.float32),
                          projection_dim=16, dlr_out_dim=64)
    model = BiEncoder(cfg)
    enc = Encoder(model, cfg, EncodeConfig(batch_size=4, remove_dims=0),
                  device="cpu")
    assert enc.model is not model
    theirs = {p.data_ptr() for p in model.parameters()}
    assert not theirs & {p.data_ptr() for p in enc.model.parameters()}


def test_encoder_routes_the_real_tokens_alone(tiny, monkeypatch):
    dc, _, _, model = tiny
    cfg = model.cfg
    enc = Encoder(model, cfg, EncodeConfig(batch_size=4, remove_dims=REMOVE),
                  device="cpu")
    seen = []
    route = dec.route

    def recording(x, *a, **k):
        seen.append(x.shape[0])
        return route(x, *a, **k)

    monkeypatch.setattr(dec, "route", recording)
    ids, mask = batch()
    enc.encode_batch(ids.numpy(), mask.numpy(), "passage")
    assert seen == [int(mask.sum())] * 2


def test_packed_rows_and_colbert_raise_on_the_decoder(tiny):
    dc, _, _, model = tiny
    with pytest.raises(ValueError, match="packed"):
        model.encoder_q.encode_packed(*(torch.ones(1, 4, dtype=torch.long),)
                                      * 3, torch.zeros(1, 1,
                                                       dtype=torch.long))
    with pytest.raises(ValueError, match="colbert"):
        RetrieverConfig(model_type="colbert", encoder=dc)


def test_hf_checkpoint_loads_through_the_encode_verb(tmp_path, tiny):
    """A tiny synthetic ``deepseek_v2`` checkpoint, written as two
    safetensors shards with an index and the DHR sidecars, goes down the
    ``encode`` verb's path; its planes equal the f32 reference's."""
    from safetensors.numpy import save_file

    from dhr_tpu_torch.cli.main import main as cli
    from dhr_tpu_torch.models.hf_io import save_sidecar_head
    from dhr_tpu_torch.retrieval.index import PackedIndex

    dc, sd, ref, _ = tiny
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
        lin.weight.data = ref[f"{key}.linear.weight"].clone()
        lin.bias.data = ref[f"{key}.linear.bias"].clone()
        save_sidecar_head(str(ckpt), name, lin, None, dc.hidden_size, out)
    assert decoder_config_from_hf(hf_config(dc), torch.float32) == dc

    ids, mask = batch(seed=7)
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
         "--length-bucketing", "--device", "cpu", "--p-max-len", "32"])
    got = PackedIndex.load(str(out))
    _, lex, sem = ref_dhr_reps(hf_config(dc), ref, ids, mask)
    want_v, want_f = densify(lex, OUT_DIM, REMOVE)
    order = [int(d) for d in got.docids]
    vals = got.values.astype(np.float32)
    np.testing.assert_allclose(vals[:, :OUT_DIM], want_v.numpy()[order],
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(vals[:, OUT_DIM:], sem.numpy()[order],
                               rtol=2e-3, atol=2e-3 * float(sem.abs().max()))
