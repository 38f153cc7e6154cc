"""HF checkpoint import / export for the port's encoder family.

Port of ``dhr_tpu/models/hf_io.py``.  The reference pipeline reads and
writes HF ``save_pretrained`` directories (BERT / DistilBERT MaskedLM
weights, ``config.json``) plus the sidecar heads ``pooler.pt`` /
``TermWeightTrans.pt`` with small JSON configs.  This module maps them onto
the port's modules and back, from local directories only:

- :func:`load_hf_state_dict` reads ``model.safetensors`` with a small
  reader of that format (:func:`read_safetensors`; no ``safetensors``
  package) or ``pytorch_model.bin`` with ``torch.load``;
- :func:`load_hf_backbone` loads such a state dict into an
  ``EncoderWithMLM`` or a ``TransformerEncoder``, refusing an MLM
  projector that is not tied to the word embeddings (a bare ``BertModel``
  state dict, without the ``bert.`` prefix, loads as an encoder-only
  checkpoint);
- :func:`export_hf_mlm` is the way back (the MLM keys are omitted for an
  encoder-only backbone);
- :func:`load_sidecar_head` / :func:`save_sidecar_head` handle the heads;
- a ``deepseek_v2`` or ``kimi_linear`` checkpoint (``config.json`` and
  its ``model.*`` / ``lm_head`` tensors, sharded or not) loads into the
  decoder backbone (:func:`decoder_config_from_hf`,
  :func:`kimi_config_from_hf`, :func:`hf_decoder_to_state_dict`): the
  port keeps HF's names and stacks each MoE layer's experts into one
  tensor per projection (Kimi Linear's ``block_sparse_moe.experts.{e}.
  w1 / w3 / w2`` become ``mlp.experts.gate_proj / up_proj / down_proj``,
  its gate and shared expert ``mlp.gate`` and ``mlp.shared_experts``);
- a ``nemotron_h`` checkpoint likewise (:func:`nemotron_h_config_from_hf`):
  ``backbone.embeddings``, ``backbone.layers.{i}.{norm, mixer.*}`` and
  ``backbone.norm_f`` become the port's ``model.embed_tokens``,
  ``model.layers.{i}.{norm, mixer.*}`` and ``model.norm``, each MoE
  block's ``mixer.experts.{j}.up_proj / down_proj`` stacked into
  ``mixer.experts.up_proj / down_proj``; :func:`nemotron_h_state_dict_to_hf`
  is the way back.

HF linear weights are ``(out, in)`` like ``torch.nn.Linear``, so the map is
a renaming of keys.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch
from torch import nn

from dhr_tpu_torch.models.decoder import DecoderConfig, DecoderLM, DecoderModel
from dhr_tpu_torch.models.transformer import EncoderConfig, TransformerEncoder

# --------------------------------------------------------------------------
# raw state-dict I/O
# --------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a ``.safetensors`` file into numpy arrays.

    The format: an 8-byte little-endian header length, a JSON header
    mapping each name to ``{"dtype", "shape", "data_offsets": [begin,
    end]}`` (offsets into the data that follows), then the data.  BF16
    tensors, which numpy cannot hold, come back widened to f32 (exact).
    """
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        raw = data[begin:end]
        if meta["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            a = bits.view(np.float32)
        elif meta["dtype"] in _ST_DTYPES:
            a = np.frombuffer(raw, np.dtype(_ST_DTYPES[meta["dtype"]])
                              .newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{meta['dtype']}, which this reader does not "
                             "handle")
        out[name] = a.reshape(meta["shape"]).copy()
    return out


def load_hf_state_dict(model_dir: str) -> dict[str, np.ndarray]:
    """Load an HF checkpoint directory's tensors as numpy arrays (one
    ``model.safetensors``, the shards a ``model.safetensors.index.json``
    names, or ``pytorch_model.bin``)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(model_dir, shard)))
        return out
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy() for k, v in sd.items()}
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin in {model_dir}")


def encoder_config_from_hf(model_dir: str,
                           dtype: torch.dtype = torch.bfloat16
                           ) -> EncoderConfig | DecoderConfig:
    """Build an :class:`EncoderConfig` from an HF ``config.json`` (a
    :class:`DecoderConfig` from a ``deepseek_v2``, ``kimi_linear`` or
    ``nemotron_h`` one, its parameters in ``dtype``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "distilbert")
    if model_type == "deepseek_v2":
        return decoder_config_from_hf(hf, dtype, dtype)
    if model_type == "kimi_linear":
        return kimi_config_from_hf(hf, dtype, dtype)
    if model_type == "nemotron_h":
        return nemotron_h_config_from_hf(hf, dtype, dtype)
    if model_type == "distilbert":
        return EncoderConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["dim"],
            num_layers=hf["n_layers"],
            num_heads=hf["n_heads"],
            intermediate_size=hf["hidden_dim"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=0,
            hidden_dropout=hf.get("dropout", 0.1),
            attention_dropout=hf.get("attention_dropout", 0.1),
            dtype=dtype,
        )
    if model_type == "bert":
        return EncoderConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
            hidden_dropout=hf.get("hidden_dropout_prob", 0.1),
            attention_dropout=hf.get("attention_probs_dropout_prob", 0.1),
            dtype=dtype,
        )
    raise ValueError(f"unsupported HF model_type: {model_type}")


def decoder_config_from_hf(hf: dict, dtype: torch.dtype = torch.bfloat16,
                           param_dtype: torch.dtype = torch.float32
                           ) -> DecoderConfig:
    """A :class:`DecoderConfig` from a ``deepseek_v2`` ``config.json``'s
    dict.  Refuses what the decoder does not implement: a query LoRA,
    routing other than greedy, a gate other than softmax, rotary
    positions without YaRN, tied embeddings."""
    unsupported = []
    if hf.get("q_lora_rank") is not None:
        unsupported.append("q_lora_rank")
    if hf.get("topk_method", "greedy") != "greedy":
        unsupported.append("topk_method")
    if hf.get("scoring_func", "softmax") != "softmax":
        unsupported.append("scoring_func")
    rs = hf.get("rope_scaling") or {}
    if rs.get("type", rs.get("rope_type")) != "yarn":
        unsupported.append("rope_scaling")
    if hf.get("tie_word_embeddings", False):
        unsupported.append("tie_word_embeddings")
    if unsupported:
        raise ValueError(f"the decoder backbone does not implement "
                         f"{unsupported} as this config sets them")
    return DecoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        n_routed_experts=hf.get("n_routed_experts") or 0,
        n_shared_experts=hf.get("n_shared_experts") or 0,
        num_experts_per_tok=hf["num_experts_per_tok"],
        first_k_dense_replace=hf["first_k_dense_replace"],
        moe_layer_freq=hf["moe_layer_freq"],
        norm_topk_prob=hf["norm_topk_prob"],
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"], rope_theta=float(hf["rope_theta"]),
        rope_factor=rs["factor"],
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=rs.get("beta_fast", 32),
        rope_beta_slow=rs.get("beta_slow", 1),
        rope_mscale=rs.get("mscale", 1),
        rope_mscale_all_dim=rs.get("mscale_all_dim", 0),
        max_position_embeddings=hf["max_position_embeddings"],
        rms_norm_eps=hf["rms_norm_eps"],
        initializer_range=hf.get("initializer_range", 0.006),
        dtype=dtype, param_dtype=param_dtype)


def kimi_config_from_hf(hf: dict, dtype: torch.dtype = torch.bfloat16,
                        param_dtype: torch.dtype = torch.float32,
                        experts_held: tuple[int, int] | None = None
                        ) -> DecoderConfig:
    """A :class:`DecoderConfig` from a ``kimi_linear`` ``config.json``'s
    dict (``experts_held``: the routed experts this model holds, all when
    None).  Refuses what the decoder does not implement: a query LoRA,
    MLA with rotary positions, expert groups, a router other than sigmoid
    or softmax, layers named neither KDA nor full attention, tied
    embeddings."""
    lac = hf.get("linear_attn_config") or {}
    kda, full = lac.get("kda_layers", []), lac.get("full_attn_layers", [])
    unsupported = []
    if hf.get("q_lora_rank") is not None:
        unsupported.append("q_lora_rank")
    if not hf.get("mla_use_nope", False):
        unsupported.append("mla_use_nope")
    if (hf.get("num_expert_group") or 1) != 1:
        unsupported.append("num_expert_group")
    if hf.get("moe_router_activation_func") not in ("sigmoid", "softmax"):
        unsupported.append("moe_router_activation_func")
    if sorted(kda + full) != list(range(1, hf["num_hidden_layers"] + 1)):
        unsupported.append("linear_attn_config")
    if hf.get("tie_word_embeddings", False):
        unsupported.append("tie_word_embeddings")
    if unsupported:
        raise ValueError(f"the decoder backbone does not implement "
                         f"{unsupported} as this config sets them")
    return DecoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        n_routed_experts=hf.get("num_experts") or 0,
        n_shared_experts=hf.get("num_shared_experts") or 0,
        num_experts_per_tok=hf["num_experts_per_token"],
        first_k_dense_replace=hf["first_k_dense_replace"],
        moe_layer_freq=hf.get("moe_layer_freq", 1),
        norm_topk_prob=hf.get("moe_renormalize", True),
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        router=hf["moe_router_activation_func"],
        experts_held=experts_held, mla_use_nope=True, rope_factor=1.0,
        kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        max_position_embeddings=hf.get("model_max_length",
                                       hf.get("max_position_embeddings")),
        rms_norm_eps=hf["rms_norm_eps"],
        initializer_range=hf.get("initializer_range", 0.006),
        kda_layers=tuple(kda), kda_num_heads=lac["num_heads"],
        kda_head_dim=lac["head_dim"],
        kda_conv_size=lac["short_conv_kernel_size"],
        dtype=dtype, param_dtype=param_dtype)


def nemotron_h_config_from_hf(hf: dict, dtype: torch.dtype = torch.bfloat16,
                              param_dtype: torch.dtype = torch.float32
                              ) -> DecoderConfig:
    """A :class:`DecoderConfig` from a ``nemotron_h`` ``config.json``'s
    dict (blocks of M, * and E).  Refuses what the decoder does not
    implement: other blocks (``-``, the dense MLP of Nemotron-H's dense
    models), expert groups, activations other than relu^2 experts and a
    SiLU Mamba, biases on the projections or none on the convolution, a
    clamp on dt other than (0, inf), a sliding window, an f32 residual,
    tied embeddings."""
    pattern = hf.get("hybrid_override_pattern", "")
    unsupported = []
    if set(pattern) - set("M*E") or len(pattern) != hf["num_hidden_layers"]:
        unsupported.append("hybrid_override_pattern")
    if (hf.get("n_group") or 1) != 1:
        unsupported.append("n_group")
    if hf.get("mlp_hidden_act", "relu2") != "relu2":
        unsupported.append("mlp_hidden_act")
    if hf.get("mamba_hidden_act", "silu") != "silu":
        unsupported.append("mamba_hidden_act")
    for key in ("attention_bias", "mlp_bias", "use_bias", "mamba_proj_bias",
                "residual_in_fp32", "tie_word_embeddings"):
        if hf.get(key, False):
            unsupported.append(key)
    if hf.get("sliding_window") is not None:
        unsupported.append("sliding_window")
    if not hf.get("use_conv_bias", True):
        unsupported.append("use_conv_bias")
    if tuple(hf.get("time_step_limit", (0.0, float("inf")))) \
            != (0.0, float("inf")):
        unsupported.append("time_step_limit")
    if unsupported:
        raise ValueError(f"the decoder backbone does not implement "
                         f"{unsupported} as this config sets them")
    heads = hf["num_attention_heads"]
    return DecoderConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"], num_heads=heads,
        num_key_value_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        intermediate_size=hf["intermediate_size"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        moe_shared_expert_intermediate_size=hf[
            "moe_shared_expert_intermediate_size"],
        n_routed_experts=hf["n_routed_experts"],
        n_shared_experts=hf.get("n_shared_experts") or 0,
        num_experts_per_tok=hf["num_experts_per_tok"],
        first_k_dense_replace=0, norm_topk_prob=hf["norm_topk_prob"],
        routed_scaling_factor=float(hf["routed_scaling_factor"]),
        router="sigmoid", mlp_hidden_act="relu2",
        hybrid_override_pattern=pattern,
        mamba_num_heads=hf["mamba_num_heads"],
        mamba_head_dim=hf["mamba_head_dim"],
        ssm_state_size=hf["ssm_state_size"], n_groups=hf["n_groups"],
        conv_kernel=hf["conv_kernel"], chunk_size=hf["chunk_size"],
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        max_position_embeddings=hf["max_position_embeddings"],
        rms_norm_eps=hf["layer_norm_epsilon"],
        initializer_range=hf.get("initializer_range", 0.02),
        dtype=dtype, param_dtype=param_dtype)


# KDA's tensors under ``self_attn.`` (the published names, the port's too)
_KDA = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
        "q_conv1d.weight", "k_conv1d.weight", "v_conv1d.weight", "A_log",
        "f_a_proj.weight", "f_b_proj.weight", "dt_bias", "b_proj.weight",
        "g_a_proj.weight", "g_b_proj.weight", "g_b_proj.bias",
        "o_norm.weight", "o_proj.weight")
_F32 = ("norm.weight", "A_log", "dt_bias", "e_score_correction_bias", ".D")
# Nemotron-H's names outside the blocks: the checkpoint's, the port's
_NEMOTRON_OUTER = {"backbone.embeddings.weight": "model.embed_tokens.weight",
                   "backbone.norm_f.weight": "model.norm.weight",
                   "lm_head.weight": "lm_head.weight"}


def hf_decoder_to_state_dict(sd: dict[str, np.ndarray], cfg: DecoderConfig
                             ) -> dict[str, torch.Tensor]:
    """A ``deepseek_v2`` state dict (or a ``kimi_linear`` one, for a
    config with the sigmoid router) -> the state dict of a
    :class:`DecoderLM` (``model.*``, ``lm_head.weight``), the experts of
    each MoE layer stacked (those ``cfg.experts_held`` names alone);
    tensors in ``cfg.param_dtype``, RMSNorm weights, ``A_log``,
    ``dt_bias`` and the router's correction bias in f32.  Keys the decoder
    does not read (rotary buffers) are skipped."""
    def tensor(a, name):
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t if name.endswith(_F32) else t.to(cfg.param_dtype)

    if cfg.hybrid_override_pattern:
        return _nemotron_h_to_state_dict(sd, cfg, tensor)
    kimi = cfg.router == "sigmoid"
    moe = "block_sparse_moe." if kimi else "mlp."
    expert = ({"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}
              if kimi else {n: n for n in ("gate_proj", "up_proj",
                                           "down_proj")})
    lo, hi = cfg.experts_held or (0, cfg.n_routed_experts)
    D, h = cfg.kda_num_heads * cfg.kda_head_dim, cfg.kda_num_heads
    shape = {"A_log": (1, 1, h, 1)} | {
        f"{c}_conv1d.weight": (D, 1, cfg.kda_conv_size) for c in "qkv"}
    out = {}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        attn = _KDA if cfg.is_kda(i) else [
            f"{n}.weight" for n in ("q_proj", "kv_a_proj_with_mqa",
                                    "kv_a_layernorm", "kv_b_proj", "o_proj")]
        for n in attn:
            t = tensor(sd[p + "self_attn." + n], n)
            out[p + "self_attn." + n] = t.reshape(shape.get(n, t.shape))
        names = {p + "input_layernorm.weight": None,
                 p + "post_attention_layernorm.weight": None}
        if cfg.is_moe(i):
            names[p + moe + "gate.weight"] = p + "mlp.gate.weight"
            if kimi:
                names[p + moe + "gate.e_score_correction_bias"] = \
                    p + "mlp.gate.e_score_correction_bias"
            for proj, theirs in expert.items():
                out[f"{p}mlp.experts.{proj}"] = tensor(np.stack([
                    sd[f"{p}{moe}experts.{e}.{theirs}.weight"]
                    for e in range(lo, hi)]), proj)
                if cfg.n_shared_experts:
                    names[f"{p}{moe}shared_experts.{proj}.weight"] = \
                        f"{p}mlp.shared_experts.{proj}.weight"
        else:
            names.update({f"{p}mlp.{proj}.weight": None
                          for proj in ("gate_proj", "up_proj", "down_proj")})
        out.update({ours or n: tensor(sd[n], n) for n, ours in names.items()})
    for n in ("model.embed_tokens.weight", "model.norm.weight",
              "lm_head.weight"):
        if n in sd:
            out[n] = tensor(sd[n], n)
    return out


def _nemotron_h_to_state_dict(sd, cfg: DecoderConfig, tensor) -> dict:
    """:func:`hf_decoder_to_state_dict` of a ``nemotron_h`` checkpoint."""
    lo, hi = cfg.experts_held or (0, cfg.n_routed_experts)
    out = {}
    for i in range(cfg.num_layers):
        theirs, ours = f"backbone.layers.{i}.", f"model.layers.{i}."
        experts = theirs + "mixer.experts."
        for n in sd:
            if n.startswith(theirs) and not n.startswith(experts):
                out[ours + n[len(theirs):]] = tensor(sd[n], n)
        if cfg.is_moe(i):
            for proj in ("up_proj", "down_proj"):
                out[f"{ours}mixer.experts.{proj}"] = tensor(np.stack([
                    sd[f"{experts}{e}.{proj}.weight"]
                    for e in range(lo, hi)]), proj)
    out.update({ours: tensor(sd[n], ours)
                for n, ours in _NEMOTRON_OUTER.items() if n in sd})
    return out


def nemotron_h_state_dict_to_hf(state: dict, cfg: DecoderConfig
                                ) -> dict[str, torch.Tensor]:
    """A ``DecoderLM``'s state dict of a Nemotron-H config -> the
    checkpoint's names (``backbone.*``, ``lm_head.weight``), each stacked
    expert projection split into ``mixer.experts.{j}.<proj>.weight`` (its
    global id ``j``, where the model holds a share)."""
    lo = (cfg.experts_held or (0,))[0]
    back = {ours: theirs for theirs, ours in _NEMOTRON_OUTER.items()}
    out = {}
    for n, t in state.items():
        if n in back:
            out[back[n]] = t
            continue
        name = "backbone." + n.removeprefix("model.")
        head, _, proj = name.rpartition(".experts.")
        if proj in ("up_proj", "down_proj"):
            out.update({f"{head}.experts.{lo + j}.{proj}.weight": w
                        for j, w in enumerate(t.unbind(0))})
        else:
            out[name] = t
    return out


# --------------------------------------------------------------------------
# name map: HF (Distil)BertForMaskedLM  <->  the port's EncoderWithMLM
# --------------------------------------------------------------------------

_LAYER = {
    "distilbert": {
        "attention.q_lin": "attention.query",
        "attention.k_lin": "attention.key",
        "attention.v_lin": "attention.value",
        "attention.out_lin": "attention.out",
        "sa_layer_norm": "attn_layer_norm",
        "ffn.lin1": "ffn_in",
        "ffn.lin2": "ffn_out",
        "output_layer_norm": "ffn_layer_norm",
    },
    "bert": {
        "attention.self.query": "attention.query",
        "attention.self.key": "attention.key",
        "attention.self.value": "attention.value",
        "attention.output.dense": "attention.out",
        "attention.output.LayerNorm": "attn_layer_norm",
        "intermediate.dense": "ffn_in",
        "output.dense": "ffn_out",
        "output.LayerNorm": "ffn_layer_norm",
    },
}
_PREFIX = {
    "distilbert": ("distilbert.embeddings", "distilbert.transformer.layer"),
    "bert": ("bert.embeddings", "bert.encoder.layer"),
}
_MLM = {
    "distilbert": {"vocab_transform": "mlm.transform",
                   "vocab_layer_norm": "mlm.layer_norm"},
    "bert": {"cls.predictions.transform.dense": "mlm.transform",
             "cls.predictions.transform.LayerNorm": "mlm.layer_norm"},
}
_MLM_BIAS = {"distilbert": "vocab_projector.bias",
             "bert": "cls.predictions.bias"}
_DECODER = {"distilbert": "vocab_projector.weight",
            "bert": "cls.predictions.decoder.weight"}


def _key_map(cfg: EncoderConfig, arch: str, mlm: bool,
             token_type: bool) -> list[tuple[str, str]]:
    """``(HF key, port key)`` pairs; port keys are relative to an
    ``EncoderWithMLM`` (``encoder.*``, ``mlm.*``)."""
    emb, layer = _PREFIX[arch]
    pairs = [(f"{emb}.word_embeddings.weight", "encoder.embeddings.word.weight"),
             (f"{emb}.position_embeddings.weight",
              "encoder.embeddings.position.weight")]
    if token_type:
        pairs.append((f"{emb}.token_type_embeddings.weight",
                      "encoder.embeddings.token_type.weight"))
    for p in ("weight", "bias"):
        pairs.append((f"{emb}.LayerNorm.{p}",
                      f"encoder.embeddings.layer_norm.{p}"))
        for i in range(cfg.num_layers):
            for hf, ours in _LAYER[arch].items():
                pairs.append((f"{layer}.{i}.{hf}.{p}",
                              f"encoder.layers.{i}.{ours}.{p}"))
        if mlm:
            for hf, ours in _MLM[arch].items():
                pairs.append((f"{hf}.{p}", f"{ours}.{p}"))
    if mlm:
        pairs.append((_MLM_BIAS[arch], "mlm.bias"))
    return pairs


def _check_tied_projector(projector, word_embeddings) -> None:
    """The port ties the MLM projection to the word embeddings; refuse
    checkpoints where they genuinely differ rather than silently dropping
    the projector weights."""
    if projector is None:
        return
    a, b = np.asarray(projector), np.asarray(word_embeddings)
    if a.shape == b.shape and not np.allclose(
        a[:64, :64], b[:64, :64], atol=1e-5
    ):
        raise ValueError(
            "checkpoint has an untied MLM projector; the encoder ties it to "
            "the word embeddings (an untied projector is not supported)"
        )


def hf_mlm_to_state_dict(sd: dict[str, np.ndarray], cfg: EncoderConfig
                         ) -> tuple[dict[str, torch.Tensor], bool]:
    """HF (Distil)BertForMaskedLM state dict -> ``(state dict of an
    EncoderWithMLM, has_mlm)``; without the MLM head (an encoder-only
    checkpoint) only the ``encoder.*`` keys are filled."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if not any(k.startswith(("bert.", "distilbert.")) for k in sd):
        # a bare BertModel's keys (``embeddings.*``, ``encoder.layer.*``),
        # as ``convert_dpr_checkpoint`` writes DPR's towers
        sd = {f"bert.{k}": v for k, v in sd.items()}
    arch = ("distilbert" if any(k.startswith("distilbert.") for k in sd)
            else "bert")
    has_mlm = f"{next(iter(_MLM[arch]))}.weight" in sd  # the transform
    token_type = arch == "bert" and cfg.type_vocab_size > 0
    out = {ours: torch.from_numpy(np.asarray(sd[hf], np.float32).copy())
           for hf, ours in _key_map(cfg, arch, has_mlm, token_type)}
    if has_mlm:
        _check_tied_projector(sd.get(_DECODER[arch]),
                              sd[f"{_PREFIX[arch][0]}.word_embeddings.weight"])
    return out, has_mlm


def load_hf_backbone(backbone: nn.Module, sd: dict[str, np.ndarray],
                     cfg: EncoderConfig) -> None:
    """Load an HF state dict into an ``EncoderWithMLM`` (which needs the
    MLM head) or a ``TransformerEncoder`` (which takes the encoder only),
    or a ``deepseek_v2`` or ``kimi_linear`` one into a ``DecoderLM``
    (which needs the LM head) or a ``DecoderModel``."""
    if isinstance(backbone, (DecoderLM, DecoderModel)):
        state = hf_decoder_to_state_dict(sd, cfg)
        if isinstance(backbone, DecoderModel):
            state = {k.removeprefix("model."): v for k, v in state.items()
                     if k.startswith("model.")}
        elif "lm_head.weight" not in state:
            raise ValueError("this model needs the checkpoint's lm_head, "
                             "which it lacks")
        backbone.load_state_dict(state, strict=True)
        return
    state, has_mlm = hf_mlm_to_state_dict(sd, cfg)
    if isinstance(backbone, TransformerEncoder):
        state = {k.removeprefix("encoder."): v for k, v in state.items()
                 if k.startswith("encoder.")}
    elif not has_mlm:
        raise ValueError("this model needs an MLM-headed checkpoint, but "
                         "the checkpoint is encoder-only (exported from a "
                         "dense/skip-MLM/colbert run); pass a MaskedLM "
                         "checkpoint")
    backbone.load_state_dict(state, strict=True)


def export_hf_mlm(backbone: nn.Module, cfg: EncoderConfig,
                  arch: str = "distilbert") -> dict[str, np.ndarray]:
    """The port's ``EncoderWithMLM`` (or encoder-only
    ``TransformerEncoder``) -> an HF MaskedLM state dict (numpy f32); the
    vocabulary projection is written tied to the word embeddings."""
    if isinstance(backbone, TransformerEncoder):
        state = {f"encoder.{k}": v for k, v in backbone.state_dict().items()}
        mlm = False
    else:
        state, mlm = backbone.state_dict(), True
    token_type = arch == "bert" and cfg.type_vocab_size > 0
    sd = {hf: state[ours].detach().float().cpu().numpy().copy()
          for hf, ours in _key_map(cfg, arch, mlm, token_type)}
    if mlm:
        sd[_DECODER[arch]] = sd[f"{_PREFIX[arch][0]}.word_embeddings.weight"]
    return sd


# --------------------------------------------------------------------------
# sidecar heads: pooler.pt / TermWeightTrans.pt
# --------------------------------------------------------------------------


def load_sidecar_head(model_dir: str, name: str) -> dict | None:
    """Load a sidecar head (``{name}.pt`` + ``{name}_config.json``):
    ``{"q": {"weight", "bias"}, "p": {...} | None, "config": {...}}`` in
    ``nn.Linear`` layout, or None if the sidecar is absent."""
    pt = os.path.join(model_dir, f"{name}.pt")
    cfg_path = os.path.join(model_dir, f"{name}_config.json")
    if not (os.path.exists(pt) and os.path.exists(cfg_path)):
        return None
    sd = torch.load(pt, map_location="cpu", weights_only=True)
    with open(cfg_path) as f:
        config = json.load(f)

    def linear(side):
        return {"weight": sd[f"linear_{side}.weight"].float(),
                "bias": sd[f"linear_{side}.bias"].float()}

    out = {"q": linear("q"), "p": None, "config": config}
    if not config.get("tied", True) and "linear_p.weight" in sd:
        out["p"] = linear("p")
    return out


def save_sidecar_head(model_dir: str, name: str, q_linear: nn.Linear,
                      p_linear: nn.Linear | None, input_dim: int,
                      output_dim: int) -> None:
    """Write a sidecar head in the reference's ``.pt`` + JSON layout.  A
    tied head writes the query weights under both key families, which the
    reference's strict load requires."""
    def f32(t):
        return t.detach().float().cpu().contiguous().clone()

    sd = {"linear_q.weight": f32(q_linear.weight),
          "linear_q.bias": f32(q_linear.bias)}
    tied = p_linear is None
    src = q_linear if tied else p_linear
    sd["linear_p.weight"] = sd["linear_q.weight"] if tied else f32(src.weight)
    sd["linear_p.bias"] = sd["linear_q.bias"] if tied else f32(src.bias)
    torch.save(sd, os.path.join(model_dir, f"{name}.pt"))
    with open(os.path.join(model_dir, f"{name}_config.json"), "w") as f:
        json.dump({"input_dim": input_dim, "output_dim": output_dim,
                   "tied": tied}, f)
