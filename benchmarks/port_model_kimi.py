"""Hands the benchmark's generated Kimi Linear weights to the program:
builds the port's DHR bi-encoder on a Kimi Linear decoder holding the
configuration's share of the experts, its parameters in the compute dtype
(RMSNorm weights, ``A_log``, ``dt_bias`` and the router's correction bias
f32), and loads the generated tensors into it.

The model is built on the meta device and takes the generated tensors
themselves (``load_state_dict(assign=True)``): the program holds the only
copy of the 51.1 GB of weights, and the benchmark keeps no reference to
them (its f32 reference draws its own, a layer at a time).  The names are
the port's, so the load is ``port_model_decoder.port_bi_encoder``."""

from __future__ import annotations

from benchmarks.harness import import_program


def retriever_config(cfg: dict, dtype_name: str):
    """The port's ``RetrieverConfig`` of a configuration file, the decoder
    built in ``dtype_name`` (its parameters and its compute), routing over
    the published experts and holding ``experts_held``."""
    import torch

    dec = import_program("dhr_tpu_torch.models.decoder")
    rt = import_program("dhr_tpu_torch.models.retrievers")
    m, h = cfg["model"], cfg["head"]
    lac = m["linear_attn_config"]
    dtype = getattr(torch, dtype_name)
    enc = dec.DecoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        intermediate_size=m["intermediate_size"],
        moe_intermediate_size=m["moe_intermediate_size"],
        n_routed_experts=cfg["expert_parallel"]["published_num_experts"],
        experts_held=tuple(m["experts_held"]),
        n_shared_experts=m["num_shared_experts"],
        num_experts_per_tok=m["num_experts_per_token"],
        first_k_dense_replace=m["first_k_dense_replace"],
        moe_layer_freq=m["moe_layer_freq"],
        norm_topk_prob=m["moe_renormalize"],
        routed_scaling_factor=float(m["routed_scaling_factor"]),
        router=m["moe_router_activation_func"],
        mla_use_nope=m["mla_use_nope"], rope_factor=1.0,
        kv_lora_rank=m["kv_lora_rank"],
        qk_nope_head_dim=m["qk_nope_head_dim"],
        qk_rope_head_dim=m["qk_rope_head_dim"],
        v_head_dim=m["v_head_dim"], rope_theta=float(m["rope_theta"]),
        max_position_embeddings=m["model_max_length"],
        rms_norm_eps=m["rms_norm_eps"],
        initializer_range=m["initializer_range"],
        kda_layers=tuple(lac["kda_layers"]), kda_num_heads=lac["num_heads"],
        kda_head_dim=lac["head_dim"],
        kda_conv_size=lac["short_conv_kernel_size"],
        dtype=dtype, param_dtype=dtype)
    return rt.RetrieverConfig(
        model_type="dhr", encoder=enc, add_pooler=True,
        projection_dim=h["projection_dim"], dlr_out_dim=h["dlr_out_dim"])
