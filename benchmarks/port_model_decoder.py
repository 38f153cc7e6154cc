"""Hands the benchmark's generated decoder weights to the program: builds
the port's DHR bi-encoder on DeepSeek-V2-Lite for a configuration, its
parameters in the compute dtype (RMSNorm weights f32), and loads the
generated tensors into it.

The model is built on the meta device and takes the generated tensors
themselves (``load_state_dict(assign=True)``): the program holds the
only copy of the 31.4 GB of weights, and the benchmark keeps no
reference to them (its f32 reference draws its own, a layer at a
time)."""

from __future__ import annotations

from benchmarks.harness import import_program


def retriever_config(cfg: dict, dtype_name: str):
    """The port's ``RetrieverConfig`` of a configuration file, the decoder
    built in ``dtype_name`` (its parameters and its compute)."""
    import torch

    dec = import_program("dhr_tpu_torch.models.decoder")
    rt = import_program("dhr_tpu_torch.models.retrievers")
    m, h = cfg["model"], cfg["head"]
    rs = m["rope_scaling"]
    dtype = getattr(torch, dtype_name)
    enc = dec.DecoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        intermediate_size=m["intermediate_size"],
        moe_intermediate_size=m["moe_intermediate_size"],
        n_routed_experts=m["n_routed_experts"],
        n_shared_experts=m["n_shared_experts"],
        num_experts_per_tok=m["num_experts_per_tok"],
        first_k_dense_replace=m["first_k_dense_replace"],
        moe_layer_freq=m["moe_layer_freq"],
        norm_topk_prob=m["norm_topk_prob"],
        routed_scaling_factor=float(m["routed_scaling_factor"]),
        kv_lora_rank=m["kv_lora_rank"],
        qk_nope_head_dim=m["qk_nope_head_dim"],
        qk_rope_head_dim=m["qk_rope_head_dim"],
        v_head_dim=m["v_head_dim"], rope_theta=float(m["rope_theta"]),
        rope_factor=rs["factor"],
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"],
        rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        max_position_embeddings=m["max_position_embeddings"],
        rms_norm_eps=m["rms_norm_eps"],
        initializer_range=m["initializer_range"],
        dtype=dtype, param_dtype=dtype)
    return rt.RetrieverConfig(
        model_type="dhr", encoder=enc, add_pooler=True,
        projection_dim=h["projection_dim"], dlr_out_dim=h["dlr_out_dim"])


def port_names(weights: dict) -> dict[str, str]:
    """The port's parameter name of each generated tensor (tied towers):
    the backbone keeps the generator's (Hugging Face's) names."""
    head = ("term_weight.", "pooler.")
    return {("encoder_q." if k.startswith(head) else "encoder_q.backbone.")
            + k: k for k in weights}


def port_bi_encoder(weights: dict, rcfg):
    """The port's ``BiEncoder`` holding ``weights`` themselves (the dict
    is emptied)."""
    import torch

    rt = import_program("dhr_tpu_torch.models.retrievers")
    with torch.device("meta"):
        model = rt.BiEncoder(rcfg)
    state = {port: weights.pop(ours)
             for port, ours in port_names(weights).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model
