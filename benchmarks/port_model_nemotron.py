"""Hands the benchmark's generated Nemotron-H weights to the program:
builds the port's DHR bi-encoder on NVIDIA-Nemotron-3-Nano-30B-A3B, whole,
its parameters in the compute dtype (norm scales, ``A_log``, ``dt_bias``,
``D`` and the router's correction bias f32), and loads the generated
tensors into it.

The model is built on the meta device and takes the generated tensors
themselves (``load_state_dict(assign=True)``): the program holds the only
copy of the 63.16 GB of weights, and the benchmark keeps no reference to
them (its f32 reference draws its own, a block at a time).  The names are
the port's, so the load is ``port_model_decoder.port_bi_encoder``.  A
program whose ``DecoderConfig`` has no block pattern refuses the
configuration at once."""

from __future__ import annotations

from benchmarks.harness import import_program


def retriever_config(cfg: dict, dtype_name: str):
    """The port's ``RetrieverConfig`` of a configuration file, the decoder
    built in ``dtype_name`` (its parameters and its compute)."""
    import torch

    dec = import_program("dhr_tpu_torch.models.decoder")
    rt = import_program("dhr_tpu_torch.models.retrievers")
    m, h = cfg["model"], cfg["head"]
    dtype = getattr(torch, dtype_name)
    enc = dec.DecoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        num_key_value_heads=m["num_key_value_heads"],
        head_dim=m["head_dim"], intermediate_size=m["intermediate_size"],
        moe_intermediate_size=m["moe_intermediate_size"],
        moe_shared_expert_intermediate_size=m[
            "moe_shared_expert_intermediate_size"],
        n_routed_experts=m["n_routed_experts"],
        n_shared_experts=m["n_shared_experts"],
        num_experts_per_tok=m["num_experts_per_tok"],
        first_k_dense_replace=0, norm_topk_prob=m["norm_topk_prob"],
        routed_scaling_factor=float(m["routed_scaling_factor"]),
        router="sigmoid", mlp_hidden_act=m["mlp_hidden_act"],
        hybrid_override_pattern=m["hybrid_override_pattern"],
        mamba_num_heads=m["mamba_num_heads"],
        mamba_head_dim=m["mamba_head_dim"],
        ssm_state_size=m["ssm_state_size"], n_groups=m["n_groups"],
        conv_kernel=m["conv_kernel"], chunk_size=m["chunk_size"],
        rope_theta=float(m["rope_theta"]),
        max_position_embeddings=m["max_position_embeddings"],
        rms_norm_eps=m["layer_norm_epsilon"],
        initializer_range=m["initializer_range"],
        dtype=dtype, param_dtype=dtype)
    return rt.RetrieverConfig(
        model_type="dhr", encoder=enc, add_pooler=True,
        projection_dim=h["projection_dim"], dlr_out_dim=h["dlr_out_dim"])
