"""Hands the benchmark's generated weights to the program: builds the
port's DHR bi-encoder for a configuration and loads the weights through
``load_state_dict`` (a copy: the benchmark's tensors stay as made)."""

from __future__ import annotations

from benchmarks.gen.weights import model_dims
from benchmarks.harness import import_program


def port_names(cfg: dict) -> dict[str, str]:
    """The port's parameter name of each generated weight (tied towers)."""
    d = model_dims(cfg)
    enc = "encoder_q.backbone.encoder."
    out = {enc + "embeddings.word.weight": "emb.word",
           enc + "embeddings.position.weight": "emb.pos",
           enc + "embeddings.layer_norm.weight": "emb.ln.w",
           enc + "embeddings.layer_norm.bias": "emb.ln.b"}
    if d["types"]:
        out[enc + "embeddings.token_type.weight"] = "emb.type"
    parts = {"attention.query": "q", "attention.key": "k",
             "attention.value": "v", "attention.out": "o",
             "attn_layer_norm": "ln1", "ffn_in": "ffn1", "ffn_out": "ffn2",
             "ffn_layer_norm": "ln2"}
    for i in range(d["layers"]):
        for port, ours in parts.items():
            out[f"{enc}layers.{i}.{port}.weight"] = f"l{i}.{ours}.w"
            out[f"{enc}layers.{i}.{port}.bias"] = f"l{i}.{ours}.b"
    head = "encoder_q."
    out.update({
        head + "backbone.mlm.transform.weight": "mlm.t.w",
        head + "backbone.mlm.transform.bias": "mlm.t.b",
        head + "backbone.mlm.layer_norm.weight": "mlm.ln.w",
        head + "backbone.mlm.layer_norm.bias": "mlm.ln.b",
        head + "backbone.mlm.bias": "mlm.bias",
        head + "term_weight.linear.weight": "tw.w",
        head + "term_weight.linear.bias": "tw.b",
        head + "pooler.linear.weight": "pool.w",
        head + "pooler.linear.bias": "pool.b",
    })
    return out


def retriever_config(cfg: dict, dtype_name: str):
    """The port's ``RetrieverConfig`` of a configuration file."""
    import torch

    tr = import_program("dhr_tpu_torch.models.transformer")
    rt = import_program("dhr_tpu_torch.models.retrievers")
    m, h = cfg["model"], cfg["head"]
    enc = tr.EncoderConfig(
        vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
        num_layers=m["num_hidden_layers"],
        num_heads=m["num_attention_heads"],
        intermediate_size=m["intermediate_size"],
        max_position_embeddings=m["max_position_embeddings"],
        type_vocab_size=m.get("type_vocab_size", 0),
        layer_norm_eps=m["layer_norm_eps"],
        hidden_dropout=m["hidden_dropout_prob"],
        attention_dropout=m["attention_probs_dropout_prob"],
        dtype=getattr(torch, dtype_name))
    return rt.RetrieverConfig(
        model_type="dhr", encoder=enc, add_pooler=True,
        projection_dim=h["projection_dim"], dlr_out_dim=h["dlr_out_dim"])


def port_bi_encoder(cfg: dict, weights: dict, rcfg, device):
    """The port's ``BiEncoder`` on ``device`` holding a copy of
    ``weights``."""
    import torch

    rt = import_program("dhr_tpu_torch.models.retrievers")
    # built on the device, where its own initialisation is a few kernels
    # (a build on the meta device costs seconds of Python)
    with torch.device(device):
        model = rt.BiEncoder(rcfg)
    names = port_names(cfg)
    model.load_state_dict({k: weights[v] for k, v in names.items()},
                          strict=True)
    return model

