"""Seeded weights of a DHR bi-encoder (BERT / DistilBERT + the DHR head),
made on the device in one draw.

The names are the benchmark's own and are what the plain reference reads;
a driver maps them onto the program's parameters.  Linear weights are
``(out, in)``.  Every matrix, embedding and bias is drawn from
``N(0, initializer_range)`` (the configuration's published init scale);
LayerNorm scales are ``1 + N(0, initializer_range)``, and the term-weight
bias is shifted by the head's ``term_weight_bias``, so that term weights
are positive as a trained DHR model's are (random hidden states share a
direction, and with a bias about 0 a seed can leave every position of a
passage a term weight below 0, its lexical rep the pads' zeros).  Tied
towers: one set serves queries and passages, and the MLM projection is
the word embedding table.
"""

from __future__ import annotations

import numpy as np
import torch


def model_dims(cfg: dict) -> dict:
    """The widths a configuration file states, under one set of names."""
    m = cfg["model"]
    return {"layers": m["num_hidden_layers"], "hidden": m["hidden_size"],
            "heads": m["num_attention_heads"], "ffn": m["intermediate_size"],
            "vocab": m["vocab_size"],
            "positions": m["max_position_embeddings"],
            "types": m.get("type_vocab_size", 0),
            "proj": cfg["head"]["projection_dim"],
            "tw_bias": cfg["head"].get("term_weight_bias", 0.0),
            "eps": m["layer_norm_eps"], "init": m["initializer_range"]}


def shapes(d: dict) -> list[tuple[str, tuple[int, ...]]]:
    """Every parameter's name and shape, in draw order."""
    H, F = d["hidden"], d["ffn"]
    out = [("emb.word", (d["vocab"], H)), ("emb.pos", (d["positions"], H))]
    if d["types"]:
        out.append(("emb.type", (d["types"], H)))
    out += [("emb.ln.w", (H,)), ("emb.ln.b", (H,))]
    for i in range(d["layers"]):
        p = f"l{i}."
        for n in ("q", "k", "v", "o"):
            out += [(p + n + ".w", (H, H)), (p + n + ".b", (H,))]
        out += [(p + "ln1.w", (H,)), (p + "ln1.b", (H,)),
                (p + "ffn1.w", (F, H)), (p + "ffn1.b", (F,)),
                (p + "ffn2.w", (H, F)), (p + "ffn2.b", (H,)),
                (p + "ln2.w", (H,)), (p + "ln2.b", (H,))]
    out += [("mlm.t.w", (H, H)), ("mlm.t.b", (H,)), ("mlm.ln.w", (H,)),
            ("mlm.ln.b", (H,)), ("mlm.bias", (d["vocab"],)),
            ("tw.w", (1, H)), ("tw.b", (1,)),
            ("pool.w", (d["proj"], H)), ("pool.b", (d["proj"],))]
    return out


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """f32 weights of ``cfg``'s model from ``seed``: one normal draw on the
    device, split into views."""
    d = model_dims(cfg)
    spec = shapes(d)
    sizes = [int(np.prod(s)) for _, s in spec]
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed) % (1 << 64), 0xBE27])
                      .generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat.mul_(d["init"])
    out, s = {}, 0
    for (name, shape), n in zip(spec, sizes):
        t = flat[s:s + n].view(shape)
        if name.endswith(("ln.w", "ln1.w", "ln2.w")):
            t.add_(1.0)
        elif name == "tw.b":
            t.add_(d["tw_bias"])
        out[name] = t
        s += n
    return out
