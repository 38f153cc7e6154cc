"""Corpus encoding: ``Encoder.encode_corpus`` over length-bucketed batches of
token-id passages, the planes copied back to the host, call after call.

Set-up makes the weights on the device from the seed and hands them to the
port's ``BiEncoder`` (``benchmarks.port_model``), builds the ``Encoder``
(which keeps its own bf16 copy), draws a pool of passages from the seed,
and warms up one batch of each bucket length the traffic uses.  Each call
of the window encodes ``passages_per_call`` passages of the pool through
``bucketed_encode_batches`` (the ``encode --length-bucketing`` path).

Correctness: the same passages of every call, drawn from the seed, are
encoded again by the f32 reference (``reference.dhr_model``) from the
benchmark's weights, and per passage, each over the larger of the
passage's own scale and the median passage's (a passage whose term
weights are all negative has a lexical rep of about 0, and there the pads
decide whether the max over positions is 0 or slightly below it):

- ``lexical_gap``: the L2 gap of its 768 lexical values, over their L2
  norm, the largest over the passages;
- ``cls_gap``: the same over its 128 CLS dims;
- ``fold_gap``: the largest amount by which the reference's value at a
  returned fold lies below the reference's best fold, over the largest
  reference value.
"""

from __future__ import annotations

import itertools
import time

import numpy as np


def run(ctx):
    torch = ctx.torch
    dev = ctx.device
    from benchmarks import roofline
    from benchmarks.gen.weights import make_weights, model_dims
    from benchmarks.harness import import_program, repeat
    from benchmarks.port_model import port_bi_encoder, retriever_config

    cfg, tr = ctx.config, ctx.traffic
    ecfg, m = cfg["encode"], cfg["model"]
    torch.ones(1, device=dev)
    ctx.setup_part("cuda_start")

    weights = make_weights(cfg, ctx.seed, dev)
    ctx.setup_part("weight_generation")
    rcfg = retriever_config(cfg, ecfg["compute_dtype"])
    model = port_bi_encoder(cfg, weights, rcfg, dev)
    ctx.setup_part("model_load")

    per_call = int(tr["passages_per_call"])
    n_chunks = int(tr["pool_calls"])
    toks, lens = passages(ctx)
    ids = [str(i) for i in range(len(toks))]
    ctx.setup_part("traffic_generation")

    enc_mod = import_program("dhr_tpu_torch.encode")
    enc = enc_mod.Encoder(model, rcfg, enc_mod.EncodeConfig(
        batch_size=int(ecfg["batch_size"]),
        remove_dims=int(cfg["head"]["remove_dims"])), device=dev)
    del model
    cls_id, sep_id, max_len = m["cls_token_id"], m["sep_token_id"], \
        int(ecfg["p_max_len"])

    def batches(c):
        s = slice(c * per_call, (c + 1) * per_call)
        out, _ = enc_mod.bucketed_encode_batches(
            ids[s], toks[s], enc.encode_cfg.batch_size, max_len, cls_id,
            sep_id)
        return out

    seen = set()
    for b in batches(0):   # one batch of every bucket length in use
        if b["input_ids"].shape[1] not in seen:
            seen.add(b["input_ids"].shape[1])
            enc.encode_corpus([b])
    ctx.setup_part("warmup")

    tower = enc.model.encoder("passage")
    ctx.spans.hook(tower.backbone.encoder, "encode.transformer")
    ctx.spans.wrap(tower, "reps", "encode.head")
    ctx.spans.wrap(enc, "planes", "encode.densify")
    checked = checked_rows(ctx)
    kept = []
    calls = 0
    with ctx.window() as t0:
        while True:
            c = calls % n_chunks
            packed = enc.encode_corpus(batches(c))
            where = {d: r for r, d in enumerate(packed.docids)}
            rows = [where[str(c * per_call + i)] for i in checked]
            kept.append((c, packed.values[rows], packed.indices[rows]))
            calls += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    ctx.work["window_calls"] = calls
    more = itertools.count(calls)
    ctx.traced(repeat(
        lambda: enc.encode_corpus(batches(next(more) % n_chunks))))
    ctx.read_peak()
    done = calls * per_call
    d = model_dims(cfg)
    ctx.work["flops"] = sum(
        roofline.tower_flops(lens[(k % n_chunks) * per_call:
                                  (k % n_chunks + 1) * per_call] + 2, d)
        for k in range(calls))
    del enc, tower
    ctx.free()

    gaps = reference_gaps(ctx, weights, d, toks, kept, checked, per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)
    return {"e2e": {"encode_pps": done / ctx.window_s},
            "attempted": done, "failed": 0}


def passages(ctx):
    """The pool's token-id passages and their content lengths."""
    from benchmarks.gen.tokens import rng, token_lists

    tr = ctx.traffic
    n = int(tr["passages_per_call"]) * int(tr["pool_calls"])
    return token_lists(tr["passage_tokens"], n, rng(ctx.seed, 0xE1C),
                       ctx.config["model"]["vocab_size"])


def checked_rows(ctx) -> np.ndarray:
    """The positions within a call's passages that are compared."""
    from benchmarks.gen.tokens import rng

    per_call = int(ctx.traffic["passages_per_call"])
    return np.sort(rng(ctx.seed, 0xC4E).choice(
        per_call, size=min(int(ctx.traffic["checked_per_call"]), per_call),
        replace=False))


def control(ctx) -> None:
    """The control: the reference computed with fp8 products, one step
    below the configuration's bf16, put in the program's place: its planes
    (f16 values, fold indices) compared as the program's are."""
    from benchmarks.gen.weights import make_weights, model_dims
    from benchmarks.reference.dhr_model import densify

    head = ctx.config["head"]
    weights = make_weights(ctx.config, ctx.seed, ctx.device)
    d = model_dims(ctx.config)
    toks, _ = passages(ctx)
    per_call = int(ctx.traffic["passages_per_call"])
    kept = []
    for c in range(int(ctx.traffic["pool_calls"])):
        sel = [toks[c * per_call + i] for i in checked_rows(ctx)]
        lexical, semantic = reference_planes(ctx, weights, d, sel, "fp8")
        vals, folds = densify(lexical, head["dlr_out_dim"],
                              head["remove_dims"])
        planes = ctx.torch.cat([vals, semantic], dim=1).half()
        kept.append((c, planes.float().cpu().numpy(),
                     folds.cpu().numpy()))
    gaps = reference_gaps(ctx, weights, d, toks, kept, checked_rows(ctx),
                          per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)


def collate(toks, cls_id: int, sep_id: int, length: int | None = None):
    """[CLS] + tokens + [SEP], padded to ``length`` (default: the
    longest): ``(ids, mask)``."""
    L = length or max(len(t) for t in toks) + 2
    ids = np.zeros((len(toks), L), np.int64)
    mask = np.zeros((len(toks), L), np.int64)
    for i, t in enumerate(toks):
        row = [cls_id, *map(int, t), sep_id]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask


def reference_planes(ctx, weights, d, toks, precision: str = "f32",
                     block: int = 16):
    """The reference's ``(lexical (n, V), semantic (n, proj))`` f32 of
    ``toks``, ``block`` passages at a time."""
    torch = ctx.torch
    from benchmarks.reference import no_tf32
    from benchmarks.reference.dhr_model import Math, dhr_reps

    no_tf32()
    m = ctx.config["model"]
    lex, sem = [], []
    with torch.no_grad():
        for s in range(0, len(toks), block):
            ids, mask = collate(toks[s:s + block], m["cls_token_id"],
                                m["sep_token_id"])
            li, se = dhr_reps(weights, d,
                              torch.as_tensor(ids, device=ctx.device),
                              torch.as_tensor(mask, device=ctx.device),
                              Math(precision))
            lex.append(li)
            sem.append(se)
    return torch.cat(lex), torch.cat(sem)


def plane_gaps(torch, lexical, semantic, values, folds, out_dim: int,
               remove_dims: int) -> dict:
    """The three compared numbers of returned planes ``(values (n, out_dim
    + proj), folds (n, out_dim))`` against the reference's reps."""
    from benchmarks.reference.dhr_model import densify, fold_lanes

    ref_v, _ = densify(lexical, out_dim, remove_dims)
    lanes = fold_lanes(lexical, out_dim, remove_dims)
    v = torch.as_tensor(np.asarray(values, np.float32), device=lexical.device)
    f = torch.as_tensor(np.asarray(folds, np.int64), device=lexical.device)

    def scale(x):   # each row's, at least the median row's
        return torch.maximum(x, x.median()).clamp(min=1e-30)

    lex_scale = scale(ref_v.abs().amax(dim=1))
    lexical_gap = (torch.linalg.vector_norm(v[:, :out_dim] - ref_v, dim=1)
                   / scale(torch.linalg.vector_norm(ref_v, dim=1)))
    cls_gap = (torch.linalg.vector_norm(v[:, out_dim:] - semantic, dim=1)
               / scale(torch.linalg.vector_norm(semantic, dim=1)))
    if (f < 0).any() or (f >= lanes.shape[1]).any():
        fold_gap = torch.full_like(lex_scale, float("inf"))
    else:
        at = torch.gather(lanes, 1, f[:, None, :])[:, 0]
        fold_gap = (ref_v - at).amax(dim=1) / lex_scale
    return {"lexical_gap": float(lexical_gap.max()),
            "cls_gap": float(cls_gap.max()),
            "fold_gap": float(fold_gap.max())}


def reference_gaps(ctx, weights, d, toks, kept, checked, per_call,
                   precision: str = "f32") -> dict:
    torch = ctx.torch
    head = ctx.config["head"]
    out = {"lexical_gap": 0.0, "cls_gap": 0.0, "fold_gap": 0.0}
    for c in sorted({c for c, _, _ in kept}):
        sel = [toks[c * per_call + i] for i in checked]
        lexical, semantic = reference_planes(ctx, weights, d, sel, precision)
        for _, values, folds in (k for k in kept if k[0] == c):
            g = plane_gaps(torch, lexical, semantic, values, folds,
                           head["dlr_out_dim"], head["remove_dims"])
            out = {k: max(out[k], g[k]) for k in out}
    return out
