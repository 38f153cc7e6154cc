"""Document encoding on NVIDIA-Nemotron-3-Nano-30B-A3B, the whole model on
this chip: ``Encoder.encode_corpus`` over length-bucketed batches of
token-id documents of up to 2,048 tokens, the planes copied back to the
host, call after call (the ``encode_docs_kimi`` driver's flow, its
documents and route bookkeeping imported from there).

Set-up builds the port's configuration first (a program without
Nemotron-H's blocks refuses it at once), draws the weights on the device
from the seed, tensor by tensor, in bf16 (``benchmarks.gen.
weights_nemotron``) and hands them to the port's ``BiEncoder``
(``benchmarks.port_model_nemotron``), which the ``Encoder`` takes without
a copy; draws a pool of documents from the seed
(``encode_docs_kimi.documents``); and encodes every bucket length the
pool's calls use once.  Each call of the window encodes
``passages_per_call`` documents through ``bucketed_encode_batches``.

Correctness: the same documents of every call, drawn from the seed, are
encoded again by the f32 reference (``reference.dhr_nemotron_h``: the SSD
recurrence token by token), which draws each block's weights again in
f32, and compared per document as the ``encode_corpus`` driver does
(``lexical_gap``, ``cls_gap``, ``fold_gap``; ``plane_gaps``).  In the
window a forward hook on each MoE block's gate keeps the experts it chose
(as uint8: a cast a block a batch); the reference takes the checked
documents' experts of that call in place of its own top 6, with weights
from its own scores, and ``route_gap`` is how far the program's choice
falls below the reference's own: its 6th best choice score less the least
of the chosen experts', the largest over the checked real token-blocks
(``encode_docs_kimi``'s reason: the random 128-way router's near ties
would turn bf16 rounding into another expert).
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from benchmarks.drivers.encode_docs_kimi import checked_routes, documents


def run(ctx):
    torch = ctx.torch
    dev = ctx.device
    from benchmarks import roofline_mamba
    from benchmarks.drivers.encode_corpus import checked_rows
    from benchmarks.gen.weights_nemotron import make_weights, model_dims
    from benchmarks.harness import import_program, repeat
    from benchmarks.port_model_decoder import port_bi_encoder
    from benchmarks.port_model_nemotron import retriever_config

    cfg, tr = ctx.config, ctx.traffic
    ecfg, m = cfg["encode"], cfg["model"]
    rcfg = retriever_config(cfg, ecfg["compute_dtype"])
    torch.ones(1, device=dev)
    ctx.setup_part("cuda_start")

    weights = make_weights(cfg, ctx.seed, dev,
                           getattr(torch, ecfg["compute_dtype"]))
    ctx.setup_part("weight_generation")
    model = port_bi_encoder(weights, rcfg)
    del weights
    ctx.setup_part("model_load")

    per_call = int(tr["passages_per_call"])
    n_chunks = int(tr["pool_calls"])
    toks, lens = documents(ctx)
    ids = [str(i) for i in range(len(toks))]
    ctx.setup_part("traffic_generation")

    enc_mod = import_program("dhr_tpu_torch.encode")
    enc = enc_mod.Encoder(model, rcfg, enc_mod.EncodeConfig(
        batch_size=int(ecfg["batch_size"]),
        remove_dims=int(cfg["head"]["remove_dims"])), device=dev)
    del model
    bos, eos, max_len = m["bos_token_id"], m["eos_token_id"], \
        int(ecfg["p_max_len"])

    def batches(c):
        s = slice(c * per_call, (c + 1) * per_call)
        out, _ = enc_mod.bucketed_encode_batches(
            ids[s], toks[s], enc.encode_cfg.batch_size, max_len, bos, eos)
        return out

    seen = set()
    for c in range(n_chunks):   # every bucket length in use, once
        todo = [b for b in batches(c) if b["input_ids"].shape[1] not in seen]
        seen |= {b["input_ids"].shape[1] for b in todo}
        if todo:
            enc.encode_corpus(todo)
    ctx.setup_part("warmup")

    tower = enc.model.encoder("passage")
    ctx.spans.hook(tower.backbone.encoder, "encode.transformer")
    ctx.spans.wrap(tower, "reps", "encode.head")
    ctx.spans.wrap(enc, "planes", "encode.densify")
    checked = checked_rows(ctx)
    gate_type = import_program("dhr_tpu_torch.models.decoder").MoEGate
    gates = [g for g in tower.modules() if isinstance(g, gate_type)]
    n_moe = len(gates)
    taken = []      # each gate call's experts, in the order of the calls

    def keep(_gate, _args, out):
        taken.append(out[0].to(torch.uint8))

    hooks = [g.register_forward_hook(keep) for g in gates]
    kept = []
    calls = 0
    with ctx.window() as t0:
        while True:
            c = calls % n_chunks
            packed = enc.encode_corpus(batches(c))
            where = {d: r for r, d in enumerate(packed.docids)}
            rows = [where[str(c * per_call + i)] for i in checked]
            kept.append((c, packed.values[rows], packed.indices[rows],
                         taken[:]))
            taken.clear()
            calls += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    for h in hooks:
        h.remove()
    del gates, hooks
    ctx.work["window_calls"] = calls
    more = itertools.count(calls)
    ctx.traced(repeat(
        lambda: enc.encode_corpus(batches(next(more) % n_chunks))))
    ctx.read_peak()
    done = calls * per_call
    d = model_dims(cfg)
    mamba = roofline_mamba.layer_counts(cfg)["mamba"]
    window = [lens[(k % n_chunks) * per_call:(k % n_chunks + 1) * per_call]
              + 2 for k in range(calls)]
    ctx.work["flops"] = sum(roofline_mamba.tower_flops(n, d) for n in window)
    ctx.work["mamba_scan_flops"] = mamba * sum(
        roofline_mamba.scan_flops(n, d) for n in window)
    ctx.work["mamba_scan_bytes"] = mamba * sum(
        roofline_mamba.scan_bytes(n, d) for n in window)
    ctx.work["window_batches"] = calls * -(-per_call
                                           // int(ecfg["batch_size"]))
    del enc, tower
    ctx.free()

    kept = [(c, values, folds,
             checked_routes(ctx, enc_mod, lens, c, checked, calls_of,
                            n_moe))
            for c, values, folds, calls_of in kept]
    gaps = reference_gaps(ctx, toks, kept, checked, per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)
    return {"e2e": {"encode_pps": done / ctx.window_s},
            "attempted": done, "failed": 0}


def reference_planes(ctx, toks, precision: str = "f32", routes=None,
                     no_bias: bool = False):
    """The reference's ``(lexical (n, V), semantic (n, proj))`` f32 of
    ``toks``, its ``[near ties, real token-blocks]`` and its ``log`` (the
    experts it took a document and MoE block, the route gaps: the
    reference's ``dhr_reps``), taking the experts ``routes`` gives where
    given."""
    torch = ctx.torch
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.gen.weights_nemotron import model_dims
    from benchmarks.reference import no_tf32
    from benchmarks.reference.dhr_model import Math
    from benchmarks.reference.dhr_nemotron_h import dhr_reps

    no_tf32()
    m = ctx.config["model"]
    ids, mask = collate(toks, m["bos_token_id"], m["eos_token_id"])
    ties, log = [], {"gaps": []}
    with torch.no_grad():
        lex, sem = dhr_reps(model_dims(ctx.config), ctx.seed,
                            torch.as_tensor(ids, device=ctx.device),
                            torch.as_tensor(mask, device=ctx.device),
                            Math(precision), ties=ties, routes=routes,
                            log=log, no_bias=no_bias)
    return lex, sem, np.sum(ties, axis=0).tolist(), log


def reference_gaps(ctx, toks, kept, checked, per_call) -> dict:
    """The compared numbers of the ``kept`` calls' planes, ``(call's
    chunk, values, folds, routes)`` each: the f32 reference computed once
    for the checked documents of every call kept, taking the experts that
    call chose (``routes``, ``checked_routes``'s), and the largest
    ``route_gap`` of those choices (the reference's own k-th best choice
    score less the least of the chosen experts')."""
    from benchmarks.drivers.encode_corpus import plane_gaps

    torch = ctx.torch
    head = ctx.config["head"]
    sel = [toks[c * per_call + i] for c, *_ in kept for i in checked]
    routes = [r for *_, call in kept for r in call]
    lexical, semantic, (near, total), log = reference_planes(
        ctx, sel, routes=routes)
    gaps = np.asarray(log["gaps"]).reshape(-1, 3)
    print(f"# reference near_tie_share {near / max(total, 1)!r} "
          f"({near} of {total} token-blocks); routes off its own top k "
          f"{float(gaps[:, 1].sum() / max(gaps[:, 2].sum(), 1))!r}",
          file=ctx.out, flush=True)
    out = {"lexical_gap": 0.0, "cls_gap": 0.0, "fold_gap": 0.0,
           "route_gap": float(gaps[:, 0].max(initial=0.0))}
    n = len(checked)
    for j, (_, values, folds, _) in enumerate(kept):
        part = slice(j * n, (j + 1) * n)
        g = plane_gaps(torch, lexical[part], semantic[part], values, folds,
                       head["dlr_out_dim"], head["remove_dims"])
        out.update({k: max(out[k], g[k]) for k in g})
    return out


def control(ctx, fault: str | None = None) -> None:
    """The control: the reference computed with fp8 products, one step
    below the configuration's bf16, put in the program's place: its planes
    (f16 values, fold indices) and the experts it chose compared as the
    program's are.  ``fault="router_no_bias"``: the f32 reference choosing
    its experts without the correction bias stands there instead."""
    from benchmarks.drivers.encode_corpus import checked_rows
    from benchmarks.reference.dhr_model import densify

    if fault not in (None, "router_no_bias"):
        raise ValueError(f"no fault {fault!r} in this cell")
    head = ctx.config["head"]
    toks, _ = documents(ctx)
    per_call = int(ctx.traffic["passages_per_call"])
    checked = checked_rows(ctx)
    chunks = range(int(ctx.traffic["pool_calls"]))
    sel = [toks[c * per_call + i] for c in chunks for i in checked]
    lexical, semantic, _, log = reference_planes(
        ctx, sel, "fp8" if fault is None else "f32", no_bias=bool(fault))
    vals, folds = densify(lexical, head["dlr_out_dim"], head["remove_dims"])
    planes = ctx.torch.cat([vals, semantic], dim=1).half().float() \
        .cpu().numpy()
    folds = folds.cpu().numpy()
    n = len(checked)
    kept = [(c, planes[j * n:(j + 1) * n], folds[j * n:(j + 1) * n],
             log["routes"][j * n:(j + 1) * n]) for j, c in enumerate(chunks)]
    del lexical, semantic, vals
    gaps = reference_gaps(ctx, toks, kept, checked, per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)
