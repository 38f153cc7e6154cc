"""Corpus encoding on DeepSeek-V2-Lite: ``Encoder.encode_corpus`` over
length-bucketed batches of token-id passages, the planes copied back to
the host, call after call (the ``encode_corpus`` driver's flow on a
decoder).

Set-up draws the weights on the device from the seed, tensor by tensor,
in bf16 (``benchmarks.gen.weights_decoder``) and hands them to the port's
``BiEncoder`` itself (``benchmarks.port_model_decoder``), which the
``Encoder`` takes without a copy; draws a pool of passages from the seed
(the length spec's quantiles in a seeded order, Zipf ids, BOS / EOS
around each); and encodes the pool's first call once,
which warms every bucket length the traffic uses, plus any other length a
later call uses.  Each call of the window encodes ``passages_per_call``
passages through ``bucketed_encode_batches``.

Correctness: the same passages of every call, drawn from the seed, are
encoded again by the f32 reference (``reference.dhr_decoder``), which
draws each layer's weights again in f32, and compared per passage as the
``encode_corpus`` driver does (``lexical_gap``, ``cls_gap``,
``fold_gap``; ``plane_gaps``).  The reference also counts the checked
real tokens' near ties of the gate (6th and 7th scores within 1% of the
6th), printed as a ``# reference`` line: there bf16 may route a token to
another 6th expert than f32 does, which the limits cover.
"""

from __future__ import annotations

import itertools
import time

import numpy as np


def run(ctx):
    torch = ctx.torch
    dev = ctx.device
    from benchmarks import roofline_moe
    from benchmarks.drivers.encode_corpus import checked_rows
    from benchmarks.gen.weights_decoder import make_weights, model_dims
    from benchmarks.harness import import_program, repeat
    from benchmarks.port_model_decoder import port_bi_encoder, \
        retriever_config

    cfg, tr = ctx.config, ctx.traffic
    ecfg, m = cfg["encode"], cfg["model"]
    torch.ones(1, device=dev)
    ctx.setup_part("cuda_start")

    rcfg = retriever_config(cfg, ecfg["compute_dtype"])
    weights = make_weights(cfg, ctx.seed, dev,
                           getattr(torch, ecfg["compute_dtype"]))
    ctx.setup_part("weight_generation")
    model = port_bi_encoder(weights, rcfg)
    del weights
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
    bs = int(ecfg["batch_size"])
    window = [lens[(k % n_chunks) * per_call:(k % n_chunks + 1) * per_call]
              + 2 for k in range(calls)]
    ctx.work["flops"] = sum(roofline_moe.tower_flops(n, d) for n in window)
    ctx.work["routed_flops"] = sum(roofline_moe.routed_expert_flops(n, d)
                                   for n in window)
    ctx.work["window_batches"] = calls * -(-per_call // bs)
    del enc, tower
    ctx.free()

    gaps = reference_gaps(ctx, toks, kept, checked, per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)
    return {"e2e": {"encode_pps": done / ctx.window_s},
            "attempted": done, "failed": 0}


def quantile_lengths(spec: dict, n: int, r: np.random.Generator):
    """``n`` content-token counts: the log-normal length spec's ``n``
    quantiles (at ``(i + 0.5) / n``), rounded and clipped to ``[min,
    max]``, in an order drawn from ``r``.  Every seed's pool then holds
    the same lengths, so a window's work does not move with the seed (a
    pool of 8,192 independent draws moves its mean length by ~0.4% from
    seed to seed)."""
    from statistics import NormalDist

    s = float(spec["sigma"])
    mu = np.log(float(spec["mean"])) - s * s / 2
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    out = np.clip(np.rint(np.exp(mu + s * z)), spec["min"], spec["max"])
    return r.permutation(out.astype(np.int64))


def passages(ctx):
    """The pool's token-id passages (Zipf ids) and their content
    lengths."""
    from benchmarks.gen.tokens import rng, zipf_ids

    tr = ctx.traffic
    n = int(tr["passages_per_call"]) * int(tr["pool_calls"])
    r = rng(ctx.seed, 0xE1C)
    lens = quantile_lengths(tr["passage_tokens"], n, r)
    flat = zipf_ids(int(lens.sum()), r, vocab=int(tr["token_ids"]["hi"]),
                    lo=int(tr["token_ids"]["lo"]))
    return np.split(flat, np.cumsum(lens)[:-1]), lens


def reference_planes(ctx, toks, precision: str = "f32"):
    """The reference's ``(lexical (n, V), semantic (n, proj))`` f32 of
    ``toks`` and its ``[near ties, token-layers]``."""
    torch = ctx.torch
    from benchmarks.drivers.encode_corpus import collate
    from benchmarks.gen.weights_decoder import model_dims
    from benchmarks.reference import no_tf32
    from benchmarks.reference.dhr_decoder import dhr_reps
    from benchmarks.reference.dhr_model import Math

    no_tf32()
    m = ctx.config["model"]
    ids, mask = collate(toks, m["bos_token_id"], m["eos_token_id"])
    ties = []
    with torch.no_grad():
        lex, sem = dhr_reps(model_dims(ctx.config), ctx.seed,
                            torch.as_tensor(ids, device=ctx.device),
                            torch.as_tensor(mask, device=ctx.device),
                            Math(precision), ties=ties)
    return lex, sem, np.sum(ties, axis=0).tolist()


def reference_gaps(ctx, toks, kept, checked, per_call,
                   precision: str = "f32") -> dict:
    """The compared numbers of the ``kept`` planes, the reference computed
    once for the checked passages of every call kept."""
    from benchmarks.drivers.encode_corpus import plane_gaps

    torch = ctx.torch
    head = ctx.config["head"]
    chunks = sorted({c for c, _, _ in kept})
    sel = [toks[c * per_call + i] for c in chunks for i in checked]
    lexical, semantic, (near, total) = reference_planes(ctx, sel, precision)
    print(f"# reference near_tie_share {near / max(total, 1)!r} "
          f"({near} of {total} token-layers)", file=ctx.out, flush=True)
    out = {"lexical_gap": 0.0, "cls_gap": 0.0, "fold_gap": 0.0}
    n = len(checked)
    for j, c in enumerate(chunks):
        part = slice(j * n, (j + 1) * n)
        for _, values, folds in (k for k in kept if k[0] == c):
            g = plane_gaps(torch, lexical[part], semantic[part], values,
                           folds, head["dlr_out_dim"], head["remove_dims"])
            out = {k: max(out[k], g[k]) for k in out}
    return out


def control(ctx) -> None:
    """The control: the reference computed with fp8 products, one step
    below the configuration's bf16, put in the program's place: its planes
    (f16 values, fold indices) compared as the program's are."""
    from benchmarks.drivers.encode_corpus import checked_rows
    from benchmarks.reference.dhr_model import densify

    head = ctx.config["head"]
    toks, _ = passages(ctx)
    per_call = int(ctx.traffic["passages_per_call"])
    checked = checked_rows(ctx)
    chunks = range(int(ctx.traffic["pool_calls"]))
    sel = [toks[c * per_call + i] for c in chunks for i in checked]
    lexical, semantic, _ = reference_planes(ctx, sel, "fp8")
    vals, folds = densify(lexical, head["dlr_out_dim"], head["remove_dims"])
    planes = ctx.torch.cat([vals, semantic], dim=1).half().float() \
        .cpu().numpy()
    folds = folds.cpu().numpy()
    n = len(checked)
    kept = [(c, planes[j * n:(j + 1) * n], folds[j * n:(j + 1) * n])
            for j, c in enumerate(chunks)]
    gaps = reference_gaps(ctx, toks, kept, checked, per_call)
    for name, v in gaps.items():
        ctx.compare(name, v)
