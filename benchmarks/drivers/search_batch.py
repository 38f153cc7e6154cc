"""Offline batch retrieval: ``Searcher.search`` over the whole query set,
again and again, at the configuration's operating point.

Set-up generates the index planes and the query reps on the device from
the seed (the frozen synth generator), hands the planes to the program
through ``DeviceIndex.from_arrays``, and warms up one batch of each shape
the window uses.  Each call of the window searches every query (host
arrays in, the top-k back on the host, as the ``search`` verb runs it).

Correctness: for a sample of queries drawn from the seed, every call's
answer is held against the exact GIP of every row (``reference.gip``):

- ``score_gap``: the largest distance between a returned score and the
  exact score of the returned row, over the query's exact top-1 score;
- ``miss_share``: the share of the exact top-k that the answers missed,
  over every checked query of every call (a returned row counts where its
  exact score reaches the exact k-th score).  A mean, not the worst
  query's share: the staged search's misses vary from query to query, and
  the worst of 32 swings from seed to seed as far as the control reads.
"""

from __future__ import annotations

import time

import numpy as np


def make_data(ctx):
    """``(planes (v_i8, folds, scales), queries (qv, qf) on the device)``
    of the configuration and traffic, from the seed."""
    from benchmarks.gen.synth import SynthConfig, synth_index_planes, \
        synth_reps

    idx, tr = ctx.config["index"], ctx.traffic
    scfg = SynthConfig(lex_dim=int(idx["lex_dim"]),
                       cls_dim=int(idx["cls_dim"]))
    planes = synth_index_planes(ctx.seed, int(idx["rows"]), scfg,
                                chunk_rows=int(tr["chunk_rows"]),
                                device=ctx.device)[:3]
    qv, qf, _ = synth_reps(ctx.seed, int(tr["queries"]), scfg, role="query",
                           stream=int(tr["query_stream"]), device=ctx.device)
    return planes, (qv, qf)


def checked_queries(ctx) -> np.ndarray:
    from benchmarks.gen.tokens import rng

    n_q = int(ctx.traffic["queries"])
    return np.sort(rng(ctx.seed, 0x5EA).choice(
        n_q, size=min(int(ctx.traffic["checked_queries"]), n_q),
        replace=False))


def run(ctx):
    torch = ctx.torch
    dev = ctx.device
    from benchmarks import roofline
    from benchmarks.harness import import_program, repeat
    from benchmarks.reference import no_tf32
    from benchmarks.reference.gip import gip_all_rows

    idx, op = ctx.config["index"], ctx.config["search"]
    n_rows, lex = int(idx["rows"]), int(idx["lex_dim"])
    n_q = int(ctx.traffic["queries"])
    torch.ones(1, device=dev)
    ctx.setup_part("cuda_start")

    (v_i8, folds, scales), (qv_d, qf_d) = make_data(ctx)
    qv, qf = qv_d.cpu().numpy(), qf_d.cpu().numpy()
    ctx.setup_part("index_generation")

    retrieval = import_program("dhr_tpu_torch.retrieval")
    index = retrieval.DeviceIndex.from_arrays(
        v_i8, folds, np.arange(n_rows), lex, scales, device=dev)
    scfg_p = retrieval.SearchConfig(
        topk=int(op["topk"]), theta=float(op["theta"]),
        rerank=bool(op["rerank"]), agip_topk=int(op["pool"]),
        max_important_dims=int(op["max_important_dims"]),
        query_batch=int(op["query_batch"]))
    searcher = retrieval.Searcher(index, scfg_p, device=dev)
    ctx.setup_part("index_load")

    bs = scfg_p.query_batch
    warm = bs + (n_q % bs or bs)   # a full batch and the last batch's size
    searcher.search(qv[:min(warm, n_q)], qf[:min(warm, n_q)])
    ctx.setup_part("warmup")

    ctx.spans.wrap(searcher, "candidates", "search.candidates")
    ctx.spans.wrap(searcher, "stage2", "search.rerank")
    sample = checked_queries(ctx)
    kept, calls = [], 0
    with ctx.window() as t0:
        while True:
            scores, rows = searcher.search(qv, qf)
            kept.append((scores[sample].copy(), rows[sample].copy()))
            calls += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    ctx.work["window_calls"] = calls
    ctx.traced(repeat(lambda: searcher.search(qv, qf)))
    done = calls * n_q
    ctx.read_peak()
    cand = roofline.candidates_bytes(
        roofline.used_dims(qv, scales.cpu().numpy(), scfg_p.theta,
                           scfg_p.max_important_dims),
        bs, n_rows, lex, scfg_p.agip_topk)
    rerank = roofline.rerank_bytes(n_q, bs, min(scfg_p.agip_topk, n_rows),
                                   qv.shape[1], lex, scfg_p.topk)
    ctx.work["candidates_bytes"] = cand
    ctx.work["search_bytes"] = [a + b for a, b in zip(cand, rerank)]
    ctx.work["calls"] = calls
    del searcher, index
    ctx.free()

    no_tf32()
    exact = gip_all_rows(qv_d[torch.as_tensor(sample, device=dev)],
                         qf_d[torch.as_tensor(sample, device=dev)],
                         v_i8, folds, scales, lex)
    check_answers(ctx, exact, kept, scfg_p.topk)
    return {"e2e": {"search_qps": done / ctx.window_s},
            "attempted": done, "failed": 0}


def control(ctx) -> None:
    """The control: the exact search computed in bf16, one step below the
    configuration's f32 scores, put in the program's place and compared as
    the program's answers are."""
    torch = ctx.torch
    from benchmarks.reference import no_tf32
    from benchmarks.reference.gip import gip_all_rows, topk_rows

    no_tf32()
    (v_i8, folds, scales), (qv, qf) = make_data(ctx)
    sel = torch.as_tensor(checked_queries(ctx), device=ctx.device)
    lex = int(ctx.config["index"]["lex_dim"])
    exact = gip_all_rows(qv[sel], qf[sel], v_i8, folds, scales, lex)
    low = gip_all_rows(qv[sel], qf[sel], v_i8, folds, scales, lex,
                       precision="bf16")
    vals, rows = topk_rows(low, int(ctx.config["search"]["topk"]))
    check_answers(ctx, exact, [(vals.cpu().numpy(), rows.cpu().numpy())],
                  int(ctx.config["search"]["topk"]))


def check_answers(ctx, exact, kept, k: int) -> None:
    """Compare every kept answer with the exact scores of every row."""
    from benchmarks.reference.gip import topk_rows

    torch = ctx.torch
    top_vals, _ = topk_rows(exact, k)
    kth = top_vals[:, -1]
    scale = top_vals[:, 0].abs().clamp(min=1e-30)
    score_gap, misses = 0.0, []
    for scores, rows in kept:
        r = torch.as_tensor(rows, device=exact.device).long()
        s = torch.as_tensor(scores, device=exact.device).float()
        if r.shape[1] != k or (r < 0).any() or (r >= exact.shape[1]).any():
            score_gap, misses = float("inf"), [float("inf")]
            break
        ex = torch.gather(exact, 1, r)
        score_gap = max(score_gap, float(((s - ex).abs().amax(dim=1)
                                          / scale).max()))
        for i in range(r.shape[0]):
            u = torch.unique(r[i])
            hits = int((exact[i, u] >= kth[i] - 1e-6 * scale[i]).sum())
            misses.append(1.0 - min(hits, k) / k)
    print(f"# search worst_query_miss {max(misses)!r}", file=ctx.out)
    ctx.compare("score_gap", score_gap)
    ctx.compare("miss_share", sum(misses) / len(misses))
