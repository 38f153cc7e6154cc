"""Rep statistics of the bench generator, and staged-vs-exact agreement.

Port of ``tools/rep_stats.py`` on the port's ``retrieval.synth``,
``PackedIndex``, ``DeviceIndex`` and ``Searcher``.  The synthetic bench
distribution must (a) match trained-DHR concentration targets (~30-50
query dims above theta=0.3, Zipf fold usage, topical co-activation) and
(b) make the staged engine (theta=0.3, 48-dim scan cap, exact rerank)
agree with both the reference's theta semantics (every dim above theta
scanned) and exact GIP (theta=0) on final rankings.

``--from-corpus-npz`` / ``--from-query-npz`` measure the same statistics on
real encoded reps (a rehearsal workdir's ``*_corpus.npz`` /
``*_queries.npz``); a dense-family npz, which has no fold plane, is refused
by name.  ``--trained-stats`` trains a toy DHR model on a topical world
with the port's train driver and reports its reps' statistics.

Runs on the GPU (K1 and K2 serve the agreement searches); ``--device cpu``
runs the plain path.

Usage: python -m dhr_tpu_torch.tools.rep_stats [--n-corpus 204800]
           [--n-queries 64] [--device cpu] [--out stats.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def pct(x, q):
    return float(np.percentile(x, q))


def overlap_at_k(rows_a, rows_b, k):
    """Mean |top-k(a) ∩ top-k(b)| / k over queries."""
    out = []
    for a, b in zip(rows_a, rows_b):
        out.append(len(set(a[:k].tolist()) & set(b[:k].tolist())) / k)
    return float(np.mean(out))


def stats_from_planes(lexq, lexp, pf, n_folds, theta, cap):
    """Concentration statistics shared by the generator path and the
    --from-npz path (real rehearsal-checkpoint reps)."""
    n_above = (lexq > theta).sum(1)
    stats = {
        "query_dims_above_theta": {
            "mean": float(n_above.mean()), "std": float(n_above.std()),
            "p50": pct(n_above, 50), "p95": pct(n_above, 95),
            "p99": pct(n_above, 99), "max": int(n_above.max()),
            "frac_above_cap": float((n_above > cap).mean()),
        },
        "passage_dims_active": {
            "gt_0.05_mean": float((lexp > 0.05).sum(1).mean()),
            "gt_theta_mean": float((lexp > theta).sum(1).mean()),
        },
        "value_profile": {
            "q_active_mean": float(lexq[lexq > theta].mean())
            if (lexq > theta).any() else 0.0,
            "p_active_mean": float(lexp[lexp > 0.05].mean())
            if (lexp > 0.05).any() else 0.0,
            "p_p99": pct(lexp, 99),
        },
    }
    # fold skew: top-fold share per dim (uniform folds would give 1/n_folds)
    shares = []
    for d in range(0, lexp.shape[1], 31):
        h = np.bincount(pf[:4096, d].astype(np.int64) % n_folds,
                        minlength=n_folds)
        shares.append(h.max() / max(1, h.sum()))
    stats["fold_top_share_mean"] = float(np.mean(shares))
    stats["fold_uniform_share"] = 1.0 / n_folds
    return stats


def generator_stats(cfg, n_corpus, n_queries, theta, cap, device=None):
    """The generator's statistics at ``n_corpus`` rows (seed 0, queries on
    stream 1); returns ``(stats, corpus planes, queries)`` as tensors on
    ``device`` for :func:`agreement`."""
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    v_i8, folds, scales, topics = synth_index_planes(0, n_corpus, cfg,
                                                     device=device)
    qv, qf, qz = synth_reps(0, n_queries, cfg, "query", stream=1,
                            device=device)
    lex = cfg.lex_dim
    # corpus values back to f32 (score space) for the statistics
    lexp = (v_i8[:, :lex].float() * scales[:lex]).cpu().numpy()
    stats = stats_from_planes(qv[:, :lex].cpu().numpy(), lexp,
                              folds.cpu().numpy(), cfg.n_folds, theta, cap)
    return stats, (v_i8, folds, scales, topics), (qv, qf, qz)


def npz_stats(corpus_npz, query_npz, theta, cap, max_rows=0):
    """The same statistics from real encoded reps (a rehearsal workdir's
    ``*_corpus.npz`` / ``*_queries.npz``): the direct diff against the
    bench generator's assumed distribution.

    Returns (stats, packed, (qv, qf)) so the caller can also run the
    staged/exact agreement on a row subsample of the real planes.  A
    corpus npz without a fold plane (a dense family's) is refused.
    """
    from dhr_tpu_torch.retrieval.index import PackedIndex

    pk = PackedIndex.load(corpus_npz)
    if pk.indices is None:
        raise SystemExit(
            f"rep_stats: {corpus_npz} has no fold plane ('indices'): it "
            "holds a dense family's reps; these statistics measure lexical "
            "(DHR / DLR) value and fold planes")
    with np.load(query_npz if query_npz.endswith(".npz")
                 else query_npz + ".npz") as zq:
        qv = np.asarray(zq["values"], np.float32)
        qf = (np.asarray(zq["indices"], np.int32)
              if "indices" in zq else None)
    lex = pk.lex_dim
    n_rows = pk.values.shape[0] if not max_rows else min(
        max_rows, pk.values.shape[0])
    lexp = np.asarray(pk.values[:n_rows, :lex], np.float32)
    if pk.value_scales is not None:
        # int8-quantized npz: values are codes; dequantize per dim so the
        # theta statistics are in score space, not code space
        lexp *= np.asarray(pk.value_scales[:lex], np.float32)
    pf = np.asarray(pk.indices[:n_rows])
    n_folds = int(max(pf.max(), (qf[:, :lex].max() if qf is not None
                                 else 0))) + 1
    stats = stats_from_planes(qv[:, :lex], lexp, pf, n_folds, theta, cap)
    stats["n_rows_measured"] = int(n_rows)
    stats["n_queries"] = int(qv.shape[0])
    stats["lex_dim"] = int(lex)
    return stats, pk, (qv, qf)


def _runs(idx, qv, qf, base, variants, device):
    """Final rows of each ``(name, SearchConfig overrides)`` variant."""
    from dhr_tpu_torch.retrieval import SearchConfig, Searcher

    runs = {}
    for name, kw in variants:
        t0 = time.perf_counter()
        s = Searcher(idx, SearchConfig(**{**base, **kw}), device=device)
        _, rows = s.search(qv, qf)
        runs[name] = rows
        log(f"  {name}: {time.perf_counter() - t0:.1f}s")
    return runs


def agreement(cfg, corpus, queries, theta, cap, topk, pool, device=None):
    """Final-ranking agreement: staged vs reference-theta vs exact GIP."""
    from dhr_tpu_torch.retrieval import DeviceIndex

    v_i8, folds, scales, _ = corpus
    qv, qf, _ = queries
    n = v_i8.shape[0]
    docids = np.arange(n).astype(str).astype(object)
    idx = DeviceIndex.from_arrays(v_i8, folds, docids, lex_dim=cfg.lex_dim,
                                  value_scales=scales, device=device)
    base = dict(topk=topk, mode="gip", rerank=True, agip_topk=pool,
                query_batch=min(64, len(qv)))
    runs = _runs(idx, qv, qf, base, (
        ("staged", dict(theta=theta, max_important_dims=cap)),
        # reference semantics: EVERY above-theta dim scanned (no cap)
        ("reference_theta", dict(theta=theta,
                                 max_important_dims=cfg.lex_dim)),
        ("exact", dict(theta=0.0, rerank=False)),
    ), device)
    out = {}
    for k in (10, 100, topk):
        out[f"staged_vs_reference_theta@{k}"] = overlap_at_k(
            runs["staged"], runs["reference_theta"], k)
        out[f"staged_vs_exact@{k}"] = overlap_at_k(
            runs["staged"], runs["exact"], k)
        out[f"reference_theta_vs_exact@{k}"] = overlap_at_k(
            runs["reference_theta"], runs["exact"], k)
    return out


# the toy topical world of the trained-stats run: C topics of POOL tokens
# each; a passage draws L tokens from its topic's pool, a query 6
TOY_VOCAB, TOY_REMOVE, TOY_DLR = 70, 6, 8
TOY_TOPICS, TOY_POOL, TOY_PASSAGES, TOY_LEN = 8, 8, 64, 10


def _toy_world(rng):
    pools = [rng.choice(np.arange(2, TOY_VOCAB), TOY_POOL, replace=False)
             for _ in range(TOY_TOPICS)]
    psg_topic = np.arange(TOY_PASSAGES) % TOY_TOPICS
    passages = np.stack([rng.choice(pools[t], TOY_LEN)
                         for t in psg_topic]).astype(np.int32)
    return pools, psg_topic, passages


def _toy_groups(rng, pools, psg_topic, passages, n=96):
    groups = []
    for _ in range(n):
        t = int(rng.integers(0, TOY_TOPICS))
        q = rng.choice(pools[t], 6).astype(np.int32)
        pos = passages[rng.choice(np.flatnonzero(psg_topic == t))].tolist()
        negs = [passages[i].tolist()
                for i in rng.choice(np.flatnonzero(psg_topic != t), 4)]
        groups.append({"query": q.tolist(), "positives": [pos],
                       "negatives": negs})
    return groups


def trained_stats(theta, device=None):
    """Train a toy DHR model on a topical world (the port's train driver)
    and report the same concentration statistics of its reps (qualitative
    calibration evidence: trained reps concentrate query mass on few dims
    and skew fold usage)."""
    from dhr_tpu_torch.data import SamplingConfig
    from dhr_tpu_torch.encode import EncodeConfig, Encoder, iter_batches
    from dhr_tpu_torch.models import EncoderConfig, RetrieverConfig
    from dhr_tpu_torch.train.driver import RunConfig, run_training
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.step import LossConfig

    rng = np.random.default_rng(0)
    pools, psg_topic, passages = _toy_world(rng)
    groups = _toy_groups(rng, pools, psg_topic, passages)
    cfg = RetrieverConfig(
        model_type="dhr",
        encoder=EncoderConfig.tiny(vocab_size=TOY_VOCAB, dtype=torch.float32,
                                   hidden_dropout=0.0,
                                   attention_dropout=0.0),
        add_pooler=True, projection_dim=4, dlr_out_dim=TOY_DLR,
    )
    state = run_training(
        cfg, LossConfig(n_passages=5, remove_dims=TOY_REMOVE),
        OptimizerConfig(learning_rate=3e-3, total_steps=60, warmup_steps=5),
        RunConfig(num_epochs=10, batch_size=16, save_steps=10_000,
                  log_steps=50, ckpt_dir=None),
        groups, SamplingConfig(n_passages=5, q_max_len=6, p_max_len=10),
        device=device)
    enc = Encoder(state.model, cfg,
                  EncodeConfig(batch_size=32, remove_dims=TOY_REMOVE),
                  device=device)
    n_q = 64
    q_ids = np.stack([
        rng.choice(pools[i % len(pools)], 6) for i in range(n_q)
    ]).astype(np.int32)
    qv, qf, _ = enc.encode_queries(
        iter_batches([f"q{i}" for i in range(n_q)], q_ids,
                     np.ones_like(q_ids), 32))
    lex = np.asarray(qv[:, :TOY_DLR], np.float32)
    # toy dims are few; report the per-query fraction of dims carrying
    # theta-level mass and the value concentration (top-1 dim share)
    frac_above = (lex > theta).mean(axis=1)
    top1_share = lex.max(axis=1) / np.maximum(lex.sum(axis=1), 1e-9)
    pk = enc.encode_corpus(
        iter_batches([f"d{i}" for i in range(len(passages))],
                     passages, np.ones_like(passages), 32))
    pf = np.asarray(pk.indices)
    shares = [np.bincount(pf[:, d], minlength=1).max() / pf.shape[0]
              for d in range(pf.shape[1])]
    return {
        "note": ("toy 8-dim DLR trained on a topical world; "
                 "qualitative targets only"),
        "query_frac_dims_above_theta_mean": float(frac_above.mean()),
        "query_top1_dim_mass_share_mean": float(top1_share.mean()),
        "passage_fold_top_share_mean": float(np.mean(shares)),
        "fold_uniform_share": 1.0 / 39,
    }


def npz_agreement(pk, qv, qf, theta, cap, topk, pool, max_rows,
                  device=None):
    """Staged/reference-theta/exact agreement on the REAL rep planes (a
    row subsample bounds the cost; the full-scale number is the
    rehearsal's own calibration trace)."""
    from dhr_tpu_torch.retrieval import DeviceIndex
    from dhr_tpu_torch.retrieval.index import PackedIndex

    n = min(max_rows or pk.values.shape[0], pk.values.shape[0])
    sub = PackedIndex(pk.values[:n], pk.indices[:n], pk.docids[:n],
                      lex_dim=pk.lex_dim, value_scales=pk.value_scales)
    idx = DeviceIndex.from_packed(sub, device=device)
    base = dict(topk=min(topk, n), mode="gip", rerank=True,
                agip_topk=min(pool, n), query_batch=min(64, len(qv)))
    runs = _runs(idx, qv, qf, base, (
        ("staged", dict(theta=theta, max_important_dims=cap)),
        ("reference_theta", dict(theta=theta,
                                 max_important_dims=idx.lex_dim)),
        ("exact", dict(theta=0.0, rerank=False)),
    ), device)
    out = {"n_rows": int(n), "pool": min(pool, n)}
    for k in (10, 100, min(topk, n)):
        out[f"staged_vs_exact@{k}"] = overlap_at_k(
            runs["staged"], runs["exact"], k)
        out[f"reference_theta_vs_exact@{k}"] = overlap_at_k(
            runs["reference_theta"], runs["exact"], k)
    return out


def _drift(real, synth):
    """Key real-vs-generator ratios: where the bench distribution's
    assumptions break on actually-trained reps."""
    out = {}
    for path in (
        ("query_dims_above_theta", "mean"),
        ("query_dims_above_theta", "frac_above_cap"),
        ("passage_dims_active", "gt_theta_mean"),
        ("value_profile", "q_active_mean"),
        ("value_profile", "p_active_mean"),
    ):
        r, s = real, synth
        for k in path:
            r, s = r[k], s[k]
        out["/".join(path)] = {
            "real": round(r, 4), "synth": round(s, 4),
            "ratio": round(r / s, 3) if s else None,
        }
    out["fold_top_share"] = {
        "real": round(real["fold_top_share_mean"], 4),
        "synth": round(synth["fold_top_share_mean"], 4),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-corpus", type=int, default=204_800)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--topk", type=int, default=1000)
    ap.add_argument("--pool", type=int, default=10_000)
    ap.add_argument("--theta", type=float, default=0.3)
    ap.add_argument("--cap", type=int, default=48)
    ap.add_argument("--trained-stats", action="store_true")
    ap.add_argument("--from-corpus-npz", default=None,
                    help="measure REAL reps from a rehearsal workdir's "
                    "*_corpus.npz instead of the synth generator; pair "
                    "with --from-query-npz and the rehearsal's "
                    "calibrated --theta")
    ap.add_argument("--from-query-npz", default=None)
    ap.add_argument("--max-rows", type=int, default=204_800,
                    help="row subsample for --from-corpus-npz stats + "
                    "agreement; 0 = all rows")
    ap.add_argument("--agree", action="store_true",
                    help="with --from-corpus-npz: also run staged vs "
                    "exact agreement on the real planes subsample")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain path; default the GPU")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from dhr_tpu_torch.retrieval.synth import SynthConfig

    cfg = SynthConfig()
    if args.from_corpus_npz:
        if not args.from_query_npz:
            raise SystemExit("--from-corpus-npz needs --from-query-npz")
        log(f"real-rep stats from {args.from_corpus_npz} ...")
        real, pk, (qv, qf) = npz_stats(
            args.from_corpus_npz, args.from_query_npz, args.theta,
            args.cap, args.max_rows)
        n_cmp = real["n_rows_measured"]
        log(f"generator stats at matched n={n_cmp} ...")
        synth, _, _ = generator_stats(
            cfg, n_cmp, min(args.n_queries, qv.shape[0]),
            0.3, args.cap, args.device)  # calibrated at ITS theta=0.3
        report = {
            "mode": "from-npz (real rehearsal reps)",
            "corpus_npz": args.from_corpus_npz,
            "theta": args.theta, "cap": args.cap,
            "real": real, "generator_at_its_theta0.3": synth,
            "drift_real_vs_generator": _drift(real, synth),
        }
        if args.agree:
            log("agreement on real planes ...")
            report["agreement_real_planes"] = npz_agreement(
                pk, qv, qf, args.theta, args.cap, args.topk, args.pool,
                args.max_rows, args.device)
    else:
        log(f"generator stats at n={args.n_corpus} ...")
        stats, corpus, queries = generator_stats(
            cfg, args.n_corpus, args.n_queries, args.theta, args.cap,
            args.device)
        log("agreement runs ...")
        agr = agreement(cfg, corpus, queries, args.theta, args.cap,
                        args.topk, args.pool, args.device)
        report = {
            "config": dataclasses.asdict(cfg),
            "n_corpus": args.n_corpus, "n_queries": args.n_queries,
            "theta": args.theta, "cap": args.cap, "topk": args.topk,
            "pool": args.pool,
            "generator": stats, "agreement": agr,
        }
        if args.trained_stats:
            log("training toy model for rep-stat comparison ...")
            report["trained_toy"] = trained_stats(args.theta, args.device)
    js = json.dumps(report, indent=1)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    return report


if __name__ == "__main__":
    main()
