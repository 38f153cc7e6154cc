"""``python -m dhr_tpu_torch`` — the ported verbs of ``dhr_tpu``'s CLI.

- ``index``       merge shard files, optionally attach PQ codebooks
                  (``--pq-m``) and int8-quantize them;
- ``search``      gip / ip / pq retrieval on the GPU -> TREC run file, or,
                  with ``--escalate-calibrate`` / ``--pool-calibrate``, a
                  calibration report as JSON;
- ``merge-runs``  merge per-shard TREC runs;
- ``eval``        MRR / recall / nDCG of a run against qrels.

Flag names follow ``python -m dhr_tpu``.  Flags of what is not ported yet
are accepted by name and fail with a message saying so.  ``search`` and the
PQ build of ``index --pq-m`` run on the GPU; ``--device cpu`` runs them on
the CPU (``search``: the plain PyTorch path) instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

logger = logging.getLogger("dhr_tpu_torch")

_UNPORTED_SEARCH = {
    "--shard-over-devices": "multi-GPU sharding",
    "--candidate-recall": "approximate candidate recall targets",
}


class _Unported(argparse.Action):
    """A flag of a mode the port does not have yet: fail, naming it."""

    def __init__(self, option_strings, dest, what, **kwargs):
        self.what = what
        super().__init__(option_strings, dest, nargs="?", **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {self.what} is not ported to "
                     "dhr_tpu_torch yet (use python -m dhr_tpu)")


def cmd_index(args):
    from dhr_tpu_torch.retrieval.index import PackedIndex

    index = PackedIndex.merge_glob(args.inputs, lex_dim=args.lex_dim)
    if args.pq_m:
        index = index.quantize_pq(m=args.pq_m, device=args.device)
    if args.quantize:
        index = index.quantize()
    index.save(args.output)
    logger.info("index: %d rows x %d dims%s -> %s", index.num_rows,
                index.dim, " (int8)" if args.quantize else "", args.output)


def _load_queries(path: str):
    """``(values, indices or None, qids)`` from the query npz (+ .qids.json)
    or the reference's ``[query_embs, query_arg_idxs, qids]`` pickle."""
    if path.endswith((".pt", ".pkl", ".pickle")):
        import pickle

        with open(path, "rb") as f:
            qv, qi, qids = pickle.load(f)
        return (np.asarray(qv, np.float32),
                None if qi is None else np.asarray(qi),
                [str(q) for q in qids])
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        qv = z["values"]
        qi = z["indices"] if "indices" in z.files else None
    with open(path + ".qids.json") as f:
        qids = json.load(f)
    return qv, qi, qids


def _resolve_layout(args) -> str:
    """'auto': ip/pq candidates score row-major (one plane orientation);
    gip needs dim-major, plus row-major only when reranking."""
    if args.layout != "auto":
        return args.layout
    if args.ip or args.pqip:
        return "row"
    return "both" if args.rerank else "dim"


def _report(report: dict, output: str | None) -> None:
    print(json.dumps(report))
    if output:
        with open(output, "w") as f:
            json.dump(report, f)


def cmd_search(args):
    import torch

    from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
    from dhr_tpu_torch.retrieval.searcher import (
        SearchConfig,
        Searcher,
        calibrate_pool,
    )
    from dhr_tpu_torch.retrieval.trec import write_run

    packed = PackedIndex.load(args.index_path)
    if args.total_shard > 1:
        per = packed.num_rows // args.total_shard
        start = per * args.shard
        stop = packed.num_rows if args.shard == args.total_shard - 1 \
            else start + per
        packed = packed.slice_rows(start, stop)
    qv, qi, qids = _load_queries(args.query_path)
    value_dtype = None if args.value_dtype is None else {
        "bf16": torch.bfloat16, "f16": torch.float16,
        "f32": torch.float32}[args.value_dtype]
    index = DeviceIndex.from_packed(packed, value_dtype=value_dtype,
                                    layout=_resolve_layout(args),
                                    device=args.device)
    slices = args.candidate_slices
    cfg = SearchConfig(
        topk=args.topk,
        mode="pq" if args.pqip else ("ip" if args.ip else "gip"),
        theta=0.0 if args.brute_force else args.theta,
        rerank=args.rerank,
        agip_topk=args.agip_topk,
        lam=args.lamda,
        max_important_dims=args.max_important_dims,
        query_batch=args.query_batch,
        approx_candidates=not args.exact_candidates,
        candidate_bf16=not args.no_candidate_bf16,
        candidate_slices=slices if slices == "auto" else int(slices),
        fused_candidates={"off": False, "on": True,
                          "auto": "auto"}[args.fused_candidates],
        candidate_block=args.candidate_block,
        escalate_pool=args.escalate_pool,
        escalate_margin=args.escalate_margin,
        row_chunk=args.row_chunk,
    )
    if args.pool_calibrate:
        _report(calibrate_pool(
            index, cfg, qv, qi,
            pools=[int(x) for x in args.pool_calibrate.split(",")],
            overlap_target=args.pool_overlap_target,
            passes=args.pool_passes), args.output)
        return
    searcher = Searcher(index, cfg, device=args.device)
    if args.escalate_calibrate:
        _report(searcher.calibrate_escalation(
            qv, qi, miss_mass_target=args.escalate_miss_mass), args.output)
        return
    results, scores = searcher.search_run(qids, qv, qi)
    write_run(args.output, results, scores, run_name=args.run_name)
    logger.info("wrote %s (%d queries)", args.output, len(results))
    print("DHR_TIMING " + json.dumps(
        {"verb": "search", **searcher.last_timing}), file=sys.stderr)


def cmd_merge_runs(args):
    from dhr_tpu_torch.retrieval.trec import merge_runs

    merge_runs(args.inputs, args.output, topk=args.topk,
               run_name=args.run_name)
    logger.info("merged -> %s", args.output)


def cmd_eval(args):
    from dhr_tpu_torch.eval.metrics import (
        evaluate_run,
        mrr_at_k,
        recall_at_k,
        recall_cap_at_k,
        zero_positive_queries,
    )
    from dhr_tpu_torch.retrieval.trec import read_qrels, read_run

    qrels = read_qrels(args.qrels)
    run = read_run(args.run)
    # queries without a positive judgment count 0 in our recall metrics
    # where BEIR's convention is undefined; report how many there are
    n_zero = zero_positive_queries(qrels)
    if args.rcap:
        out = {f"R_cap@{args.k}": recall_cap_at_k(qrels, run, args.k,
                                                  strict=args.strict)}
        if n_zero:
            out["zero_positive_queries"] = n_zero
        print(json.dumps(out))
        return
    out = {
        "MRR@10": mrr_at_k(qrels, run, 10),
        "Recall@1000": recall_at_k(qrels, run, 1000, strict=args.strict),
    }
    out.update(evaluate_run(qrels, run, k_values=(10, 100)))
    if n_zero:
        out["zero_positive_queries"] = n_zero
    print(json.dumps(out, indent=1))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dhr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index")
    p.add_argument("--inputs", required=True, help="glob of shard files")
    p.add_argument("--output", required=True)
    p.add_argument("--lex-dim", type=int, default=None)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--pq-m", type=int, default=None,
                   help="attach PQ codebooks with m subquantizers "
                        "(the reference's PQ64 = 64)")
    p.add_argument("--device", default=None,
                   help="torch device of the PQ build (--pq-m); default "
                        "the GPU (cuda), 'cpu' runs it on the CPU")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("search")
    p.add_argument("--index-path", required=True)
    p.add_argument("--query-path", required=True)
    p.add_argument("--output", default="result.trec")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--theta", type=float, default=0.1)
    p.add_argument("--brute-force", action="store_true")
    p.add_argument("--IP", dest="ip", action="store_true",
                   help="inner-product candidates (theta unused)")
    p.add_argument("--PQIP", dest="pqip", action="store_true",
                   help="PQ-code (ADC) candidates; needs 'index --pq-m'")
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--agip-topk", type=int, default=10000)
    p.add_argument("--value-dtype", default=None,
                   choices=["bf16", "f16", "f32"],
                   help="device value plane dtype for float indexes "
                        "(default bf16; int8 indexes stay int8)")
    p.add_argument("--lamda", type=float, default=1.0)
    p.add_argument("--max-important-dims", type=int, default=128,
                   help="stage-1 scan length for theta mode; queries with "
                        "more above-theta dims are truncated in stage 1 "
                        "(exact again after --rerank)")
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--exact-candidates", action="store_true",
                   help="one exact top-k candidate pool instead of "
                        "stratified per-slice top-k")
    p.add_argument("--no-candidate-bf16", action="store_true",
                   help="keep f32 stage-1 candidate scores")
    p.add_argument("--candidate-slices", default="auto",
                   help="stratified candidate selection: top-(k/S) per "
                        "column band; 1 disables, default auto")
    p.add_argument("--fused-candidates", default="off",
                   choices=["off", "on", "auto"],
                   help="reduce each --candidate-block row group to its "
                        "best row inside the theta-pass kernel (K3), so "
                        "selection reads a G-times smaller plane; 'auto' = "
                        "on when the reduced plane holds twice the pool")
    p.add_argument("--candidate-block", type=int, default=8,
                   help="row-group size for --fused-candidates")
    p.add_argument("--escalate-pool", type=int, default=0,
                   help="two-tier escalation: tier-1 candidate pool size; "
                        "queries whose reranked topk-th score sits within "
                        "--escalate-margin of the tier-1 pool floor search "
                        "again at --agip-topk. 0 disables")
    p.add_argument("--escalate-margin", type=float, default=0.0,
                   help="escalation trigger margin (calibrate with "
                        "--escalate-calibrate)")
    p.add_argument("--escalate-calibrate", action="store_true",
                   help="instead of searching, print the recommended "
                        "--escalate-margin for these queries as JSON "
                        "(needs --escalate-pool)")
    p.add_argument("--escalate-miss-mass", type=float, default=0.95,
                   help="calibration target: share of the missing-row mass "
                        "the escalated queries must cover")
    p.add_argument("--pool-calibrate", default=None,
                   help="instead of searching, sweep these comma-separated "
                        "--agip-topk pools on these queries and print q/s "
                        "and top-k overlap against the largest as JSON")
    p.add_argument("--pool-overlap-target", type=float, default=0.99,
                   help="mean top-k overlap a pool must keep against the "
                        "largest pool to be recommended")
    p.add_argument("--pool-passes", type=int, default=3,
                   help="timed passes per pool, interleaved")
    p.add_argument("--layout", default="auto",
                   choices=["auto", "both", "row", "dim"],
                   help="device plane layout; auto: 'row' for --IP/--PQIP, "
                        "'both' with --rerank, else 'dim'")
    p.add_argument("--row-chunk", type=int, default=0,
                   help="row-chunked stage 1 for --IP on the row-major "
                        "plane: 0 auto, -1 off, >0 target rows per chunk")
    p.add_argument("--total-shard", type=int, default=1,
                   help="search rows [shard/total-shard] of the index only "
                        "(merge the runs with merge-runs)")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--run-name", default="dhr_tpu")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "the plain PyTorch path")
    for flag, what in _UNPORTED_SEARCH.items():
        p.add_argument(flag, action=_Unported, what=what)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("merge-runs")
    p.add_argument("--inputs", required=True, help="glob of TREC runs")
    p.add_argument("--output", required=True)
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--run-name", default="dhr_tpu")
    p.set_defaults(fn=cmd_merge_runs)

    p = sub.add_parser("eval")
    p.add_argument("--qrels", required=True)
    p.add_argument("--run", required=True)
    p.add_argument("--rcap", action="store_true")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--strict", action="store_true",
                   help="fail when a qrels query has no positive judgment "
                        "instead of counting it as recall 0")
    p.set_defaults(fn=cmd_eval)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
