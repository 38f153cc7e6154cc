"""``python -m dhr_tpu_torch`` — the ported verbs of ``dhr_tpu``'s CLI.

- ``index``   merge shard files and optionally int8-quantize them;
- ``search``  GIP retrieval on the GPU -> TREC run file.

Flag names follow ``python -m dhr_tpu``.  Flags of modes that are not ported
yet are accepted by name and fail with a message saying so.  ``search``
runs on the GPU; ``--device cpu`` runs the plain PyTorch path instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

logger = logging.getLogger("dhr_tpu_torch")

_UNPORTED_SEARCH = {
    "--IP": "ip mode",
    "--PQIP": "pq mode",
    "--fused-candidates": "fused candidate selection",
    "--candidate-block": "fused candidate selection",
    "--escalate-pool": "two-tier escalation",
    "--escalate-margin": "two-tier escalation",
    "--escalate-calibrate": "two-tier escalation",
    "--escalate-miss-mass": "two-tier escalation",
    "--pool-calibrate": "pool calibration",
    "--row-chunk": "row-chunked ip search",
    "--shard-over-devices": "multi-GPU sharding",
    "--total-shard": "process-level index sharding",
    "--shard": "process-level index sharding",
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
    if args.layout != "auto":
        return args.layout
    return "both" if args.rerank else "dim"


def cmd_search(args):
    import torch

    from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
    from dhr_tpu_torch.retrieval.searcher import SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.trec import write_run

    packed = PackedIndex.load(args.index_path)
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
        theta=0.0 if args.brute_force else args.theta,
        rerank=args.rerank,
        agip_topk=args.agip_topk,
        lam=args.lamda,
        max_important_dims=args.max_important_dims,
        query_batch=args.query_batch,
        approx_candidates=not args.exact_candidates,
        candidate_bf16=not args.no_candidate_bf16,
        candidate_slices=slices if slices == "auto" else int(slices),
    )
    searcher = Searcher(index, cfg, device=args.device)
    results, scores = searcher.search_run(qids, qv, qi)
    write_run(args.output, results, scores, run_name=args.run_name)
    logger.info("wrote %s (%d queries)", args.output, len(results))
    print("DHR_TIMING " + json.dumps(
        {"verb": "search", **searcher.last_timing}), file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dhr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index")
    p.add_argument("--inputs", required=True, help="glob of shard files")
    p.add_argument("--output", required=True)
    p.add_argument("--lex-dim", type=int, default=None)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--pq-m", action=_Unported, what="PQ quantization")
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("search")
    p.add_argument("--index-path", required=True)
    p.add_argument("--query-path", required=True)
    p.add_argument("--output", default="result.trec")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--theta", type=float, default=0.1)
    p.add_argument("--brute-force", action="store_true")
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
    p.add_argument("--layout", default="auto",
                   choices=["auto", "both", "row", "dim"],
                   help="device plane layout; auto: 'both' with --rerank, "
                        "else 'dim'")
    p.add_argument("--run-name", default="dhr_tpu")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "the plain PyTorch path")
    for flag, what in _UNPORTED_SEARCH.items():
        p.add_argument(flag, action=_Unported, what=what)
    p.set_defaults(fn=cmd_search)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
