"""``python -m dhr_tpu_torch`` — the ported verbs of ``dhr_tpu``'s CLI.

- ``encode``      tokenized corpus / queries -> packed planes (``.npz``),
                  on the GPU;
- ``index``       merge shard files, optionally attach PQ codebooks
                  (``--pq-m``) and int8-quantize them;
- ``search``      gip / ip / pq retrieval on the GPU -> TREC run file, or,
                  with ``--escalate-calibrate`` / ``--pool-calibrate``, a
                  calibration report as JSON;
- ``merge-runs``  merge per-shard TREC runs;
- ``eval``        MRR / recall / nDCG of a run against qrels.

Flag names follow ``python -m dhr_tpu``.  Flags of what is not ported yet
are accepted by name and fail with a message saying so.  ``encode``,
``search`` and the PQ build of ``index --pq-m`` run on the GPU; ``--device
cpu`` runs them on the CPU (the plain PyTorch path) instead.  Every verb
also accepts ``--config file.json`` whose keys are the long option names
(flags given on the command line win).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

import numpy as np

logger = logging.getLogger("dhr_tpu_torch")

_UNPORTED_SEARCH = {
    "--shard-over-devices": "multi-GPU sharding",
    "--candidate-recall": "approximate candidate recall targets",
}
_UNPORTED_ENCODE = {
    "--pack": "token packing",
    "--pack-segments": "token packing",
}


class _Unported(argparse.Action):
    """A flag of a mode the port does not have yet: fail, naming it."""

    def __init__(self, option_strings, dest, what, **kwargs):
        self.what = what
        super().__init__(option_strings, dest, nargs="?", **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {self.what} is not ported to "
                     "dhr_tpu_torch yet (use python -m dhr_tpu)")


def _apply_config_file(args: argparse.Namespace,
                       parser: argparse.ArgumentParser) -> argparse.Namespace:
    """Fill args from a JSON file; explicit (non-default) CLI flags win.  A
    key naming a flag that is not ported fails as the flag does."""
    cfg_path = getattr(args, "config", None)
    if not cfg_path:
        return args
    with open(cfg_path) as f:
        overrides = json.load(f)
    sub = getattr(args, "_subparser", parser)
    unported = {a.dest: a for a in sub._actions if isinstance(a, _Unported)}
    for key, value in overrides.items():
        key = key.replace("-", "_")
        if key in unported:
            action = unported[key]
            action(sub, args, value, action.option_strings[0])
        if getattr(args, key, None) == sub.get_default(key):
            setattr(args, key, value)
    return args


# ----------------------------------------------------------------- encode --


def _check_special_ids(args, vocab_size: int) -> None:
    """Out-of-vocabulary [CLS]/[SEP] ids would index past the embedding
    table; fail loudly instead."""
    for name in ("cls_token_id", "sep_token_id"):
        tid = getattr(args, name, None)
        if tid is not None and tid >= vocab_size:
            raise SystemExit(
                f"--{name.replace('_', '-')}={tid} is out of range for "
                f"vocab_size={vocab_size}; pass in-vocab special-token ids "
                "(e.g. --cls-token-id 1 --sep-token-id 2 with --tiny-vocab)"
            )


def _model_cfg_from_args(args):
    """DistilBERT-base computes in bf16; an HF-loaded model in f32 unless
    ``--bf16``; ``--tiny`` always in f32 (the reference's rule)."""
    import torch

    from dhr_tpu_torch.models.retrievers import RetrieverConfig
    from dhr_tpu_torch.models.transformer import EncoderConfig

    if args.model_name_or_path:
        from dhr_tpu_torch.models.hf_io import encoder_config_from_hf

        enc = encoder_config_from_hf(
            args.model_name_or_path,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
        )
    elif args.tiny:
        enc = EncoderConfig.tiny(vocab_size=args.tiny_vocab,
                                 dtype=torch.float32)
    else:
        enc = EncoderConfig.distilbert_base()
    cfg = RetrieverConfig(
        model_type=args.model,
        encoder=enc,
        untie_encoder=args.untie_encoder,
        add_pooler=args.add_pooler,
        projection_dim=args.projection_dim,
        pooling=args.pooling,
        combine_cls=not args.no_combine_cls,
        dlr_out_dim=args.dlr_out_dim,
        agg_dim=args.agg_dim,
        semi_aggregate=args.semi_aggregate,
        skip_mlm=args.skip_mlm,
    )
    _check_special_ids(args, cfg.encoder.vocab_size)
    return cfg


def _load_init_params(args, model_cfg):
    """A ``BiEncoder`` with random weights (a fixed seed), then, given
    ``--model-name-or-path``, the HF checkpoint's backbone and its sidecar
    heads."""
    import torch

    from dhr_tpu_torch.models.flax_params import (
        load_flax_params,
        random_flax_params,
    )
    from dhr_tpu_torch.models.hf_io import (
        load_hf_backbone,
        load_hf_state_dict,
        load_sidecar_head,
    )
    from dhr_tpu_torch.models.retrievers import BiEncoder

    model = BiEncoder(model_cfg)
    load_flax_params(model, random_flax_params(
        model_cfg, torch.Generator().manual_seed(0)))
    path = args.model_name_or_path
    if not path:
        return model
    sd = load_hf_state_dict(path)
    sides = [model.encoder_q] + ([model.encoder_p]
                                 if model_cfg.untie_encoder else [])
    for enc in sides:
        try:
            load_hf_backbone(enc.backbone, sd, model_cfg.encoder)
        except ValueError as e:
            raise SystemExit(f"--model {model_cfg.model_type} with "
                             f"{path}: {e}") from e
    for name, key in (("pooler", "pooler"), ("TermWeightTrans", "term_weight")):
        head = load_sidecar_head(path, name)
        if head is None:
            continue
        if hasattr(model.encoder_q, key):
            getattr(model.encoder_q, key).linear.load_state_dict(head["q"])
        if model_cfg.untie_encoder and head["p"] is not None and hasattr(
                model.encoder_p, key):
            getattr(model.encoder_p, key).linear.load_state_dict(head["p"])
    return model


def cmd_encode(args):
    from dhr_tpu_torch.data import load_tokenized_corpus
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.encode import (
        EncodeConfig,
        Encoder,
        bucketed_encode_batches,
    )

    device = resolve_device(args.device)
    model_cfg = _model_cfg_from_args(args)
    enc = Encoder(
        _load_init_params(args, model_cfg), model_cfg,
        EncodeConfig(batch_size=args.batch_size,
                     remove_dims=args.remove_dims),
        device=device,
    )
    ids, texts = load_tokenized_corpus(args.input)
    if args.encode_num_shard > 1:
        shard = np.array_split(np.arange(len(ids)), args.encode_num_shard)[
            args.encode_shard_index
        ]
        ids = [ids[i] for i in shard]
        texts = [texts[i] for i in shard]
    max_len = args.q_max_len if args.encode_is_qry else args.p_max_len

    order = None
    if args.length_bucketing:
        # sort-by-length batches padded to small bucket lengths: the same
        # reps, a fraction of the pad work; outputs restored below
        if model_cfg.model_type == "colbert":
            raise SystemExit(
                "--length-bucketing is not supported for colbert: token "
                "reps are (N, L, D) and need one common L")
        batches, order = bucketed_encode_batches(
            ids, texts, args.batch_size, max_len,
            args.cls_token_id, args.sep_token_id,
        )
    else:
        def plain():
            for start in range(0, len(ids), args.batch_size):
                toks = [
                    wrap_specials(t, max_len, args.cls_token_id,
                                  args.sep_token_id)
                    for t in texts[start: start + args.batch_size]
                ]
                yield collate_encode(ids[start: start + args.batch_size],
                                     toks, max_len)

        batches = plain()

    def _restore(*arrays):
        """Undo the length sort so outputs land in input order."""
        if order is None:
            return arrays
        inv = np.argsort(order)
        return tuple(a[inv] if a is not None else None for a in arrays)

    t_enc0 = time.perf_counter()
    if model_cfg.model_type == "colbert":
        role = "query" if args.encode_is_qry else "passage"
        reps, out_ids = enc.encode_tokens(batches, role)
        np.savez(args.output, token=reps)
        with open(args.output + ".ids.json", "w") as f:
            json.dump(list(map(str, out_ids)), f)
        logger.info("encoded %d %ss -> %s (token reps %s)", len(out_ids),
                    role, args.output, reps.shape)
    elif args.encode_is_qry:
        qv, qi, qids = enc.encode_queries(batches)
        qv, qi, qids_arr = _restore(qv, qi, np.asarray(qids, dtype=object))
        np.savez(args.output, values=qv,
                 **({"indices": qi} if qi is not None else {}))
        with open(args.output + ".qids.json", "w") as f:
            json.dump(list(map(str, qids_arr)), f)
        logger.info("encoded %d queries -> %s", len(qids_arr), args.output)
    else:
        packed = enc.encode_corpus(batches)
        values, indices, docids = _restore(packed.values, packed.indices,
                                           packed.docids)
        packed = dataclasses.replace(packed, values=values, indices=indices,
                                     docids=docids)
        packed.save(args.output)
        logger.info("encoded %d passages -> %s", packed.num_rows,
                    args.output)
    enc_wall = time.perf_counter() - t_enc0
    print("DHR_TIMING " + json.dumps({
        "verb": "encode", "items": len(ids), "device": str(device),
        "encode_wall_s": enc_wall,
        "items_per_s": len(ids) / max(enc_wall, 1e-9),
    }), file=sys.stderr)


# ------------------------------------------------------------- retrieval --


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


def _finish(p: argparse.ArgumentParser, fn) -> None:
    """Every verb takes ``--config``; ``_subparser`` gives the config rule
    the verb's own defaults."""
    p.add_argument("--config", default=None,
                   help="JSON file of long option names -> values; flags "
                        "given on the command line win")
    p.set_defaults(_subparser=p, fn=fn)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="dhr",
                   choices=["dense", "dhr", "dlr", "agg", "colbert"])
    p.add_argument("--model-name-or-path", default=None,
                   help="local HF checkpoint directory (+ pooler.pt / "
                        "TermWeightTrans.pt); default: random weights")
    p.add_argument("--untie-encoder", action="store_true")
    p.add_argument("--add-pooler", action="store_true")
    p.add_argument("--projection-dim", type=int, default=128)
    p.add_argument("--pooling", default="cls", choices=["cls", "mean"])
    p.add_argument("--no-combine-cls", action="store_true")
    p.add_argument("--dlr-out-dim", type=int, default=768)
    p.add_argument("--agg-dim", type=int, default=640)
    p.add_argument("--semi-aggregate", action="store_true")
    p.add_argument("--skip-mlm", action="store_true")
    p.add_argument("--remove-dims", type=int, default=570)
    p.add_argument("--bf16", action="store_true",
                   help="compute an HF-loaded model in bf16 (DistilBERT-"
                        "base without a checkpoint always does)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cls-token-id", type=int, default=101)
    p.add_argument("--sep-token-id", type=int, default=102)
    p.add_argument("--tiny", action="store_true",
                   help="random tiny encoder (smoke tests / quickstart)")
    p.add_argument("--tiny-vocab", type=int, default=1024)
    p.add_argument("--q-max-len", type=int, default=32)
    p.add_argument("--p-max-len", type=int, default=128)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dhr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("encode")
    _add_model_args(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--encode-is-qry", action="store_true")
    p.add_argument("--encode-num-shard", type=int, default=1)
    p.add_argument("--encode-shard-index", type=int, default=0)
    p.add_argument("--length-bucketing", action="store_true",
                   help="sort by length and pad each batch to a small "
                        "bucket length instead of max_len (same reps, "
                        "less pad work on short-document corpora)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    for flag, what in _UNPORTED_ENCODE.items():
        p.add_argument(flag, action=_Unported, what=what)
    _finish(p, cmd_encode)

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
    _finish(p, cmd_index)

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
    _finish(p, cmd_search)

    p = sub.add_parser("merge-runs")
    p.add_argument("--inputs", required=True, help="glob of TREC runs")
    p.add_argument("--output", required=True)
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--run-name", default="dhr_tpu")
    _finish(p, cmd_merge_runs)

    p = sub.add_parser("eval")
    p.add_argument("--qrels", required=True)
    p.add_argument("--run", required=True)
    p.add_argument("--rcap", action="store_true")
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--strict", action="store_true",
                   help="fail when a qrels query has no positive judgment "
                        "instead of counting it as recall 0")
    _finish(p, cmd_eval)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = build_parser()
    args = _apply_config_file(parser.parse_args(argv), parser)
    args.fn(args)


if __name__ == "__main__":
    main()
