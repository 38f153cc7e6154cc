"""``python -m dhr_tpu_torch`` — the ported verbs of ``dhr_tpu``'s CLI.

- ``prepare-corpus``  tokenize a raw corpus -> JSONL (needs the
                  ``transformers`` package for ``--tokenizer``);
- ``densify``     sparse vectors (BM25, DeepImpact, uniCOIL, SPLADE) JSONL
                  -> packed ``(value, fold)`` planes (``.npz``), on the host;
- ``prepare-train``   MS MARCO tsvs -> train groups (the same);
- ``train``       train a retriever on the GPU, checkpoints and an HF
                  export under ``--output-dir``;
- ``encode``      tokenized corpus / queries -> packed planes (``.npz``),
                  on the GPU (``--pack``: several passages per row);
- ``index``       merge shard files, optionally attach PQ codebooks
                  (``--pq-m``) and int8-quantize them;
- ``search``      gip / ip / pq retrieval on the GPU -> TREC run file, or,
                  with ``--escalate-calibrate`` / ``--pool-calibrate``, a
                  calibration report as JSON;
- ``serve``       the resident HTTP search service over an index on the
                  GPU (micro-batching, a low-latency route, text queries
                  with ``--query-encoder``, reload, 503 shedding);
- ``merge-runs``  merge per-shard TREC runs;
- ``eval``        MRR / recall / nDCG of a run against qrels;
- ``rerank-eval`` score candidate lists (the EvalDataset JSONL) with a
                  model on the GPU, MAP / RPrec / NDCG / MRR;
- ``colbert-score``   MaxSim scores of (qid, pid) pairs over saved ColBERT
                  token reps, or (``--full-ranking``) exact MaxSim
                  retrieval of every query against every passage -> TREC;
- ``beir-preprocess``  a local BEIR dataset -> tokenized corpus / query
                  JSONL and qrels TSV (needs ``transformers``);
- ``beir``        BEIR zero-shot evaluation of local datasets: encode,
                  search and NDCG / Recall / R_cap on the GPU (the
                  tokenizer needs ``transformers``; nothing is fetched);
- ``info``        the environment as JSON: torch, CUDA, the device, the
                  kernels' build and the C++ host runtime.

Flag names follow ``python -m dhr_tpu``.  Flags of what is not ported yet
are accepted by name and fail with a message saying so.  ``train``,
``encode``, ``search``, ``serve``, ``rerank-eval``, ``colbert-score``,
``beir`` and the PQ build of ``index --pq-m`` run on the GPU;
``--device cpu`` runs them on the CPU (the plain PyTorch path) instead.
Every verb also accepts ``--config file.json`` whose keys are the long
option names (flags given on the command line win).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import logging
import sys
import time

import numpy as np

logger = logging.getLogger("dhr_tpu_torch")

_UNPORTED_SEARCH = {
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


def _load_tokenizer(path: str):
    """An HF tokenizer from a local directory; ``transformers`` is imported
    here only, by the ``prepare-*`` and ``beir*`` verbs and ``serve
    --query-encoder``."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


# ---------------------------------------------------------------- prepare --


def cmd_prepare_corpus(args):
    from dhr_tpu_torch.data.tokenize import tokenize_corpus_file

    n = tokenize_corpus_file(args.input, args.output,
                             _load_tokenizer(args.tokenizer),
                             max_len=args.max_len, schema=args.schema)
    logger.info("tokenized %d docs -> %s", n, args.output)


def cmd_prepare_train(args):
    from dhr_tpu_torch.data.examples import write_jsonl
    from dhr_tpu_torch.data.tokenize import (
        build_train_groups,
        read_negatives_tsv,
        read_qrels_tsv,
        read_queries_tsv,
    )

    groups = build_train_groups(
        read_queries_tsv(args.queries), read_qrels_tsv(args.qrels),
        read_negatives_tsv(args.negatives), _load_tokenizer(args.tokenizer),
        q_max_len=args.q_max_len, n_negatives=args.n_negatives)
    write_jsonl(args.output, groups)
    logger.info("wrote train groups -> %s", args.output)


# ------------------------------------------------------------------ train --


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


def _tower_dirs(path: str) -> tuple[str, str] | None:
    """The ``query_model/`` and ``passage_model/`` directories of an untied
    export (upstream's probe, DHR/modeling.py:499-548), or None when
    ``path`` does not hold both."""
    import os

    dirs = (os.path.join(path, "query_model"),
            os.path.join(path, "passage_model"))
    return dirs if all(os.path.isdir(d) for d in dirs) else None


def _model_cfg_from_args(args):
    """DistilBERT-base computes in bf16; an HF-loaded model in f32 unless
    ``--bf16`` (a ``deepseek_v2`` one on the card needs ``--bf16``);
    ``--tiny`` always in f32 (the reference's rule).  An
    untied export (``--untie-encoder``) gives its ``query_model``'s
    ``config.json``."""
    import os

    import torch

    from dhr_tpu_torch.models.decoder import DecoderConfig, check_card_dtype
    from dhr_tpu_torch.models.retrievers import RetrieverConfig
    from dhr_tpu_torch.models.transformer import EncoderConfig

    if args.model_name_or_path:
        from dhr_tpu_torch.models.hf_io import encoder_config_from_hf

        path = args.model_name_or_path
        towers = _tower_dirs(path)
        if towers and not args.untie_encoder and not os.path.exists(
                os.path.join(path, "config.json")):
            raise SystemExit(f"{path} is an untied export (query_model/, "
                             "passage_model/): pass --untie-encoder")
        enc = encoder_config_from_hf(
            towers[0] if towers and args.untie_encoder else path,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
        )
        if isinstance(enc, DecoderConfig):   # before any weight is read
            try:
                check_card_dtype(enc, args.device or "cuda")
            except ValueError as e:
                raise SystemExit(f"{path}: {e}") from None
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
    heads.  Untied (``model_cfg.untie_encoder``), an export holding
    ``query_model/`` and ``passage_model/`` gives each tower its own
    backbone and the root sidecars their q and p halves; a tied directory
    gives both towers the same backbone."""
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

    if model_cfg.causal:   # the decoder: its own init from seed 0
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = BiEncoder(model_cfg)
    else:
        model = BiEncoder(model_cfg)
        load_flax_params(model, random_flax_params(
            model_cfg, torch.Generator().manual_seed(0)))
    path = args.model_name_or_path
    if not path:
        return model
    towers = (model_cfg.untie_encoder and _tower_dirs(path)) or (path, path)
    sides = [(model.encoder_q, towers[0])] + (
        [(model.encoder_p, towers[1])] if model_cfg.untie_encoder else [])
    state_dicts: dict[str, dict] = {}
    for enc, d in sides:
        if d not in state_dicts:
            state_dicts[d] = load_hf_state_dict(d)
        try:
            load_hf_backbone(enc.backbone, state_dicts[d], model_cfg.encoder)
        except ValueError as e:
            raise SystemExit(f"--model {model_cfg.model_type} with "
                             f"{d}: {e}") from e
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


def _build_teacher(args, student_cfg):
    """The ColBERT teacher of TCT distillation, from ``--teacher-path``."""
    teacher_cfg = dataclasses.replace(student_cfg, model_type="colbert",
                                      add_pooler=True, untie_encoder=False)
    t_args = argparse.Namespace(**vars(args))
    t_args.model_name_or_path = args.teacher_path
    t_args.model = "colbert"
    return _load_init_params(t_args, teacher_cfg)


def cmd_train(args):
    import os

    from dhr_tpu_torch.data import (
        Corpus,
        SamplingConfig,
        load_train_groups,
        read_jsonl,
    )
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint
    from dhr_tpu_torch.train.driver import RunConfig, run_training
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.step import LossConfig

    mesh = None
    from dhr_tpu_torch.parallel.mesh import is_rank0, launched

    if launched():
        # one process per rank (torchrun): data-parallel over every rank,
        # --batch-size the global batch
        from dhr_tpu_torch.parallel.mesh import (
            DATA_AXIS, init_distributed, make_mesh)

        args.device = init_distributed(args.dist_backend, device=args.device,
                                       init_method=args.dist_init_method)
        mesh = make_mesh(axis=DATA_AXIS)
    device = resolve_device(args.device)
    model_cfg = _model_cfg_from_args(args)
    if model_cfg.causal:
        raise SystemExit("train does not take the decoder backbone yet: "
                         "its export and its benchmark are not written")
    model = _load_init_params(args, model_cfg)
    teacher = _build_teacher(args, model_cfg) if args.tct else None
    groups = load_train_groups(args.train_path)
    corpus = Corpus.load(args.corpus_path) if args.corpus_path else None
    clusters = (list(read_jsonl(args.query_cluster_path))
                if args.query_cluster_path else None)
    steps_per_epoch = max(len(groups) // args.batch_size, 1)
    t0 = time.perf_counter()
    state = run_training(
        model_cfg,
        LossConfig(n_passages=args.train_n_passages,
                   remove_dims=args.remove_dims, use_tct_teacher=args.tct),
        OptimizerConfig(
            learning_rate=args.learning_rate,
            warmup_steps=args.warmup_steps,
            total_steps=steps_per_epoch * args.num_epochs,
            weight_decay=args.weight_decay,
            freeze_word_embeddings=args.model in ("dhr", "dlr")),
        RunConfig(
            num_epochs=args.num_epochs, max_steps=args.max_steps,
            batch_size=args.batch_size, save_steps=args.save_steps,
            log_steps=args.log_steps, ckpt_dir=args.output_dir,
            grad_cache=args.grad_cache, gc_q_chunks=args.gc_q_chunks,
            gc_p_chunks=args.gc_p_chunks, seed=args.seed,
            profile_dir=args.profile_dir, metrics_path=args.metrics_path,
            rng_impl=args.rng_impl, pack_passages=args.pack_passages,
            pack_segments=args.train_pack_segments,
            pack_rows=args.pack_rows),
        groups,
        SamplingConfig(
            n_passages=args.train_n_passages, q_max_len=args.q_max_len,
            p_max_len=args.p_max_len, seed=args.seed,
            cls_id=args.cls_token_id, sep_id=args.sep_token_id),
        corpus=corpus, kd=args.kd, tasb_clusters=clusters, model=model,
        teacher=teacher, device=device, mesh=mesh)
    train_s = time.perf_counter() - t0
    if not is_rank0():
        return
    # the reference's save format (save_pretrained + sidecars), which both
    # packages load; families without an MLM head export encoder-only
    hf_config = None
    if args.model_name_or_path:
        cfg_path = os.path.join(args.model_name_or_path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                hf_config = json.load(f)
    export_hf_checkpoint(os.path.join(args.output_dir, "export"),
                         state.model, model_cfg, hf_config=hf_config)
    logger.info("training done; checkpoints in %s", args.output_dir)
    print("DHR_TIMING " + json.dumps({
        "verb": "train", "steps": state.step, "device": str(device),
        "train_wall_s": train_s}), file=sys.stderr)


# ----------------------------------------------------------------- encode --


def cmd_encode(args):
    from dhr_tpu_torch.data import load_tokenized_corpus
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.encode import (
        EncodeConfig,
        Encoder,
        bucketed_encode_batches,
        packed_encode_batches,
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
    if args.pack:
        # several documents per row, block-diagonal attention; corpus side
        # only (queries are short and near-uniform)
        if args.encode_is_qry:
            raise SystemExit("--pack applies to corpus encode only")
        if args.length_bucketing:
            raise SystemExit("--pack and --length-bucketing are exclusive")
        if model_cfg.model_type == "agg" and model_cfg.skip_mlm:
            raise SystemExit("--pack is not supported for agg with "
                             "--skip-mlm; use --length-bucketing")
        batches, order = packed_encode_batches(
            ids, texts, args.batch_size, max_len, args.pack_segments,
            args.cls_token_id, args.sep_token_id)
    elif args.length_bucketing:
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
        if args.pack:
            reps, out_ids = enc.encode_tokens_packed(batches, max_len)
            inv = np.argsort(order)
            reps, out_ids = reps[inv], [out_ids[i] for i in inv]
        else:
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
        packed = (enc.encode_corpus_packed(batches) if args.pack
                  else enc.encode_corpus(batches))
        values, indices, docids = _restore(packed.values, packed.indices,
                                           packed.docids)
        packed = dataclasses.replace(packed, values=values, indices=indices,
                                     docids=docids)
        packed.save(args.output)
        logger.info("encoded %d passages%s -> %s", packed.num_rows,
                    f" (packed, <={args.pack_segments} docs/row)"
                    if args.pack else "", args.output)
    enc_wall = time.perf_counter() - t_enc0
    from dhr_tpu_torch.ops import kernel_launches

    print("DHR_TIMING " + json.dumps({
        "verb": "encode", "items": len(ids), "device": str(device),
        "encode_wall_s": enc_wall,
        "items_per_s": len(ids) / max(enc_wall, 1e-9),
        "launches": kernel_launches(),
    }), file=sys.stderr)


# ---------------------------------------------------------------- densify --


def cmd_densify(args):
    from dhr_tpu_torch.data.examples import load_sparse_vectors
    from dhr_tpu_torch.densify_offline import DensifyConfig, densify_corpus

    cfg = DensifyConfig(model=args.weight_model, out_dim=args.dim)
    t0 = time.perf_counter()
    index = densify_corpus(load_sparse_vectors(args.input), cfg,
                           args.vocab_size, batch_size=args.batch_size)
    wall = time.perf_counter() - t0
    index.save(args.output)
    logger.info("densified %d docs (%d slice collisions) -> %s",
                index.num_rows, index.collisions, args.output)
    print("DHR_TIMING " + json.dumps({
        "verb": "densify", "docs": index.num_rows,
        "collisions": index.collisions, "densify_wall_s": wall,
        "docs_per_s": index.num_rows / max(wall, 1e-9)}), file=sys.stderr)


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


def _value_dtype(args):
    import torch

    return None if args.value_dtype is None else {
        "bf16": torch.bfloat16, "f16": torch.float16,
        "f32": torch.float32}[args.value_dtype]


def _search_config(args):
    """The ``SearchConfig`` of the ``search`` / ``serve`` flags."""
    from dhr_tpu_torch.retrieval.searcher import SearchConfig

    slices = args.candidate_slices
    return SearchConfig(
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


def _index_mesh(args):
    """The row-sharding mesh of ``--shard-over-devices``, or None.

    Under a launcher (torchrun) the index shards over every rank, each
    joining the process group with ``--dist-backend`` (default nccl on the
    card, gloo on the CPU; gloo lets several ranks share one card) and
    ``args.device`` becoming its device.  With no launcher, one visible
    card is one shard (the reference on one device); several cards need
    the launcher, named in the error."""
    if not args.shard_over_devices:
        return None
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.parallel.mesh import (
        INDEX_AXIS, init_distributed, launched, make_mesh)

    if not launched():
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            import torch

            n = torch.cuda.device_count()
            if n > 1:
                raise SystemExit(
                    f"--shard-over-devices sees {n} cards and no launcher: "
                    f"run one process per card, e.g. torchrun "
                    f"--nproc-per-node {n} -m dhr_tpu_torch "
                    f"{args.fn.__name__.removeprefix('cmd_')} "
                    f"--shard-over-devices ...")
        return None
    args.device = init_distributed(args.dist_backend, device=args.device,
                                   init_method=args.dist_init_method)
    return make_mesh(axis=INDEX_AXIS)


def cmd_search(args):
    from dhr_tpu_torch.parallel.mesh import is_rank0
    from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
    from dhr_tpu_torch.retrieval.searcher import Searcher, calibrate_pool
    from dhr_tpu_torch.retrieval.trec import write_run

    mesh = _index_mesh(args)
    packed = PackedIndex.load(args.index_path)
    if args.total_shard > 1:
        per = packed.num_rows // args.total_shard
        start = per * args.shard
        stop = packed.num_rows if args.shard == args.total_shard - 1 \
            else start + per
        packed = packed.slice_rows(start, stop)
    qv, qi, qids = _load_queries(args.query_path)
    index = DeviceIndex.from_packed(packed, value_dtype=_value_dtype(args),
                                    layout=_resolve_layout(args),
                                    device=args.device, mesh=mesh)
    del packed
    cfg = _search_config(args)
    # every rank runs the same calls (the sharded stages are collective);
    # rank 0 alone writes
    if args.pool_calibrate:
        report = calibrate_pool(
            index, cfg, qv, qi,
            pools=[int(x) for x in args.pool_calibrate.split(",")],
            overlap_target=args.pool_overlap_target,
            passes=args.pool_passes)
        if is_rank0():
            _report(report, args.output)
        return
    searcher = Searcher(index, cfg, device=args.device)
    if args.escalate_calibrate:
        report = searcher.calibrate_escalation(
            qv, qi, miss_mass_target=args.escalate_miss_mass)
        if is_rank0():
            _report(report, args.output)
        return
    results, scores = searcher.search_run(qids, qv, qi)
    if not is_rank0():
        return
    write_run(args.output, results, scores, run_name=args.run_name)
    logger.info("wrote %s (%d queries)", args.output, len(results))
    from dhr_tpu_torch.ops import kernel_launches

    print("DHR_TIMING " + json.dumps(
        {"verb": "search", **searcher.last_timing,
         "launches": kernel_launches()}), file=sys.stderr)


def cmd_serve(args):
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.retrieval.index import DeviceIndex, PackedIndex
    from dhr_tpu_torch.retrieval.searcher import Searcher
    from dhr_tpu_torch.parallel.mesh import is_rank0
    from dhr_tpu_torch.serve import (
        Lockstep, SearchService, follow, serve_service)

    mesh = _index_mesh(args)
    device = resolve_device(args.device)
    query_encoder = None
    if args.query_encoder and is_rank0():
        # resident text -> vector encoder for the /search_text endpoint
        from dhr_tpu_torch.encode import (
            EncodeConfig,
            Encoder,
            make_query_encoder,
        )

        tok_dir = args.tokenizer or args.model_name_or_path
        if not tok_dir:
            raise SystemExit("--query-encoder needs --tokenizer DIR (a local "
                             "HF tokenizer) or --model-name-or-path")
        model_cfg = _model_cfg_from_args(args)
        enc = Encoder(
            _load_init_params(args, model_cfg), model_cfg,
            EncodeConfig(batch_size=args.query_batch,
                         remove_dims=args.remove_dims),
            device=device)
        query_encoder = make_query_encoder(
            enc, _load_tokenizer(tok_dir), args.q_max_len, args.cls_token_id,
            args.sep_token_id)

    def index_loader(path):
        # the boot index's layout knobs, so a reload is exactly "the same
        # service over new data"
        return DeviceIndex.from_packed(
            PackedIndex.load(path), value_dtype=_value_dtype(args),
            layout=_resolve_layout(args), device=device, mesh=mesh)

    def make_searchers(index):
        main = Searcher(index, _search_config(args), device=device)
        small = None
        if args.micro_batch_ms > 0 and args.low_latency_batch > 0:
            # the SAME DeviceIndex: no second copy of the planes
            small = Searcher(index, dataclasses.replace(
                main.config, query_batch=args.low_latency_batch),
                device=device)
        return {"main": main, "small": small}

    pair = make_searchers(index_loader(args.index_path))
    if not is_rank0():
        # a follower: rank 0 serves HTTP and sends every search to us
        follow(pair, index_loader, make_searchers)
        return
    lockstep = Lockstep() if mesh is not None else None
    service = SearchService(
        pair["main"], micro_batch_ms=args.micro_batch_ms,
        small_searcher=pair["small"], query_encoder=query_encoder,
        max_pending=args.max_pending,
        index_loader=index_loader if args.allow_reload else None,
        reload_token=args.reload_token, lockstep=lockstep)
    # this frame lives for the whole serve loop: drop its searcher
    # references so a free_first reload can free the planes
    threaded = args.micro_batch_ms > 0
    del pair
    try:
        serve_service(service, host=args.host, port=args.port,
                      threaded=threaded)
    finally:
        service.close()
        if lockstep is not None:
            lockstep.stop()


def cmd_info(args):
    """Environment and device diagnostics, one JSON object on stdout: what
    torch sees, whether the CUDA kernels are built, and whether the C++ host
    runtime or the pure-Python fallbacks are active."""
    import platform

    import torch

    import dhr_tpu_torch
    from dhr_tpu_torch import native
    from dhr_tpu_torch.ops import _build

    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    kernels = {name: _build._library_path(name).exists()
               for name in _build.KERNELS}
    out = {
        "dhr_tpu_torch": dhr_tpu_torch.__version__,
        "python": platform.python_version(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "capabilities": [list(torch.cuda.get_device_capability(i))
                         for i in range(n)],
        "kernel_build_dir": str(_build.build_dir()),
        "kernels_built": kernels,
        "native_runtime": native.available(),
        "native_so": native.so_path(),
    }
    print(json.dumps(out, indent=1))


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


# ------------------------------------------------------------ evaluation --


def cmd_rerank_eval(args):
    """Candidate-list rerank evaluation (reference driver/eval.py).

    Input JSONL rows: {"qry_text_id", "qry_text": [ids], "psg_text_id",
    "psg_text": [ids], "rel"}, the EvalDataset schema (reference
    data.py:251-283)."""
    from dhr_tpu_torch.data.examples import read_jsonl
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.eval.rerank import evaluate_rerank, make_pair_scorer

    device = resolve_device(args.device)
    model_cfg = _model_cfg_from_args(args)
    scorer = make_pair_scorer(_load_init_params(args, model_cfg), model_cfg,
                              remove_dims=args.remove_dims,
                              device=device)

    def rows():
        for r in read_jsonl(args.input):
            yield (str(r["qry_text_id"]), r["qry_text"],
                   str(r["psg_text_id"]), r["psg_text"], int(r["rel"]))

    t0 = time.perf_counter()
    out = evaluate_rerank(
        scorer, rows(), q_max_len=args.q_max_len, p_max_len=args.p_max_len,
        batch_size=args.batch_size, max_queries=args.max_queries,
        cls_id=args.cls_token_id, sep_id=args.sep_token_id,
        reference_compat=args.reference_ndcg,
    )
    wall = time.perf_counter() - t0
    print(json.dumps(out, indent=1))
    print("DHR_TIMING " + json.dumps({
        "verb": "rerank-eval", "device": str(device),
        "rerank_wall_s": wall}), file=sys.stderr)


def _load_token_reps(path: str):
    """``(reps, ids)`` from ``encode --model colbert`` (either package):
    the npz's ``token`` array and ``<path>.ids.json``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        reps = z["token"]
    with open(path + ".ids.json") as f:
        ids = json.load(f)
    return reps, ids


def cmd_colbert_score(args):
    """Offline MaxSim scoring of saved ColBERT token reps.

    Reads ``encode --model colbert`` outputs and a ``qid<TAB>pid[...]``
    file of candidate pairs; writes ``qid<TAB>pid<TAB>score`` rows (teacher
    scores for KD binning) or, with ``--trec``, a rerank run.  With
    ``--full-ranking`` it is an exact MaxSim retriever instead (every query
    against the whole passage plane, on the device) writing a TREC run; the
    reference's ColBERT scores candidate pairs only
    (ColBERT/modeling.py:340-442)."""
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.retrieval.colbert import full_ranking, score_pairs
    from dhr_tpu_torch.retrieval.trec import write_run

    device = resolve_device(args.device)
    q_reps, qids = _load_token_reps(args.query_reps)
    p_reps, pids = _load_token_reps(args.passage_reps)
    t0 = time.perf_counter()
    if args.full_ranking:
        # conflicting pair-scoring flags fail or warn instead of being
        # ignored: full ranking always writes a TREC run and reads neither
        # --pairs nor --batch-size
        if args.pairs:
            raise SystemExit(
                "--pairs conflicts with --full-ranking (full ranking "
                "scores every query against the whole passage plane)")
        if args.trec:
            logger.warning(
                "--trec is implied by --full-ranking (always a TREC run)")
        if args.batch_size is not None:
            logger.warning(
                "--batch-size only applies to pair scoring; use "
                "--query-batch / --passage-chunk with --full-ranking")
        scores, rows = full_ranking(
            q_reps, p_reps, topk=args.topk, q_batch=args.query_batch,
            p_chunk=args.passage_chunk,
            max_plane_bytes=int(args.plane_budget_gb * (1 << 30)),
            device=device)
        wall = time.perf_counter() - t0
        results = {str(q): [str(pids[int(r)]) for r in rr]
                   for q, rr in zip(qids, rows)}
        score_map = {str(q): [float(s) for s in ss]
                     for q, ss in zip(qids, scores)}
        write_run(args.output, results, score_map, run_name=args.run_name)
        logger.info("full-ranked %d queries over %d passages -> %s",
                    len(qids), len(pids), args.output)
        print("DHR_TIMING " + json.dumps({
            "verb": "colbert-score", "mode": "full-ranking",
            "queries": len(qids), "passages": len(pids),
            "device": str(device), "rank_wall_s": wall,
            "qps": len(qids) / max(wall, 1e-9)}), file=sys.stderr)
        return
    if not args.pairs:
        raise SystemExit("colbert-score needs --pairs or --full-ranking")
    pairs = []
    with open(args.pairs) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append((parts[0], parts[1]))
    scores = score_pairs(q_reps, qids, p_reps, pids, pairs,
                         batch_size=args.batch_size or 256, device=device)
    wall = time.perf_counter() - t0
    if args.trec:
        from collections import defaultdict

        by_q = defaultdict(list)
        for (qid, pid), s in zip(pairs, scores):
            by_q[qid].append((pid, float(s)))
        results, score_map = {}, {}
        for qid, rows in by_q.items():
            rows.sort(key=lambda x: -x[1])
            results[qid] = [p for p, _ in rows]
            score_map[qid] = [s for _, s in rows]
        write_run(args.output, results, score_map, run_name=args.run_name)
    else:
        with open(args.output, "w") as f:
            for (qid, pid), s in zip(pairs, scores):
                f.write(f"{qid}\t{pid}\t{s}\n")
    logger.info("scored %d pairs -> %s", len(pairs), args.output)
    print("DHR_TIMING " + json.dumps({
        "verb": "colbert-score", "mode": "pairs", "pairs": len(pairs),
        "device": str(device), "score_wall_s": wall,
        "pairs_per_s": len(pairs) / max(wall, 1e-9)}), file=sys.stderr)


def cmd_beir_preprocess(args):
    """A BEIR dataset directory -> the pipeline's interchange formats (the
    reference's tevatron/datasets/beir/preprocess.py role): tokenized corpus
    and query JSONL and a qrels TSV, for encode / search / eval."""
    import os

    from dhr_tpu_torch.data.examples import write_jsonl
    from dhr_tpu_torch.eval.beir import download_beir_dataset, load_beir_dir

    dataset_dir = args.dataset_dir
    if not dataset_dir:
        if not args.dataset:
            raise SystemExit("pass --dataset-dir DIR or --dataset NAME")
        dataset_dir = download_beir_dataset(args.dataset, args.download_dir)
    tok = _load_tokenizer(args.tokenizer)
    corpus, queries, qrels = load_beir_dir(dataset_dir, args.split)
    os.makedirs(args.output_dir, exist_ok=True)

    def tokenize(text, max_len):
        ids = tok.encode(text, add_special_tokens=False,
                         max_length=max_len, truncation=True)
        return ids or [0]

    write_jsonl(f"{args.output_dir}/corpus.jsonl",
                ({"text_id": d, "text": tokenize(t, args.p_max_len)}
                 for d, t in corpus.items()))
    write_jsonl(f"{args.output_dir}/queries.jsonl",
                ({"text_id": q, "text": tokenize(t, args.q_max_len)}
                 for q, t in queries.items()))
    with open(f"{args.output_dir}/qrels.tsv", "w") as f:
        for qid, docs in qrels.items():
            for docid, rel in docs.items():
                f.write(f"{qid}\t0\t{docid}\t{rel}\n")
    logger.info("wrote corpus/queries/qrels to %s", args.output_dir)


def cmd_beir(args):
    """BEIR zero-shot evaluation: one local directory, or named datasets
    (``all``: the 13-dataset suite the reference's README averages over)
    from directories or zips under ``--download-dir``."""
    from dhr_tpu_torch.device import resolve_device
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.eval.beir import (
        BEIR_13,
        download_beir_dataset,
        evaluate_beir,
    )
    from dhr_tpu_torch.retrieval.searcher import SearchConfig

    if not args.dataset_dir and not args.datasets:
        raise SystemExit("pass --dataset-dir DIR or --datasets name[,name...]")
    model_cfg = _model_cfg_from_args(args)
    if args.pack:
        if args.length_bucketing:
            raise SystemExit("--pack and --length-bucketing are exclusive")
        if model_cfg.model_type not in ("dense", "dhr", "dlr", "agg") or (
                model_cfg.model_type == "agg" and model_cfg.skip_mlm):
            raise SystemExit(
                f"--pack is not supported for {model_cfg.model_type}"
                f"{' with --skip-mlm' if model_cfg.model_type == 'agg' else ''}"
                "; use --length-bucketing")
    tok_dir = args.tokenizer or args.model_name_or_path
    if not tok_dir:
        raise SystemExit("beir needs --tokenizer DIR (a local HF tokenizer) "
                         "or --model-name-or-path")
    device = resolve_device(args.device)
    enc = Encoder(_load_init_params(args, model_cfg), model_cfg,
                  EncodeConfig(batch_size=args.batch_size,
                               remove_dims=args.remove_dims),
                  device=device)
    tok = _load_tokenizer(tok_dir)
    search_cfg = SearchConfig(
        topk=args.topk, mode="ip" if args.ip else "gip", theta=args.theta,
        rerank=args.rerank, agip_topk=args.agip_topk,
        query_batch=args.query_batch)

    def run_one(dataset_dir):
        return evaluate_beir(
            enc, search_cfg, dataset_dir, tok, split=args.split,
            q_max_len=args.q_max_len, p_max_len=args.p_max_len,
            cls_id=args.cls_token_id, sep_id=args.sep_token_id,
            device=device, length_bucketing=args.length_bucketing,
            pack=args.pack, pack_segments=args.pack_segments)

    if args.dataset_dir:
        print(json.dumps(run_one(args.dataset_dir), indent=1))
        return
    names = (list(BEIR_13) if args.datasets == "all"
             else [d.strip() for d in args.datasets.split(",") if d.strip()])
    table = {}
    for name in names:
        try:
            table[name] = run_one(download_beir_dataset(name,
                                                        args.download_dir))
            logger.info("%s: %s", name, table[name])
        except RuntimeError as e:
            table[name] = {"error": str(e)}
            logger.error("%s failed: %s", name, e)
    done = [v for v in table.values() if "NDCG@10" in v]
    print(json.dumps({
        "datasets": table,
        "avg_NDCG@10": (sum(v["NDCG@10"] for v in done) / len(done)
                        if done else None),
        "avg_R_cap@100": (sum(v["R_cap@100"] for v in done) / len(done)
                          if done else None),
        "num_completed": len(done),
    }, indent=1))


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
                        "TermWeightTrans.pt), or with --untie-encoder an "
                        "untied export (query_model/, passage_model/); "
                        "default: random weights")
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
                        "base without a checkpoint always does; a "
                        "deepseek_v2 checkpoint on the card needs it)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cls-token-id", type=int, default=101)
    p.add_argument("--sep-token-id", type=int, default=102)
    p.add_argument("--tiny", action="store_true",
                   help="random tiny encoder (smoke tests / quickstart)")
    p.add_argument("--tiny-vocab", type=int, default=1024)
    p.add_argument("--q-max-len", type=int, default=32)
    p.add_argument("--p-max-len", type=int, default=128)


def _add_shard_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shard-over-devices", action="store_true",
                   help="row-shard the index over the ranks of a launcher "
                        "(torchrun --nproc-per-node N -m dhr_tpu_torch "
                        "...): each rank holds its rows, rank 0 writes")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="with --shard-over-devices: nccl (the default on "
                        "the card, one card per rank) or gloo (the CPU, or "
                        "several ranks sharing one card)")
    p.add_argument("--dist-init-method", default=None,
                   help="with --shard-over-devices: torch.distributed "
                        "init_method (default env://, torchrun's "
                        "MASTER_ADDR / MASTER_PORT), e.g. file:///path")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m dhr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prepare-corpus")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", required=True,
                   help="local HF tokenizer directory")
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--schema", default="msmarco-passage")
    _finish(p, cmd_prepare_corpus)

    p = sub.add_parser("prepare-train")
    p.add_argument("--queries", required=True)
    p.add_argument("--qrels", required=True)
    p.add_argument("--negatives", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", required=True,
                   help="local HF tokenizer directory")
    p.add_argument("--q-max-len", type=int, default=32)
    p.add_argument("--n-negatives", type=int, default=200)
    _finish(p, cmd_prepare_train)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.add_argument("--train-path", required=True)
    p.add_argument("--corpus-path", default=None)
    p.add_argument("--query-cluster-path", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--train-n-passages", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=5e-6)
    p.add_argument("--warmup-steps", type=int, default=2500)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--num-epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many global steps (HF "
                        "TrainingArguments.max_steps); default epoch-bounded")
    p.add_argument("--save-steps", type=int, default=20000)
    p.add_argument("--log-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--kd", action="store_true")
    p.add_argument("--tct", action="store_true",
                   help="distill from an in-graph ColBERT teacher")
    p.add_argument("--teacher-path", default=None,
                   help="HF checkpoint dir for the ColBERT teacher")
    p.add_argument("--pack-passages", action="store_true",
                   help="token-pack the passage tower (several passages per "
                        "p_max_len row, block-diagonal attention): cuts the "
                        "pad work of sub-p_max_len passages "
                        "(dense/dhr/dlr/agg-MLM/colbert; not with "
                        "--grad-cache/--tct)")
    p.add_argument("--train-pack-segments", type=int, default=4,
                   help="max passages packed into one training row")
    p.add_argument("--pack-rows", type=int, default=None,
                   help="packed passage rows per step (default: auto-sized "
                        "from the first batch's plan +12.5%% headroom)")
    p.add_argument("--grad-cache", action="store_true")
    p.add_argument("--gc-q-chunks", type=int, default=4,
                   help="number of query chunks per grad-cache step (a "
                        "chunk COUNT: size = batch / chunks)")
    p.add_argument("--gc-p-chunks", type=int, default=8,
                   help="number of passage chunks per grad-cache step")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--metrics-path", default=None,
                   help="append per-log-interval train metrics JSONL here")
    p.add_argument("--rng-impl", default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="the reference's dropout PRNG on the TPU; accepted "
                        "for config compatibility, no effect here (dropout "
                        "masks come from torch generators seeded per step)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="under torchrun (data-parallel over the ranks): "
                        "nccl (default on the card) or gloo")
    p.add_argument("--dist-init-method", default=None,
                   help="under a launcher: torch.distributed init_method "
                        "(default env://)")
    _finish(p, cmd_train)

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
    p.add_argument("--pack", action="store_true",
                   help="token-level packing: several documents share one "
                        "p_max_len row under a block-diagonal attention mask "
                        "(dense/dhr/dlr/agg-MLM/colbert corpus encode)")
    p.add_argument("--pack-segments", type=int, default=8,
                   help="max documents packed into one row")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    _finish(p, cmd_encode)

    p = sub.add_parser("densify")
    p.add_argument("--input", required=True,
                   help='JSONL of {"id": docid, "vector": {term_id: weight}}')
    p.add_argument("--output", required=True)
    p.add_argument("--weight-model", default="bm25",
                   choices=["bm25", "deepimpact", "unicoil", "splade"])
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--vocab-size", type=int, required=True)
    p.add_argument("--batch-size", type=int, default=256)
    _finish(p, cmd_densify)

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
    _add_shard_args(p)
    for flag, what in _UNPORTED_SEARCH.items():
        p.add_argument(flag, action=_Unported, what=what)
    _finish(p, cmd_search)

    p = sub.add_parser("serve")
    _add_model_args(p)
    p.add_argument("--index-path", required=True)
    p.add_argument("--query-encoder", action="store_true",
                   help="load the model and serve POST /search_text (raw "
                        "query strings -> rankings); needs --tokenizer (a "
                        "local HF tokenizer directory, read with the "
                        "transformers package) or --model-name-or-path")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--theta", type=float, default=0.3)
    p.add_argument("--brute-force", action="store_true")
    p.add_argument("--IP", dest="ip", action="store_true")
    p.add_argument("--PQIP", dest="pqip", action="store_true",
                   help="PQ-code (ADC) candidates; needs 'index --pq-m'")
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--agip-topk", type=int, default=10000)
    p.add_argument("--value-dtype", default=None,
                   choices=["bf16", "f16", "f32"],
                   help="device value plane dtype for float indexes "
                        "(default bf16; int8 indexes stay int8)")
    p.add_argument("--lamda", type=float, default=1.0)
    p.add_argument("--max-important-dims", type=int, default=128)
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--exact-candidates", action="store_true")
    p.add_argument("--no-candidate-bf16", action="store_true")
    p.add_argument("--candidate-slices", default="auto",
                   help="stratified candidate selection (see 'search')")
    p.add_argument("--fused-candidates", default="off",
                   choices=["off", "on", "auto"],
                   help="fused candidate block reduction (see 'search')")
    p.add_argument("--candidate-block", type=int, default=8)
    p.add_argument("--escalate-pool", type=int, default=0,
                   help="two-tier escalation (see 'search')")
    p.add_argument("--escalate-margin", type=float, default=0.0)
    p.add_argument("--layout", default="auto",
                   choices=["auto", "both", "row", "dim"],
                   help="device plane layout (see 'search --layout')")
    p.add_argument("--row-chunk", type=int, default=0,
                   help="row-chunked ip stage 1 (see 'search --row-chunk')")
    p.add_argument("--micro-batch-ms", type=float, default=0.0,
                   help="> 0: threaded server + one worker that pools "
                        "concurrent requests into one search batch, "
                        "waiting at most this window for stragglers")
    p.add_argument("--max-pending", type=int, default=0,
                   help="> 0 (with --micro-batch-ms): bound the ingress "
                        "queue; excess requests get HTTP 503 + Retry-After")
    p.add_argument("--low-latency-batch", type=int, default=0,
                   help="> 0 (with --micro-batch-ms): a second searcher at "
                        "this batch over the same device index; pools that "
                        "fit it run there")
    p.add_argument("--reload-token", default=None,
                   help="require this value in the X-Reload-Token header "
                        "on /admin/reload; ALWAYS set it when binding a "
                        "non-loopback --host")
    p.add_argument("--allow-reload", action="store_true",
                   help='enable POST /admin/reload {"index_path": ..., '
                        '"free_first": false}: load a new index and swap it '
                        "in without a restart")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "the plain PyTorch path")
    _add_shard_args(p)
    for flag, what in _UNPORTED_SEARCH.items():
        p.add_argument(flag, action=_Unported, what=what)
    _finish(p, cmd_serve)

    p = sub.add_parser("info")
    _finish(p, cmd_info)

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

    p = sub.add_parser("rerank-eval")
    _add_model_args(p)
    p.add_argument("--input", required=True,
                   help="EvalDataset JSONL: qry_text_id, qry_text, "
                        "psg_text_id, psg_text, rel")
    p.add_argument("--max-queries", type=int, default=None)
    p.add_argument("--reference-ndcg", action="store_true",
                   help="reference-exact NDCG (binary grading, max(0.3, "
                        "norm) floor; tevatron/utils/metrics.py:36-53)")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    _finish(p, cmd_rerank_eval)

    p = sub.add_parser("colbert-score")
    p.add_argument("--query-reps", required=True,
                   help="npz from 'encode --model colbert --encode-is-qry'")
    p.add_argument("--passage-reps", required=True,
                   help="npz from 'encode --model colbert'")
    p.add_argument("--pairs", default=None,
                   help="TSV of qid<TAB>pid candidate pairs (omit with "
                        "--full-ranking)")
    p.add_argument("--full-ranking", action="store_true",
                   help="exact MaxSim retrieval of every query against the "
                        "whole passage plane (streamed top-k; writes a TREC "
                        "run)")
    p.add_argument("--topk", type=int, default=1000,
                   help="results per query with --full-ranking")
    p.add_argument("--query-batch", type=int, default=16,
                   help="queries per device pass with --full-ranking")
    p.add_argument("--passage-chunk", type=int, default=512,
                   help="passages per streamed slab with --full-ranking")
    p.add_argument("--plane-budget-gb", type=float, default=4.0,
                   help="with --full-ranking: the largest token-rep plane "
                        "kept on the device; a larger one streams in "
                        "passage slabs, merged exactly on the host")
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=None,
                   help="pairs per device pass for pair scoring (default "
                        "256; not used with --full-ranking)")
    p.add_argument("--trec", action="store_true",
                   help="write a TREC run instead of a scores TSV")
    p.add_argument("--run-name", default="dhr_tpu")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    _finish(p, cmd_colbert_score)

    p = sub.add_parser("beir-preprocess")
    p.add_argument("--dataset-dir", default=None,
                   help="unzipped BEIR dataset directory")
    p.add_argument("--dataset", default=None,
                   help="BEIR dataset name under --download-dir (a directory "
                        "or <name>.zip there; nothing is downloaded)")
    p.add_argument("--download-dir", default="./beir_download")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--tokenizer", required=True,
                   help="local HF tokenizer directory")
    p.add_argument("--split", default="test")
    p.add_argument("--q-max-len", type=int, default=512)
    p.add_argument("--p-max-len", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="accepted like the other eval verbs' (one config "
                        "file serves them all); tokenization runs on the "
                        "host")
    _finish(p, cmd_beir_preprocess)

    p = sub.add_parser("beir")
    _add_model_args(p)
    p.add_argument("--dataset-dir", default=None,
                   help="unzipped BEIR dataset directory")
    p.add_argument("--datasets", default=None,
                   help="comma-separated BEIR dataset names under "
                        "--download-dir (directories or <name>.zip), or "
                        "'all' for the 13-dataset suite")
    p.add_argument("--download-dir", default="./beir_download")
    p.add_argument("--tokenizer", default=None,
                   help="local HF tokenizer directory (default: "
                        "--model-name-or-path)")
    p.add_argument("--split", default="test")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--theta", type=float, default=0.0)
    p.add_argument("--IP", dest="ip", action="store_true")
    p.add_argument("--rerank", action="store_true")
    p.add_argument("--agip-topk", type=int, default=10000)
    p.add_argument("--query-batch", type=int, default=64)
    p.add_argument("--length-bucketing", action="store_true",
                   help="bucketed variable-length encode batches (fewer pad "
                        "positions; BEIR results are keyed by id)")
    p.add_argument("--pack", action="store_true",
                   help="token-level packing of the corpus encode "
                        "(dense/dhr/dlr/agg-MLM)")
    p.add_argument("--pack-segments", type=int, default=8,
                   help="max documents packed into one row")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (cuda), 'cpu' runs "
                        "on the CPU")
    _finish(p, cmd_beir)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    parser = build_parser()
    args = _apply_config_file(parser.parse_args(argv), parser)
    try:
        args.fn(args)
    finally:
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_initialized():  # a sharded verb
            # free what still holds the groups (a DeviceMesh in a
            # reference cycle) so their gloo threads stop here: left
            # running into the interpreter's exit, they could abort it
            # ("terminate called without an active exception")
            gc.collect()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
