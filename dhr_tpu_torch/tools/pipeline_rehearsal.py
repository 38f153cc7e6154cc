"""Full-pipeline rehearsal of the port: train -> encode -> index -> search
-> eval as one scripted run through ``python -m dhr_tpu_torch``.

Port of ``tools/pipeline_rehearsal.py``; the same world, stages, gates and
report schema (``tools/render_pipeline_run.py`` renders it):

1. a synthetic *topical wordpiece world*: vocab 30522 with omission 570
   (densify folds as MS MARCO models do), Zipf background tokens, topic
   term pools, passages of MARCO-like lengths (clipped lognormal, mean
   ~66), and queries drawn from a source passage (70% topic terms / 30%
   passage-specific) whose qrel is that passage -- byte-equal to the JAX
   tool's files for the same seed;
2. the UNTRAINED init checkpoint end to end (encode -> index int8 ->
   search theta+rerank AND exact GIP -> eval);
3. ``train --pack-passages`` with per-step metrics JSONL;
4. the same stages with the trained export;
5. a JSON report with each verb's wall-clock and the quality table.  Exit
   2 when trained MRR@10 does not beat untrained, or when staged
   Recall@1000 stays below ``STAGED_FLOOR`` x exact after the escalation
   ladder; exit 1 when a verb fails.

The verbs run on the GPU; ``--quick`` (toy scale) and ``--device cpu`` pass
``--device cpu`` to every verb that takes it.  On the GPU the init
checkpoint has DistilBERT-base width (6 x 768, 12 heads, FF 3072) and the
model computes in bf16; ``--quick`` keeps the JAX tool's 64 x 2 model in
f32.  (The JAX tool's full-scale model is 256 x 4, trained at lr 3e-4;
here the default lr is 1e-4.)

Usage:
  python -m dhr_tpu_torch.tools.pipeline_rehearsal --out report.json
  python -m dhr_tpu_torch.tools.pipeline_rehearsal --quick   # CPU, toy
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VOCAB = 30522
FIRST_TOKEN = 999  # below: specials + unused wordpiece slots
REMOVE = 570
CLS_ID, SEP_ID = 101, 102
VERB_TIMEOUT_S = 3600  # overridable via --verb-timeout
# Quality contract for the staged (theta+rerank) operating point: staged
# Recall@1000 must hold >= this fraction of exact GIP's, else the trained
# stage escalates (pool x4 / cap x2 / theta /2 per rung) and ultimately
# the run FAILS (exit 2): staged search exists to keep exact quality at
# speed, so a silent collapse is a fault, not a data point.
STAGED_FLOOR = 0.9
MAX_STAGED_RUNGS = 3
# verbs that take --device (eval runs on the host)
DEVICE_VERBS = ("train", "encode", "index", "search", "colbert-score")
# (hidden, layers, heads, FF) of the init checkpoint
QUICK_MODEL = (64, 2, 2, 128)
FULL_MODEL = (768, 6, 12, 3072)  # DistilBERT-base width


def _ratio(num, den):
    """staged/exact metric ratio.  A MISSING metric fails loudly: a silent
    1.0 would disable the exit-2 quality gate on a key rename.  A zero
    denominator passes trivially (nothing to preserve)."""
    if num is None or den is None:
        raise KeyError(
            "Recall@1000 missing from eval output — the staged-quality "
            "gate cannot run (metric key changed?)")
    if not den:
        return 1.0
    return round(float(num) / float(den), 4)


def log(*a):
    print("[rehearsal]", *a, file=sys.stderr, flush=True)


# --------------------------------------------------------------- world gen


def default_topics(n_corpus: int, quick: bool) -> int:
    """Topics scale with the corpus so difficulty does not: the task is
    "rank the source among ~200 same-topic cousins" (make_queries)."""
    return 32 if quick else max(64, n_corpus // 200)


def zipf_background(rng, size, skew=3.0):
    """Zipf-ish background token draw over [FIRST_TOKEN, VOCAB)."""
    u = rng.random(size)
    ranks = (u ** skew * (VOCAB - FIRST_TOKEN)).astype(np.int64)
    return FIRST_TOKEN + ranks


def make_world(rng, n_topics, pool_size, n_corpus, mean_len=66,
               topical_frac=0.55):
    """Returns (passages: list[list[int]], topics: (N,) int, pools)."""
    pools = zipf_background(rng, (n_topics, pool_size))
    z = rng.integers(0, n_topics, n_corpus)
    lens = np.clip(
        rng.lognormal(np.log(mean_len), 0.45, n_corpus), 16, 120
    ).astype(np.int64)
    passages = []
    for i in range(n_corpus):
        L = lens[i]
        topical = rng.random(L) < topical_frac
        toks = zipf_background(rng, L)
        pool = pools[z[i]]
        toks[topical] = pool[rng.integers(0, pool_size, int(topical.sum()))]
        passages.append(toks.tolist())
    return passages, z, pools


def make_queries(rng, passages, z, pools, source_pids, q_min=4, q_max=8,
                 topic_bias=0.7):
    """One query per source passage: tokens FROM the passage, biased to
    its topic-pool tokens (shared vocabulary) but including
    passage-specific background tokens (the signal that separates the
    source from same-topic cousins)."""
    queries = []
    for pid in source_pids:
        toks = np.asarray(passages[pid])
        in_pool = np.isin(toks, pools[z[pid]])
        L = int(rng.integers(q_min, q_max + 1))
        out = []
        for _ in range(L):
            use_topic = rng.random() < topic_bias and in_pool.any()
            cand = toks[in_pool] if use_topic else toks
            out.append(int(cand[rng.integers(0, len(cand))]))
        queries.append(out)
    return queries


def write_world(work, seed, n_corpus, n_train, n_dev, n_topics, pool_size):
    """The world's files under ``work``: ``(corpus, train groups, dev
    queries, dev qrels)`` paths.  Train groups: positive = the source
    passage; negatives = 8 same-topic cousins + 24 random (the hard
    negatives force passage-specific signal)."""
    from dhr_tpu_torch.data.examples import write_jsonl

    rng = np.random.default_rng(seed)
    passages, z, pools = make_world(rng, n_topics, pool_size, n_corpus)
    corpus_path = os.path.join(work, "corpus.jsonl")
    write_jsonl(corpus_path, (
        {"text_id": f"d{i}", "text": p} for i, p in enumerate(passages)))

    all_pids = rng.permutation(n_corpus)
    train_pids = all_pids[:n_train]
    dev_pids = all_pids[n_train: n_train + n_dev]
    train_queries = make_queries(rng, passages, z, pools, train_pids)
    dev_queries = make_queries(rng, passages, z, pools, dev_pids)

    groups = []
    for qt, pid in zip(train_queries, train_pids):
        topic_mates = np.flatnonzero(z == z[pid])
        hard = rng.choice(
            topic_mates[topic_mates != pid],
            size=min(8, max(1, len(topic_mates) - 1)), replace=False)
        rand = rng.integers(0, n_corpus, 24)
        negs = [str(int(p)) for p in (*hard, *rand) if int(p) != int(pid)]
        groups.append({"query": qt, "positive_pids": [str(int(pid))],
                       "negative_pids": negs})
    train_path = os.path.join(work, "train.jsonl")
    write_jsonl(train_path, groups)

    dev_path = os.path.join(work, "dev_queries.jsonl")
    write_jsonl(dev_path, (
        {"text_id": f"q{i}", "text": t} for i, t in enumerate(dev_queries)))
    qrels_path = os.path.join(work, "dev.qrels")
    with open(qrels_path, "w") as f:
        for i, pid in enumerate(dev_pids):
            f.write(f"q{i} 0 d{int(pid)} 1\n")
    return corpus_path, train_path, dev_path, qrels_path


# -------------------------------------------------------- init checkpoint


def write_tokenizer_files(ckpt_dir: str) -> None:
    """BERT-layout vocab.txt so a wordpiece tokenizer resolves [CLS] /
    [SEP] etc. at the standard ids."""
    tokens = ["[PAD]"]
    tokens += [f"[unused{i}]" for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [f"t{i:05d}" for i in range(VOCAB - len(tokens))]
    with open(os.path.join(ckpt_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(ckpt_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "DistilBertTokenizer",
                   "do_lower_case": True, "model_max_length": 512}, f)


def build_checkpoint(ckpt_dir: str, seed: int = 0, hidden: int = 128,
                     layers: int = 2, heads: int = 4, ff: int = 256,
                     proj_dim: int = 128, dlr_out_dim: int = 768,
                     model_type: str = "dhr", agg_dim: int = 640):
    """A seeded random ``BiEncoder`` exported in the HF layout (dropout 0
    in its config, as the JAX tool's); returns ``(cfg, model)``."""
    import torch

    from dhr_tpu_torch.models import (
        BiEncoder, EncoderConfig, RetrieverConfig, load_flax_params,
        random_flax_params)
    from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint

    cfg = RetrieverConfig(
        model_type=model_type,
        encoder=EncoderConfig(
            vocab_size=VOCAB, hidden_size=hidden, num_layers=layers,
            num_heads=heads, intermediate_size=ff,
            max_position_embeddings=512, type_vocab_size=0,
            dtype=torch.float32, hidden_dropout=0.0, attention_dropout=0.0),
        add_pooler=True, projection_dim=proj_dim, dlr_out_dim=dlr_out_dim,
        agg_dim=agg_dim, combine_cls=True)
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(seed)))
    export_hf_checkpoint(ckpt_dir, model, cfg, arch="distilbert")
    write_tokenizer_files(ckpt_dir)
    return cfg, model


# ------------------------------------------------------------ verb running


def run_verb(name, argv, env, timings, args, timeout=None):
    """``python -m dhr_tpu_torch <argv>`` (``--device cpu`` appended where
    the run is on the CPU); its stdout.  Raises when the verb fails."""
    timeout = timeout or VERB_TIMEOUT_S
    if args.device == "cpu" and argv[0] in DEVICE_VERBS:
        argv = [*argv, "--device", "cpu"]
    log("verb:", name, " ".join(argv[:8]), "...")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dhr_tpu_torch", *argv], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=timeout,
    )
    dt = time.time() - t0
    entry = {"verb": name, "wall_s": round(dt, 1)}
    # verbs print machine-readable "DHR_TIMING {json}" stderr lines (device,
    # wall split, q/s, and for search the kernels' launch counts)
    for line in (proc.stderr or "").splitlines():
        if line.startswith("DHR_TIMING "):
            try:
                entry.setdefault("device", []).append(
                    json.loads(line[len("DHR_TIMING "):]))
            except json.JSONDecodeError:
                pass
    timings.append(entry)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{name} failed (rc={proc.returncode}):\n"
            + proc.stderr[-4000:]
        )
    log(f"verb {name} done in {dt:.1f}s")
    return proc.stdout


def family_flags(family: str, ckpt: str) -> list:
    """Model flags per retriever family (DeLADE/DHR staged GIP,
    Aggretriever exact IP, dense exact IP, ColBERT MaxSim)."""
    common = ["--model-name-or-path", ckpt, "--add-pooler",
              "--projection-dim", "128"]
    if family == "dhr":
        return ["--model", "dhr", *common, "--dlr-out-dim", "768",
                "--remove-dims", str(REMOVE)]
    if family == "dense":
        return ["--model", "dense", "--pooling", "cls", *common]
    if family == "agg":
        return ["--model", "agg", *common, "--agg-dim", "640"]
    if family == "colbert":
        return ["--model", "colbert", *common]
    raise ValueError(f"unknown family {family}")


def _precision_flags(args) -> list:
    """bf16 compute on the GPU; f32 on the CPU."""
    return [] if args.device == "cpu" else ["--bf16"]


def eval_stage(tag, ckpt, work, corpus_path, queries_path, qrels_path, env,
               timings, args, calibrate=False):
    """encode corpus+queries -> index -> search -> eval per family:
    dhr = int8 index, staged (theta+rerank) AND exact GIP; dense/agg =
    exact IP; colbert = exact full-ranking MaxSim over the token-rep plane
    (no index verb: the reps are the index).  Returns the quality dict
    (always carries an "exact" entry).

    With ``calibrate=True`` (the trained dhr stage) the staged operating
    point escalates until staged Recall@1000 holds >= STAGED_FLOOR x
    exact: each rung quadruples the candidate pool, doubles the scan cap
    and halves theta (as theta->0, cap->all dims, pool->N, staged IS
    exact, so the ladder converges).  Every rung lands in the report."""
    family = args.family
    enc_common = [
        *family_flags(family, ckpt), *_precision_flags(args),
        "--q-max-len", "16", "--p-max-len", "128",
        "--batch-size", str(args.encode_batch),
    ]
    corpus_npz = os.path.join(work, f"{tag}_corpus.npz")
    query_npz = os.path.join(work, f"{tag}_queries.npz")
    run_verb(f"{tag}.encode-corpus", [
        "encode", *enc_common, "--input", corpus_path,
        "--output", corpus_npz, "--pack",
    ], env, timings, args)
    run_verb(f"{tag}.encode-queries", [
        "encode", *enc_common, "--input", queries_path,
        "--output", query_npz, "--encode-is-qry",
    ], env, timings, args)
    if family == "colbert":
        run_path = os.path.join(work, f"{tag}_exact.trec")
        run_verb(f"{tag}.search-exact", [
            "colbert-score", "--full-ranking",
            "--query-reps", query_npz, "--passage-reps", corpus_npz,
            "--output", run_path, "--topk", "1000",
        ], env, timings, args)
        out = run_verb(f"{tag}.eval-exact", [
            "eval", "--qrels", qrels_path, "--run", run_path,
        ], env, timings, args)
        return {"exact": json.loads(out)}
    index_path = os.path.join(work, f"{tag}_index.npz")
    index_extra = (["--quantize", "--lex-dim", "768"]
                   if family == "dhr" else [])
    run_verb(f"{tag}.index", [
        "index", "--inputs", corpus_npz, "--output", index_path,
        *index_extra,
    ], env, timings, args)

    def search_and_eval(mode, extra, label=None):
        label = label or mode
        run_path = os.path.join(work, f"{tag}_{label}.trec")
        run_verb(f"{tag}.search-{label}", [
            "search", "--index-path", index_path, "--query-path", query_npz,
            "--output", run_path, "--topk", "1000",
            "--query-batch", str(args.query_batch), *extra,
        ], env, timings, args)
        out = run_verb(f"{tag}.eval-{label}", [
            "eval", "--qrels", qrels_path, "--run", run_path,
        ], env, timings, args)
        return json.loads(out)

    quality = {}
    if family != "dhr":
        quality["exact"] = search_and_eval("exact", ["--IP"])
        return quality

    with np.load(query_npz) as zq:
        qvals = np.asarray(zq["values"][:, :768], np.float32)
    if args.theta == "auto":
        # theta is a per-model tunable: pick the value that puts the
        # median query at ~40 scanned dims, the operating point the bench
        # distribution targets (retrieval/synth.py: ~38 dims above theta)
        kth = np.sort(qvals, axis=1)[:, -40]
        theta = max(float(np.median(kth)), 1e-3)
    else:
        theta = float(args.theta)

    quality["exact"] = search_and_eval("exact", ["--brute-force"])
    n_corpus = args.n_corpus
    pool, cap = min(args.agip_topk, n_corpus), 48
    trace = []
    for rung in range(MAX_STAGED_RUNGS + 1):
        above = (qvals > theta).sum(axis=1)
        label = "staged" if rung == 0 else f"staged-r{rung}"
        q = search_and_eval("staged", [
            "--theta", str(theta), "--rerank",
            "--agip-topk", str(pool),
            "--max-important-dims", str(min(cap, 768)),
        ], label=label)
        point = {
            "rung": rung, "theta": round(theta, 6), "agip_topk": pool,
            "max_important_dims": min(cap, 768),
            "query_dims_above_theta": {
                "mean": round(float(above.mean()), 1),
                "max": int(above.max()),
            },
            "Recall@1000": q.get("Recall@1000"),
            "ratio_vs_exact_recall1000": _ratio(
                q.get("Recall@1000"), quality["exact"].get("Recall@1000")),
        }
        trace.append(point)
        quality["staged"] = q
        quality["staged_operating_point"] = point
        ok = point["ratio_vs_exact_recall1000"] >= STAGED_FLOOR
        if ok or not calibrate:
            break
        if pool >= n_corpus and cap >= 768:
            break  # staged == exact work; nothing left to escalate
        log(f"staged Recall@1000 {q.get('Recall@1000')} < "
            f"{STAGED_FLOOR}x exact "
            f"{quality['exact'].get('Recall@1000')} -> escalating rung "
            f"{rung + 1} (pool x4, cap x2, theta /2)")
        pool = min(pool * 4, n_corpus)
        cap = min(cap * 2, 768)
        theta = theta / 2.0
    quality["staged_calibration"] = trace
    quality["theta"] = trace[-1]["theta"]
    quality["query_dims_above_theta"] = trace[-1]["query_dims_above_theta"]
    return quality


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CPU toy scale (CI/debug)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs every verb on the CPU; default the GPU")
    ap.add_argument("--n-corpus", type=int, default=None)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-dev", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--theta", default="auto",
                    help="staged-search threshold; a float, or 'auto' to "
                    "calibrate per run so the median query scans ~40 dims")
    ap.add_argument("--agip-topk", type=int, default=None,
                    help="staged candidate-pool size; default scales with "
                    "the corpus (max(10000, n_corpus/50))")
    ap.add_argument("--query-batch", type=int, default=None)
    ap.add_argument("--encode-batch", type=int, default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--verb-timeout", type=int, default=3600,
                    help="per-CLI-verb wall-clock cap in seconds")
    ap.add_argument("--n-topics", type=int, default=None,
                    help="topic count; default scales with the corpus "
                    "(n_corpus // 200): ~200 same-topic cousins per source "
                    "passage at every scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=("dhr", "dense", "agg", "colbert"),
                    default="dhr",
                    help="retriever family: dhr = staged GIP + exact GIP; "
                    "dense/agg = exact IP; colbert = exact full-ranking "
                    "MaxSim over token reps")
    args = ap.parse_args(argv)
    q = args.quick
    if q:
        args.device = "cpu"
    args.n_corpus = args.n_corpus or (2048 if q else 102_400)
    args.n_train = args.n_train or (512 if q else 4096)
    args.n_dev = args.n_dev or (128 if q else 512)
    args.max_steps = args.max_steps or (80 if q else 400)
    # 1e-4 at DistilBERT-base width: the JAX tool's 3e-4 (for its 256 x 4
    # model) collapsed the loss at this width on the card
    args.learning_rate = args.learning_rate or (1e-3 if q else 1e-4)
    args.query_batch = args.query_batch or (32 if q else 128)
    args.encode_batch = args.encode_batch or (32 if q else 64)
    args.agip_topk = args.agip_topk or max(10_000, args.n_corpus // 50)
    return args


def main(argv=None):
    global VERB_TIMEOUT_S
    args = parse_args(argv)
    VERB_TIMEOUT_S = args.verb_timeout
    q = args.quick
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            log("FAIL: no CUDA device; pass --device cpu (or --quick) to "
                "run the verbs on the CPU")
            sys.exit(1)
    n_topics = args.n_topics or default_topics(args.n_corpus, q)
    pool_size = 16 if q else 48
    hidden, layers, heads, ff = QUICK_MODEL if q else FULL_MODEL

    work = args.workdir or tempfile.mkdtemp(prefix="dhr_pipeline_")
    os.makedirs(work, exist_ok=True)
    log("workdir:", work, "| quick:", q, "| corpus:", args.n_corpus,
        "| device:", args.device or "cuda")

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    # ---- world ----------------------------------------------------------
    t0 = time.time()
    corpus_path, train_path, dev_path, qrels_path = write_world(
        work, args.seed, args.n_corpus, args.n_train, args.n_dev, n_topics,
        pool_size)
    world_s = time.time() - t0
    log(f"world written in {world_s:.1f}s")

    # ---- init checkpoint (random weights, HF layout) --------------------
    init_ckpt = os.path.join(work, "ckpt_init")
    os.makedirs(init_ckpt, exist_ok=True)
    build_checkpoint(init_ckpt, hidden=hidden, layers=layers, heads=heads,
                     ff=ff, proj_dim=128, dlr_out_dim=768)

    width = ("" if q else ", DistilBERT-base width; the JAX tool's "
             "full-scale model is hidden 256 x 4")
    precision = "f32 on the CPU" if args.device == "cpu" else "bf16 on cuda"
    timings = [{"verb": "world-gen", "wall_s": round(world_s, 1)}]
    report = {
        "config": {
            "quick": q, "family": args.family, "n_corpus": args.n_corpus,
            "n_train": args.n_train, "n_dev": args.n_dev,
            "n_topics": n_topics,
            "model": (f"hidden {hidden} x {layers} layers, {heads} heads, "
                      f"FF {ff} (random init{width}; {precision})"),
            "max_steps": args.max_steps, "lr": args.learning_rate,
            "theta": args.theta, "agip_topk": args.agip_topk,
            "workdir": work,
        },
    }

    # ---- baseline: untrained end-to-end ---------------------------------
    report["untrained"] = eval_stage(
        "untrained", init_ckpt, work, corpus_path, dev_path, qrels_path,
        env, timings, args)
    log("untrained quality:", json.dumps(report["untrained"]))

    # ---- train -----------------------------------------------------------
    train_dir = os.path.join(work, "run")
    metrics_path = os.path.join(work, "train_metrics.jsonl")
    run_verb("train", [
        "train", *family_flags(args.family, init_ckpt),
        *_precision_flags(args),
        "--q-max-len", "16", "--p-max-len", "128",
        "--train-path", train_path, "--corpus-path", corpus_path,
        "--output-dir", train_dir,
        "--train-n-passages", "8", "--batch-size", "24",
        "--num-epochs", "1000",  # step-bounded below
        "--max-steps", str(args.max_steps),
        "--learning-rate", str(args.learning_rate),
        "--warmup-steps", str(max(args.max_steps // 10, 1)),
        "--save-steps", "1000000", "--log-steps", "20",
        "--pack-passages", "--metrics-path", metrics_path,
    ], env, timings, args)
    with open(metrics_path) as f:
        metrics = [json.loads(line) for line in f]
    report["train_loss_first"] = metrics[0]["loss"]
    report["train_loss_last"] = metrics[-1]["loss"]
    log("train loss:", metrics[0]["loss"], "->", metrics[-1]["loss"])

    # ---- trained end-to-end ----------------------------------------------
    trained_ckpt = os.path.join(train_dir, "export")
    report["trained"] = eval_stage(
        "trained", trained_ckpt, work, corpus_path, dev_path, qrels_path,
        env, timings, args, calibrate=True)
    log("trained quality:", json.dumps(report["trained"]))

    report["timings"] = timings
    report["total_wall_s"] = round(sum(t["wall_s"] for t in timings), 1)
    mrr_untrained = report["untrained"]["exact"]["MRR@10"]
    mrr_trained = report["trained"]["exact"]["MRR@10"]
    report["mrr_improves"] = bool(mrr_trained > mrr_untrained)
    staged_ok = True
    if args.family == "dhr":
        point = report["trained"]["staged_operating_point"]
        report["staged_holds_exact_quality"] = staged_ok = bool(
            point["ratio_vs_exact_recall1000"] >= STAGED_FLOOR)
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if not report["mrr_improves"]:
        # exit 2 = QUALITY failure (deterministic given the seed); rc 1
        # stays the code of a verb crash or timeout (raised above)
        log("FAIL: trained MRR@10 did not beat untrained "
            f"({mrr_trained} <= {mrr_untrained})")
        sys.exit(2)
    if not staged_ok:
        point = report["trained"]["staged_operating_point"]
        log("FAIL: staged Recall@1000 below "
            f"{STAGED_FLOOR}x exact even after "
            f"{len(report['trained']['staged_calibration']) - 1} "
            f"escalation rungs (final point: {json.dumps(point)})")
        sys.exit(2)
    log(f"OK: MRR@10 {mrr_untrained} -> {mrr_trained}")


if __name__ == "__main__":
    main()
