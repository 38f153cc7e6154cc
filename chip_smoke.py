#!/usr/bin/env python3
"""The port's parity smoke: hold dhr_tpu_torch against its plain versions,
the CPU, brute force and its gates on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Run from the root of a checkout.  It builds the CUDA kernels from
``dhr_tpu_torch/csrc`` (nvcc, sm_90a, into ``build/kernels/``), then runs
each path through the entry points a user calls (the CLI verbs,
``Encoder``, ``Searcher``, the service), with random weights (no checkpoint
is in the repository), and checks what each returns:

- ``encode_path``: the DHR encoder at DistilBERT-base width, card against
  CPU in f32; ``encode`` -> ``index --quantize`` -> ``search`` through the
  CLI (K4 once a batch, K1 and K2 in the search); the ``Encoder``'s planes.
- ``train_path``: one f32 step card against CPU, the packed and grad-cache
  steps against the plain one, the documented run (24 x 8, bf16) for 40
  steps through the CLI and again cut at 20 and resumed (losses agree, the
  loss falls), the export searched on K1 and K2, ``encode --pack`` against
  plain, and two bf16 steps of each kind with finite losses.
- ``rehearsal_path``: the port's pipeline rehearsal as a process (its MRR
  and Recall gates, K1 and K2 launched, the trained exact run against the
  CPU's brute force), and ``rep_stats`` on the card.
- ``densify_path``: BM25 -> DLR planes on the C++ host runtime, then
  ``densify`` -> ``index --quantize`` -> ``search`` on int16 folds, against
  the brute force and the CPU's plain path.
- ``eval_path``: ColBERT ``encode`` and ``colbert-score`` (card against
  CPU, host slabs against the resident plane, ``--pairs`` against the run),
  ``rerank-eval``, and ``evaluate_beir`` at theta 0 and 0.3 against the
  brute force, no self-hit left.
- ``family_path``: dense, Aggretriever and DLR card against CPU, their
  train steps (margin-KD, TCT, plain) card against CPU, and the CLI chain
  train -> encode -> index -> search -> eval for three of them.
- ``bert_path``: BERT-base towers with token types, tied and untied, card
  against CPU; untied TASB DHR and packed ColBERT through the CLI chain.
- K1-K8 against their plain versions (K1-K3 on a 204,803-row slice, K4 at
  the encode cell's batch, K5 and K6 at the dsv2 cell's), Kimi Linear's
  pieces at the Kimi cell's largest bucket (K6 without positions at 32
  heads, the KDA layer card against its CPU twin, K7 against an f64
  recurrence beside the plain scan, and both timed),
  NVIDIA-Nemotron-3-Nano-30B-A3B's at its cell's largest batch (K4 over
  131,072 terms, K5 at hidden 2,688, the SSD scan card against its CPU
  twin, K8 against the CPU's plain scan and timed beside the plain scan
  on the card, SDPA's GQA against f64, a published-width relu^2 MoE's
  launches),
  the other search modes against the CPU's plain path, then the main and
  fused paths at 8,841,823 rows (launch counts, staged-vs-exact
  agreement) and ip / pq on that index.
- ``serve_path``: the ``serve`` verb as a process (reloads, 503 shedding,
  token refusal, SIGINT), a free-first reload's device memory, the
  service at 8,841,823 rows under closed-loop clients at concurrency 1 and
  64 and over the fused searcher, and ``/search_text``; served results
  equal ``search_run``.
- ``parallel_path``: two ranks share the card over gloo (``torchrun``):
  the sharded search, DP, FSDP and TP steps against one rank (clipped,
  saved and restored bit-equal), ``Encoder(mesh=)``, and the sharded
  ``search`` and ``serve`` verbs.

Speed is the benchmark's (``BENCHMARK.json``, ``benchmarks/``).  The
smoke times only each hand-written kernel alone, beside its plain version
and its bound (the ``kernel_shapes``, ``k4_vs_plain``, ``k5_vs_plain``,
``k6_vs_plain``, ``kimi_vs_plain``, ``nemotron_vs_plain`` and
``kernels`` lines), and its own phases (``seconds``, ``walls``).

Each phase prints one JSON line; the card's name and power limit (as
nvidia-smi gives them) and the ``{"kernels": [...]}`` line, which counts
every path's launches, come before the last line, ``{"ok": true,
"device": {...}}``.  Any failure raises and exits non-zero before it.
Without CUDA, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

MSMARCO_PASSAGES = 8_841_823
LEX_DIM = 768
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# the staged-vs-exact agreement at top-10 / 100 / 1000 that the sharded
# search must reach: the reference package's at the bench point
# (BENCH_r05.json)
SHARDED_AGREEMENT = {"10": 1.0, "100": 0.9994, "1000": 0.9969}
K1_SOURCE = "dhr_tpu_torch/csrc/partial_gip.cu"
K2_SOURCE = "dhr_tpu_torch/csrc/rerank_gip.cu"
K3_SOURCE = "dhr_tpu_torch/csrc/gip_candidates.cu"
K4_SOURCE = "dhr_tpu_torch/csrc/lexical_pool.cu"
K5_SOURCE = "dhr_tpu_torch/csrc/moe_combine.cu"
K6_SOURCE = "dhr_tpu_torch/csrc/mla_attention.cu"
K7_SOURCE = "dhr_tpu_torch/csrc/kda_scan.cu"
K8_SOURCE = "dhr_tpu_torch/csrc/ssd_scan.cu"
# K6 at DeepSeek-V2-Lite's MLA: heads, (d_nope, d_rope, d_v), kv rank, and
# the dsv2 cell's passage length spec (benchmarks/traffic/
# moe-encode-corpus.json: log-normal, mean 75, sigma 0.45, in [8, 126],
# plus BOS and EOS), a call of 2,048 passages in batches of 256
DSV2_MLA = (16, (128, 64, 128), 512)
DSV2_LENGTHS = (75, 0.45, 8, 126)
# Kimi Linear at the Kimi cell's largest bucket (benchmarks/traffic/
# moe-encode-docs.json: batches of 8 documents of up to 2,048 tokens):
# hidden, KDA heads and width, MLA heads
KIMI_BUCKET = (8, 2048)
KIMI_WIDTHS = (2304, 32, 128, 32)
# NVIDIA-Nemotron-3-Nano-30B-A3B's cell's largest batch (benchmarks/traffic/
# ssm-encode-docs.json: the top 8 of the log-normal's 32 quantiles, plus BOS
# and EOS; 16,218 real tokens in a bucket of 8 x 2,048)
NEMOTRON_BATCH = (1882,) + (2048,) * 7
SMALL_ROWS = 204_803
ENCODE_PASSAGES = 32_768
ENCODE_QUERIES = 1_024
ENCODER_PASSAGES = 16_384      # passages of the Encoder's planes check
ENCODE_REMOVE_DIMS = 570
TRAIN_QUERIES = 2_048
TRAIN_NEGATIVES = 32
TRAIN_STEPS = 40
# the documented DHR run, docs/pipeline.md:25-30
TRAIN_FLAGS = ["--train-n-passages", "8", "--batch-size", "24",
               "--learning-rate", "7e-6", "--p-max-len", "128",
               "--q-max-len", "32", "--bf16"]
# densify_path: synthetic whole-word passages of MS MARCO length over a
# vocabulary of 2^18 terms (folds well past 127: int16 planes)
DENSIFY_PASSAGES = 32_768
DENSIFY_VOCAB = 1 << 18
DENSIFY_QUERIES = 1_024
DENSIFY_SEARCH = ["--theta", "0.1", "--rerank", "--agip-topk", "10000"]
# serve_path: single-query requests per concurrency level (each response
# held against search_run), client processes at most (threads share a
# process past that), the 503 flood and the /search_text queries
SERVE_LEVELS = {1: 32, 64: 256}
SERVE_CLIENT_PROCS = 16
SERVE_FLOOD = 256
SERVE_FLOOD_QUERIES = 32
SERVE_TEXT_QUERIES = 128
# eval_path: rerank-eval's queries x candidates (the reference's
# EvalDataset holds ~1,000 candidates a query) and the SciFact-shaped BEIR
# directory (Thakur et al., 2021, Table 1), 10 of its query ids also
# document ids
EVAL_RERANK_QUERIES = 16
EVAL_RERANK_CANDIDATES = 1_000
BEIR_DOCS = 5_183
BEIR_QUERIES = 300
BEIR_SELF_HITS = 10
# rehearsal_path: the port's full-pipeline rehearsal (train -> encode ->
# index -> search -> eval through the CLI, family dhr) at DistilBERT-base
# width on the tool's world; lr 1e-4 (3e-4, the JAX tool's rate for its
# 256 x 4 model, collapsed the loss at this width on the card)
REHEARSAL_FLAGS = ["--n-corpus", "32768", "--n-train", "4096", "--n-dev",
                   "512", "--max-steps", "250", "--learning-rate", "1e-4"]
REHEARSAL_CHECKED = 4          # trained exact-run queries held on the CPU
REP_STATS_ROWS = 204_800       # rep_stats' generator corpus on the card
# bert_path: bert-base-uncased's width (EncoderConfig.bert_base: 12 x 768,
# 12 heads, FFN 3072, vocab 30522, 512 positions, 2 token types) with the
# DHR flags of docs/pipeline.md:25-30, on family_path's world; TASB
# clusters of its train groups (TASBSampler draws 24 a batch)
BERT_DHR_FLAGS = ["--model", "dhr", "--add-pooler", "--projection-dim",
                  "128", "--dlr-out-dim", "768", "--remove-dims", "570"]
BERT_COLBERT_FLAGS = ["--model", "colbert", "--add-pooler",
                      "--projection-dim", "128"]
BERT_CLUSTERS = 64             # of 16 train-group indices each
BERT_STEPS = 40                # each CLI train run (warmup 10)
BERT_STEP_BATCH = 4            # queries (x 4 passages) of the CPU-held steps
BERT_CHECKED = 4               # exact-run queries held on the CPU


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_close(name, got, want, rel_tol, torch):
    """Assert ``|got - want| <= rel_tol * max(|want|, 1)`` (same -inf
    positions); returns the max abs difference."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: non-finite entries differ")
    diff = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    scale = float(want[fin].abs().max()) if fin.any() else 0.0
    if not diff <= rel_tol * max(scale, 1.0):
        raise AssertionError(f"{name}: max |diff| {diff} > {rel_tol} * "
                             f"max(|want|={scale}, 1)")
    return diff


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from dhr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(list(_build.KERNELS))
    ptxas = {}
    for n, r in reports.items():
        regs = [int(w) for ln in r.splitlines() if "registers" in ln
                for a, w in zip(ln.split(), ln.split()[1:]) if a == "Used"]
        spills = [ln.strip() for ln in r.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        ptxas[n] = {"max_registers": max(regs, default=None),
                    "spilling_lines": spills}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.build_dir()), "ptxas": ptxas})


def _passage_tokens(rng, n, np):
    """MS MARCO-like token lists without specials: ids in [570, 30522),
    lengths clipped lognormal with a mean of ~66, in [8, 126]."""
    lens = np.clip(rng.lognormal(np.log(60.0), 0.45, n), 8, 126).astype(int)
    flat = rng.integers(ENCODE_REMOVE_DIMS, 30522, int(lens.sum()))
    return np.split(flat, np.cumsum(lens)[:-1]), lens


def _dhr_config(dtype):
    from dhr_tpu_torch.models import EncoderConfig, RetrieverConfig

    return RetrieverConfig(
        model_type="dhr", add_pooler=True, projection_dim=128,
        dlr_out_dim=LEX_DIM,
        encoder=dataclasses.replace(EncoderConfig.distilbert_base(),
                                    dtype=dtype))


def _encode_card_vs_cpu(tree, seed, torch, np):
    """f32 reps of 8 passages of 128 tokens on the card and on the CPU
    (same weights), and the card's bf16 reps against its f32 ones."""
    from dhr_tpu_torch.data.collate import pad_token_batch
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.models.transformer import compute_copy
    from dhr_tpu_torch.ops.densify import densify

    rng = np.random.default_rng(seed + 3)
    toks, _ = _passage_tokens(rng, 8, np)
    toks[0] = rng.integers(ENCODE_REMOVE_DIMS, 30522, 126)  # a full row
    b = pad_token_batch([t.tolist() for t in toks], 128, 0, 101, 102)
    ids, mask = (torch.from_numpy(b[k]) for k in ("input_ids",
                                                  "attention_mask"))
    reps = {}
    for name, dtype, dev in (("cpu_f32", torch.float32, "cpu"),
                             ("card_f32", torch.float32, "cuda"),
                             ("card_bf16", torch.bfloat16, "cuda")):
        model = load_flax_params(BiEncoder(_dhr_config(dtype)), tree)
        model = compute_copy(model, dtype, torch.device(dev)).eval()
        with torch.inference_mode():
            r = model.encoder_q(ids.to(dev), mask.to(dev))
        reps[name] = (r.lexical.float().cpu(), r.semantic.float().cpu())
        del model
    lex_cpu = reps["cpu_f32"][0]
    folded = lex_cpu[:, ENCODE_REMOVE_DIMS:].reshape(8, -1, LEX_DIM)
    top2 = folded.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs()
    _, f_cpu = densify(lex_cpu, LEX_DIM, ENCODE_REMOVE_DIMS)

    def compare(name):
        lex, sem = reps[name]
        want_lex, want_sem = (reps["cpu_f32"] if name == "card_f32"
                              else reps["card_f32"])
        _, f = densify(lex, LEX_DIM, ENCODE_REMOVE_DIMS)
        _, f_want = densify(want_lex, LEX_DIM, ENCODE_REMOVE_DIMS)
        return {
            "lexical_max_rel_diff": float((lex - want_lex).abs().max()
                                          / want_lex.abs().max()),
            "cls_max_rel_diff": float((sem - want_sem).abs().max()
                                      / want_sem.abs().max()),
            "fold_agreement": float((f == f_want).float().mean()),
            "unequal_folds": int((f != f_want).sum()),
        }, f

    card, f_card = compare("card_f32")
    card["unequal_folds_not_near_tie"] = int(
        ((f_card != f_cpu) & ~near_tie).sum())
    bf16, _ = compare("card_bf16")
    if card["unequal_folds_not_near_tie"]:
        raise AssertionError(f"card vs CPU f32: folds differ beyond near "
                             f"ties: {card}")
    if max(card["lexical_max_rel_diff"], card["cls_max_rel_diff"]) > 1e-3:
        raise AssertionError(f"card vs CPU f32 reps differ: {card}")
    # ties built on purpose: the first (lowest) fold wins on the card too
    x = torch.zeros(4, ENCODE_REMOVE_DIMS + 39 * LEX_DIM)
    x[:, ENCODE_REMOVE_DIMS:] = torch.randint(
        0, 3, (4, 39 * LEX_DIM), generator=torch.Generator().manual_seed(
            seed)).float()
    ties_equal = torch.equal(
        densify(x.cuda(), LEX_DIM, ENCODE_REMOVE_DIMS)[1].cpu(),
        densify(x, LEX_DIM, ENCODE_REMOVE_DIMS)[1])
    if not ties_equal:
        raise AssertionError("densify on the card breaks ties differently")
    return {"passages": 8, "padded_len": 128, "card_f32_vs_cpu_f32": card,
            "card_bf16_vs_card_f32": bf16,
            "near_tie_rel": 1e-5, "densify_ties_first_fold": ties_equal}


def _timing_line(stderr_text: str, verb: str) -> dict:
    for line in stderr_text.splitlines():
        if line.startswith("DHR_TIMING "):
            t = json.loads(line[len("DHR_TIMING "):])
            if t.get("verb", "search") == verb:
                return t
    raise AssertionError(f"no DHR_TIMING line of {verb}")


def _run_cli(argv, verb=None, stdout=False):
    """``python -m dhr_tpu_torch <argv>`` in this process; the DHR_TIMING
    line of ``verb`` when given, and with ``stdout`` the JSON the verb
    printed (kept off this script's standard output)."""
    import contextlib
    import io

    from dhr_tpu_torch.cli.main import main as cli

    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(
            out if stdout else sys.stdout):
        cli(argv)
    sys.stderr.write(err.getvalue())
    timing = _timing_line(err.getvalue(), verb) if verb else None
    return (timing, json.loads(out.getvalue())) if stdout else timing


def _read_run(path):
    out = {}
    with open(path) as f:
        for line in f:
            q, _, doc, _, score, _ = line.split()
            out.setdefault(q, []).append((doc, float(score)))
    return out


def _encode_corpus(root, seed, np):
    """encode_path's synthetic corpus (32,768 passages, ids "0"...) and
    1,024 queries (4-20 ids, "q0"...), written as tokenized JSONL under
    ``root``: ``(corpus path, queries path, passage token arrays, passage
    lengths, query token arrays)``."""
    from dhr_tpu_torch.data.examples import write_jsonl

    rng = np.random.default_rng(seed + 4)
    toks, lens = _passage_tokens(rng, ENCODE_PASSAGES, np)
    q_toks = [rng.integers(ENCODE_REMOVE_DIMS, 30522, n)
              for n in rng.integers(4, 21, ENCODE_QUERIES)]
    corpus, queries = f"{root}/corpus.jsonl", f"{root}/queries.jsonl"
    write_jsonl(corpus, ({"text_id": str(i), "text": t.tolist()}
                         for i, t in enumerate(toks)))
    write_jsonl(queries, ({"text_id": f"q{i}", "text": t.tolist()}
                          for i, t in enumerate(q_toks)))
    return corpus, queries, toks, lens, q_toks


def _encode_user_path(root, seed, torch, np):
    """encode (corpus, bf16, batch 32) -> encode --encode-is-qry -> index
    --quantize -> search at the bench point, through the CLI; K4 must
    launch once a batch of the two encodes, K1 and K2 in the search.  Then
    the exact brute force for the agreement."""
    corpus, queries, toks, lens, _ = _encode_corpus(root, seed, np)
    model = ["--model", "dhr", "--add-pooler", "--projection-dim", "128",
             "--dlr-out-dim", str(LEX_DIM), "--batch-size", "32"]
    search = ["search", "--index-path", f"{root}/index.npz", "--query-path",
              f"{root}/q.npz", "--topk", "1000", "--query-batch", "128"]
    reset_launches()
    _run_cli(["encode", *model, "--input", corpus, "--output",
              f"{root}/corpus.npz"], "encode")
    _run_cli(["encode", *model, "--input", queries, "--output",
              f"{root}/q.npz", "--encode-is-qry"], "encode")
    encode_launches = read_launches()
    batches = -(-ENCODE_PASSAGES // 32) + -(-ENCODE_QUERIES // 32)
    if encode_launches != {"partial_gip": 0, "rerank_gip": 0,
                           "gip_candidates": 0, "lexical_pool": batches,
                           "moe_combine": 0, "mla_attention": 0}:
        raise AssertionError(f"encode launches {encode_launches}: K4 "
                             f"{batches} times (once a batch), K1-K3, K5 "
                             "and K6 never")
    reset_launches()
    _run_cli(["index", "--inputs", f"{root}/corpus.npz", "--output",
              f"{root}/index.npz", "--quantize"])
    _run_cli([*search, "--theta", "0.3", "--max-important-dims", "48",
              "--agip-topk", "10000", "--rerank", "--output",
              f"{root}/run.trec"], "search")
    launches = read_launches()
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0
            and launches["lexical_pool"] == 0):
        raise AssertionError(f"encode path launches {launches}: K1 and K2 "
                             "must launch, K4 not")
    reset_launches()
    _run_cli([*search, "--brute-force", "--exact-candidates",
              "--no-candidate-bf16", "--output", f"{root}/exact.trec"],
             "search")
    exact_launches = read_launches()

    shapes = {}
    for name, want in (("corpus", ENCODE_PASSAGES), ("q", ENCODE_QUERIES)):
        with np.load(f"{root}/{name}.npz") as z:
            v, ind = z["values"], z["indices"]
            shapes[name] = {"values": [list(v.shape), str(v.dtype)],
                            "indices": [list(ind.shape), str(ind.dtype)]}
            if (v.shape != (want, LEX_DIM + 128) or v.dtype != np.float16
                    or ind.shape != (want, LEX_DIM) or ind.dtype != np.uint8):
                raise AssertionError(f"{name}.npz planes {shapes[name]}")
            if int(ind.max()) >= 39 or not np.isfinite(
                    v.astype(np.float32)).all():
                raise AssertionError(f"{name}.npz: folds >= 39 or non-finite "
                                     "values")
    with np.load(f"{root}/index.npz") as z:
        shapes["index"] = {k: [list(z[k].shape), str(z[k].dtype)]
                           for k in ("values", "indices", "value_scales")}
        if z["values"].dtype != np.int8 or z["values"].shape != (
                ENCODE_PASSAGES, LEX_DIM + 128):
            raise AssertionError(f"index planes {shapes['index']}")
    run, exact = _read_run(f"{root}/run.trec"), _read_run(f"{root}/exact.trec")
    if len(run) != ENCODE_QUERIES or any(
            len(r) != min(1000, ENCODE_PASSAGES) or not np.isfinite([s for _, s in r]).all()
            for r in run.values()):
        raise AssertionError("the run lacks queries, rows or finite scores")
    qids = sorted(run)
    agree = agreement([np.array([d for d, _ in run[q]]) for q in qids],
                      [np.array([d for d, _ in exact[q]]) for q in qids])
    return {
        "passages": ENCODE_PASSAGES, "queries": ENCODE_QUERIES,
        "passage_len_mean": float(lens.mean() + 2),
        "encode_launches": encode_launches, "launches": launches,
        "exact_launches": exact_launches, "planes": shapes,
        "staged_vs_brute_force_informative_only": agree,
    }, toks


def _encoder_planes(tree, toks, torch):
    """The ``Encoder``'s planes of the first passages at batch 256,
    length-bucketed, bf16: one row a passage, 768 + 128 values."""
    from dhr_tpu_torch.encode import (
        EncodeConfig, Encoder, bucketed_encode_batches)
    from dhr_tpu_torch.models import BiEncoder, load_flax_params

    cfg = _dhr_config(torch.bfloat16)
    enc = Encoder(load_flax_params(BiEncoder(cfg), tree), cfg,
                  EncodeConfig(batch_size=256))
    lists = [t.tolist() for t in toks]
    ids = [str(i) for i in range(len(lists))]
    batches, _ = bucketed_encode_batches(ids, lists, 256, 128, 101, 102)
    packed = enc.encode_corpus(batches)
    shape = list(packed.values.shape)
    if shape != [len(lists), LEX_DIM + 128]:
        raise AssertionError("Encoder planes of the wrong shape")
    del enc
    torch.cuda.empty_cache()
    return {"passages": len(lists), "batch": 256, "bucketed": True,
            "dtype": "bf16", "values": shape}


def phase_encode_path(args, torch):
    """The encode slice at DistilBERT-base width (6 x 768, vocab 30522, the
    DHR head: 768 lexical dims + a 128-dim CLS projection), random weights
    from ``--seed`` in the Flax layout loaded by ``load_flax_params``:
    card against CPU, the user path through the CLI (encode -> index ->
    search, K4, K1 and K2 launched), and the Encoder's planes.  Returns the
    user path's launches (its encodes' and its search's)."""
    import tempfile

    import numpy as np

    from dhr_tpu_torch.models import random_flax_params

    tree = random_flax_params(_dhr_config(torch.float32),
                              torch.Generator().manual_seed(args.seed))
    t0 = time.perf_counter()
    parity = _encode_card_vs_cpu(tree, args.seed, torch, np)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        user, toks = _encode_user_path(root, args.seed, torch, np)
    t2 = time.perf_counter()
    planes = _encoder_planes(tree, toks[:ENCODER_PASSAGES], torch)
    emit({"phase": "encode_path", "model": "distilbert-base DHR "
          "(6x768, vocab 30522, remove_dims 570, 768 + 128 dims)",
          "weights": f"random, seed {args.seed}", "card_vs_cpu": parity,
          "user_path": user, "encoder_planes": planes,
          "seconds": {"card_vs_cpu": t1 - t0, "user_path": t2 - t1,
                      "encoder_planes": time.perf_counter() - t2}})
    torch.cuda.empty_cache()
    return {k: user["encode_launches"][k] + user["launches"][k]
            for k in user["launches"]}


# --------------------------------------------------------------------------
# train_path: the train slice at DistilBERT-base width
# --------------------------------------------------------------------------


def _train_data(root, seed, np):
    """The corpus of ``encode_path``'s kind (32,768 passages) and 2,048
    train groups: each query's 6-30 ids are drawn from its positive
    passage (so the positive can be learned), plus 32 negative pids."""
    from dhr_tpu_torch.data.examples import write_jsonl

    rng = np.random.default_rng(seed + 5)
    toks, lens = _passage_tokens(rng, ENCODE_PASSAGES, np)
    write_jsonl(f"{root}/corpus.jsonl", ({"text_id": str(i),
                                          "text": t.tolist()}
                                         for i, t in enumerate(toks)))
    groups = []
    for _ in range(TRAIN_QUERIES):
        pos = int(rng.integers(ENCODE_PASSAGES))
        negs = rng.choice(ENCODE_PASSAGES - 1, TRAIN_NEGATIVES, replace=False)
        negs = negs + (negs >= pos)
        groups.append({
            "query": rng.choice(toks[pos], int(rng.integers(6, 31))).tolist(),
            "positive_pids": [str(pos)],
            "negative_pids": [str(int(n)) for n in negs]})
    write_jsonl(f"{root}/train.jsonl", groups)
    q_lens = rng.integers(4, 21, ENCODE_QUERIES)
    write_jsonl(f"{root}/queries.jsonl", ({"text_id": f"q{i}", "text": rng
                                           .integers(ENCODE_REMOVE_DIMS,
                                                     30522, n).tolist()}
                                          for i, n in enumerate(q_lens)))
    return toks, groups, lens


def _train_loader(groups, toks, batch_size, torch, **kw):
    """The loader ``train`` builds (the documented sampling: 8 passages a
    query, 32 / 128 tokens, specials 101 / 102)."""
    from dhr_tpu_torch.data import Corpus, SamplingConfig, TrainLoader

    corpus = Corpus([str(i) for i in range(len(toks))],
                    [t.tolist() for t in toks])
    return TrainLoader(groups, SamplingConfig(
        n_passages=8, q_max_len=32, p_max_len=128, seed=42, cls_id=101,
        sep_id=102), batch_size=batch_size, corpus=corpus, **kw)


def _grads(model):
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def _grad_rel_diff(got, want, worst=None):
    """``(L2, max)``: the largest over tensors of ``|got - want|_2 /
    |want|_2`` and of ``max |got - want| / max |want|``, the attention-key
    biases left out (their gradient is zero up to float noise).  A fold
    chosen differently at a near tie routes one element's gradient
    elsewhere: that moves the max measure more than the L2 one.  ``worst``
    (a dict) receives the three tensors of largest L2 difference."""
    rel = {}
    mx = 0.0
    for n, w in want.items():
        if "attention.key.bias" in n or not w.abs().max() > 0:
            continue
        d = got[n] - w
        rel[n] = float(d.norm() / w.norm())
        mx = max(mx, float(d.abs().max() / w.abs().max()))
    if worst is not None:
        worst.update(sorted(rel.items(), key=lambda kv: -kv[1])[:3])
    return max(rel.values()), mx


def _f32_train_config(torch):
    cfg = _dhr_config(torch.float32)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=0.0, attention_dropout=0.0))


def _train_card_vs_cpu(tree, loader, torch):
    """One plain step, f32, dropout 0, 2 queries x 8 passages, on the CPU
    and on the card: loss, gradients, and the updated parameters where the
    gradient is above 1e-2 of its tensor's scale, each within 1e-3 of the
    lr plus 4 f32 ulps of the parameter (the update's two roundings run in
    another order on the card).  Adam's first update is ``lr * g / (|g| +
    eps)``: where ``|g|`` nears ``eps`` or the rounding noise it moves with
    the last bits of ``g`` (counted, not gated)."""
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.models.flax_params import flax_to_state_dict
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.state import TrainState
    from dhr_tpu_torch.train.step import LossConfig, plain_loss, to_device

    cfg = _f32_train_config(torch)
    opt = OptimizerConfig(learning_rate=7e-6, warmup_steps=0,
                          total_steps=100, freeze_word_embeddings=True)
    batch = next(iter(loader.epoch(0)))
    out = {}
    for dev in ("cpu", "cuda"):
        model = load_flax_params(BiEncoder(cfg), tree).to(dev)
        state = TrainState.create(model, opt)
        model.train()
        loss, _ = plain_loss(model, cfg, LossConfig(), to_device(batch, dev))
        loss.backward()
        grads = _grads(model)
        state.apply_gradients()
        out[dev] = (loss.item(), grads, {n: p.detach().cpu() for n, p in
                                         model.named_parameters()})
        del model, state
    torch.cuda.empty_cache()
    init = flax_to_state_dict(tree)
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = out["cpu"], out["cuda"]
    worst, upd_err, flips, n_upd = 0.0, 0.0, 0, 0
    ulp = torch.finfo(torch.float32).eps
    for n, g in g_cpu.items():
        if "attention.key.bias" in n:
            continue
        firm = g.abs() > 1e-2 * g.abs().max()
        d = (p_card[n] - p_cpu[n]).abs()
        tol = 1e-3 * opt.learning_rate + 4 * ulp * init[n].abs()
        if firm.any():
            worst = max(worst, float((d / tol)[firm].max()))
            upd_err = max(upd_err, float(d[firm].max()))
        flips += int((d[~firm] > tol[~firm]).sum())
        n_upd += g.numel()
    l2, mx = _grad_rel_diff(g_card, g_cpu)
    res = {"queries": 2, "passages": 16, "loss_cpu": l_cpu,
           "loss_card": l_card, "loss_rel_diff": abs(l_card - l_cpu)
           / abs(l_cpu), "grad_rel_l2_diff": l2, "grad_max_rel_diff": mx,
           "update_max_abs_diff_over_lr": upd_err / opt.learning_rate,
           "update_diff_over_tolerance_max": worst,
           "update_elements_below_1e-2_scale_beyond_tolerance": flips,
           "updated_elements": n_upd}
    if not (res["loss_rel_diff"] < 1e-4 and l2 < 1e-3 and worst <= 1.0):
        raise AssertionError(f"train step, card vs CPU f32: {res}")
    return res


def _packed_and_grad_cache_vs_plain(tree, groups, toks, torch):
    """On the card, f32, dropout 0, batch 24: the packed step's and the
    grad-cache step's (4 query / 8 passage chunks, and 1 / 1) gradients
    against the plain step's, on the same examples.  Gated: the loss within
    1e-4 and every tensor's gradient within 1e-3 (L2, relative); for
    grad-cache at 4 / 8, whose chunks change the GEMM shapes and so the
    rounding that decides near-tie folds, within 1e-2 (its 1 / 1 twin, the
    same two passes at the plain shapes, holds 1e-3).  K4 must not launch:
    a train step's no-grad pass 1 keeps the eager head, as its pass 2."""
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.train.step import (
        LossConfig, grad_cache_backward, packed_loss, plain_loss, to_device)

    cfg = _f32_train_config(torch)
    loss_cfg = LossConfig()
    plain = to_device(next(iter(_train_loader(groups, toks, 24, torch)
                                .epoch(0))), "cuda")
    packed = to_device(next(iter(_train_loader(
        groups, toks, 24, torch, pack_passages=True).epoch(0))), "cuda")
    model = load_flax_params(BiEncoder(cfg), tree).cuda().train()
    res = {"batch": 24, "packed_rows": int(
        packed["packed_passage"]["input_ids"].shape[0])}
    runs = (("plain", lambda: plain_loss(model, cfg, loss_cfg, plain)[0],
             None),
            ("packed", lambda: packed_loss(model, cfg, loss_cfg, packed)[0],
             1e-3),
            ("grad_cache", (4, 8), 1e-2), ("grad_cache_1_1", (1, 1), 1e-3))
    grads, losses = {}, {}
    reset_launches()
    for name, fn, _ in runs:
        model.zero_grad(set_to_none=True)
        if isinstance(fn, tuple):
            loss = grad_cache_backward(model, cfg, loss_cfg, plain, 0, 0, *fn)
        else:
            loss = fn()
            loss.backward()
        losses[name] = loss.item()
        grads[name] = _grads(model)
    res["lexical_pool_launches"] = read_launches()["lexical_pool"]
    if res["lexical_pool_launches"]:
        raise AssertionError(f"train steps launched K4: {res}")
    for name, _, tol in runs[1:]:
        worst = {}
        l2, mx = _grad_rel_diff(grads[name], grads["plain"], worst)
        res[name] = {"loss_rel_diff": abs(losses[name] - losses["plain"])
                     / abs(losses["plain"]),
                     "grad_rel_l2_diff": l2, "grad_max_rel_diff": mx,
                     "worst_tensors_l2": worst, "tol_l2": tol}
    for name, _, tol in runs[1:]:
        if not (res[name]["loss_rel_diff"] < 1e-4
                and res[name]["grad_rel_l2_diff"] < tol):
            raise AssertionError(f"{name} step vs plain on the card: {res}")
    del model, grads, plain, packed
    torch.cuda.empty_cache()
    return res


def _metrics_losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f]


def _eval_loss(model, batches, torch):
    """Mean plain-step loss of ``batches`` in eval mode (no dropout)."""
    from dhr_tpu_torch.train.step import LossConfig, plain_loss, to_device

    model.eval()
    with torch.no_grad():
        return float(sum(plain_loss(model, model.cfg, LossConfig(),
                                    to_device(b, "cuda"))[0].item()
                         for b in batches) / len(batches))


def _train_and_resume(root, tree, groups, toks, torch, np):
    """``python -m dhr_tpu_torch train`` from the HF directory: 40 steps
    (warmup 10, saves at 20), then a run cut at step 20 and resumed to 40;
    the per-step losses of both runs must agree and be finite, and the
    loss must fall: the eval-mode loss of the run's first 4 batches (96
    queries) after the 40 steps below the one before (per-step train
    losses, each of another batch, are reported)."""
    common = ["train", "--model", "dhr", "--model-name-or-path",
              f"{root}/init", "--add-pooler", "--projection-dim", "128",
              "--dlr-out-dim", str(LEX_DIM), "--train-path",
              f"{root}/train.jsonl", "--corpus-path", f"{root}/corpus.jsonl",
              *TRAIN_FLAGS, "--warmup-steps", "10", "--save-steps",
              str(TRAIN_STEPS // 2), "--log-steps", "1"]
    _run_cli([*common, "--output-dir", f"{root}/a", "--max-steps",
              str(TRAIN_STEPS), "--metrics-path", f"{root}/a.jsonl"], "train")
    for steps in (TRAIN_STEPS // 2, TRAIN_STEPS):  # cut, then resumed
        _run_cli([*common, "--output-dir", f"{root}/b", "--max-steps",
                  str(steps), "--metrics-path", f"{root}/b.jsonl"], "train")
    a, b = _metrics_losses(f"{root}/a.jsonl"), _metrics_losses(
        f"{root}/b.jsonl")
    rel = np.abs(np.subtract(a, b)) / np.abs(a)
    first, last = float(np.mean(a[:10])), float(np.mean(a[-10:]))
    res = {"steps": len(a), "losses": a, "resumed_losses": b,
           "resume_max_rel_diff": float(rel.max()),
           "resume_bit_equal_steps": int((np.asarray(a) == np.asarray(b))
                                         .sum()),
           "loss_first10_mean": first, "loss_last10_mean": last,
           "checkpoints": sorted(os.listdir(f"{root}/b"))}
    if len(a) != TRAIN_STEPS or len(b) != TRAIN_STEPS:
        raise AssertionError(f"train runs logged {len(a)} / {len(b)} steps")
    if not np.isfinite(a).all() or not np.isfinite(b).all():
        raise AssertionError("a train loss is not finite")
    if rel.max() > 1e-3:
        raise AssertionError(f"resumed losses differ: {rel.max()}")
    from dhr_tpu_torch.models import BiEncoder, load_flax_params

    batches = [b for b, _ in zip(_train_loader(groups, toks, 24, torch)
                                 .epoch(0), range(4))]
    model = load_flax_params(BiEncoder(_dhr_config(torch.bfloat16)),
                             tree).cuda()
    res["eval_loss_before"] = _eval_loss(model, batches, torch)
    snap = torch.load(f"{root}/a/step_{TRAIN_STEPS:08d}/state.pt",
                      map_location="cuda", weights_only=True)
    model.load_state_dict(snap["model"])
    res["eval_loss_after"] = _eval_loss(model, batches, torch)
    del model, snap
    torch.cuda.empty_cache()
    if not res["eval_loss_after"] < res["eval_loss_before"]:
        raise AssertionError(f"the loss did not fall: {res}")
    return res


def _trained_on_the_kernels(root, torch, np):
    """The export of the 40-step run, through ``encode`` (bf16, batch 256,
    length-bucketed; the queries too), ``index --quantize`` and ``search``
    at the bench point: K1 and K2 must launch.  Then ``encode --pack`` of
    the same corpus against it."""
    model = ["--model", "dhr", "--model-name-or-path", f"{root}/a/export",
             "--bf16", "--add-pooler", "--projection-dim", "128",
             "--dlr-out-dim", str(LEX_DIM), "--batch-size", "256"]
    corpus = ["--input", f"{root}/corpus.jsonl"]
    _run_cli(["encode", *model, *corpus, "--length-bucketing", "--output",
              f"{root}/corpus.npz"], "encode")
    _run_cli(["encode", *model, "--input", f"{root}/queries.jsonl",
              "--output", f"{root}/q.npz", "--encode-is-qry"], "encode")
    _run_cli(["index", "--inputs", f"{root}/corpus.npz", "--output",
              f"{root}/index.npz", "--quantize"])
    reset_launches()
    _run_cli(["search", "--index-path", f"{root}/index.npz", "--query-path",
              f"{root}/q.npz", "--topk", "1000", "--query-batch", "128",
              "--theta", "0.3", "--max-important-dims", "48",
              "--agip-topk", "10000", "--rerank", "--output",
              f"{root}/run.trec"], "search")
    launches = read_launches()
    want = -(-ENCODE_QUERIES // 128)  # K1 once per staging chunk
    if not (launches["partial_gip"] >= want and launches["rerank_gip"]
            == want and launches["gip_candidates"] == 0):
        raise AssertionError(f"trained index launches {launches}: K1 at "
                             f"least and K2 exactly {want} times expected")
    run = _read_run(f"{root}/run.trec")
    if len(run) != ENCODE_QUERIES or any(
            len(r) != 1000 or not np.isfinite([s for _, s in r]).all()
            for r in run.values()):
        raise AssertionError("the trained run lacks queries, rows or finite "
                             "scores")
    _run_cli(["encode", *model, *corpus, "--pack", "--pack-segments", "8",
              "--batch-size", "64", "--output", f"{root}/packed.npz"],
             "encode")
    with np.load(f"{root}/corpus.npz") as a, \
            np.load(f"{root}/packed.npz") as b:
        va, vb = a["values"].astype(np.float32), b["values"].astype(
            np.float32)
        pack = {"values_max_rel_diff_bf16": float(np.abs(va - vb).max()
                                                  / np.abs(va).max()),
                "values_rel_l2_bf16": float(np.linalg.norm(va - vb)
                                            / np.linalg.norm(va)),
                "fold_agreement_bf16": float((a["indices"] == b["indices"])
                                             .mean())}
    if not (pack["values_rel_l2_bf16"] < 0.05
            and pack["fold_agreement_bf16"] > 0.9):
        raise AssertionError(f"encode --pack vs plain (bf16): {pack}")
    return {"launches": launches, "packed_vs_bucketed": pack}


def _packed_encode_f32(tree, toks, torch, np):
    """``Encoder.encode_corpus_packed`` against ``encode_corpus`` on the
    card, f32, 2,048 passages: planes' relative difference, fold
    agreement."""
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
    from dhr_tpu_torch.encode import (
        EncodeConfig, Encoder, packed_encode_batches)
    from dhr_tpu_torch.models import BiEncoder, load_flax_params

    cfg = _dhr_config(torch.float32)
    enc = Encoder(load_flax_params(BiEncoder(cfg), tree), cfg,
                  EncodeConfig(batch_size=64))
    lists = [t.tolist() for t in toks[:2048]]
    ids = [str(i) for i in range(len(lists))]
    plain = enc.encode_corpus(
        collate_encode(ids[s:s + 64], [wrap_specials(t, 128, 101, 102)
                                       for t in lists[s:s + 64]], 128)
        for s in range(0, len(ids), 64))
    batches, order = packed_encode_batches(ids, lists, 64, 128, 8, 101, 102)
    packed = enc.encode_corpus_packed(batches)
    inv = np.argsort(order)
    va, vb = plain.values.astype(np.float32), packed.values[inv].astype(
        np.float32)
    res = {"passages": len(ids),
           "values_max_rel_diff": float(np.abs(va - vb).max()
                                        / np.abs(va).max()),
           "fold_agreement": float((plain.indices == packed.indices[inv])
                                   .mean())}
    if list(packed.docids[inv]) != ids or res["values_max_rel_diff"] > 1e-3 \
            or res["fold_agreement"] < 0.999:
        raise AssertionError(f"packed encode vs plain, f32 card: {res}")
    del enc
    torch.cuda.empty_cache()
    return res


def _step_batches(groups, toks, n, torch, packed=False):
    """The first ``n`` batches of the documented loader; packed, at the
    row count that the most packed of them needs, so that every batch has
    one shape (none falls back to a row per passage)."""
    def first(**kw):
        loader = _train_loader(groups, toks, 24, torch, **kw)
        return [b for b, _ in zip(loader.epoch(0), range(n))]

    if not packed:
        return first()
    rows = max(int((b["packed_passage"]["segment_ids"] > 0).any(1).sum())
               for b in first(pack_passages=True, pack_rows=192))
    batches = first(pack_passages=True, pack_rows=rows)
    if {b["packed_passage"]["input_ids"].shape[0] for b in batches} != {rows}:
        raise AssertionError("packed step batches differ in shape")
    return batches


def _bf16_steps(tree, groups, toks, torch):
    """Two steps each of ``make_train_step`` (padded to 128),
    ``make_packed_train_step`` (one row count for both batches) and
    ``make_grad_cache_train_step`` (4 query / 8 passage chunks) in bf16 at
    batch 24, dropout 0.1, the documented lr: every loss finite."""
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.state import TrainState
    from dhr_tpu_torch.train.step import (
        LossConfig, make_grad_cache_train_step, make_packed_train_step,
        make_train_step)

    cfg = _dhr_config(torch.bfloat16)
    loss_cfg = LossConfig()
    model = load_flax_params(BiEncoder(cfg), tree).cuda()
    state = TrainState.create(model, OptimizerConfig(
        learning_rate=7e-6, warmup_steps=0, total_steps=1000,
        freeze_word_embeddings=True))
    out = {"batch": 24, "dtype": "bf16"}
    for name, step_fn, packed in (
            ("plain_padded128", make_train_step(model, cfg, loss_cfg), False),
            ("packed", make_packed_train_step(model, cfg, loss_cfg), True),
            ("grad_cache_4q_8p", make_grad_cache_train_step(
                model, cfg, loss_cfg, 4, 8), False)):
        batches = _step_batches(groups, toks, 2, torch, packed)
        out[name] = {"losses": [float(step_fn(state, b, 0))
                                for b in batches]}
        if packed:
            out[name]["packed_rows"] = int(
                batches[0]["packed_passage"]["input_ids"].shape[0])
        if not all(map(math.isfinite, out[name]["losses"])):
            raise AssertionError(f"{name}: the loss is not finite")
    del model, state
    torch.cuda.empty_cache()
    return out


def phase_train_path(args, torch):
    """The train slice at DistilBERT-base width (the DHR model of
    ``encode_path``; its seeded random tree written as an HF directory so
    that ``train --model-name-or-path`` goes through the import): the card
    against the CPU, packed and grad-cache against plain, the documented
    run (``docs/pipeline.md:25-30``) for 40 steps and its resume, the
    trained export encoded, indexed and searched on K1 and K2, packed
    encode, and the bf16 steps of each kind."""
    import tempfile

    import numpy as np

    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint

    cfg = _dhr_config(torch.float32)
    tree = random_flax_params(cfg, torch.Generator().manual_seed(args.seed))
    secs, out = {}, {}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        toks, groups, lens = _train_data(root, args.seed, np)
        export_hf_checkpoint(f"{root}/init", load_flax_params(
            BiEncoder(cfg), tree), cfg)
        secs["setup"] = time.perf_counter() - t
        steps = (
            ("card_vs_cpu", lambda: _train_card_vs_cpu(
                tree, _train_loader(groups, toks, 2, torch), torch)),
            ("packed_and_grad_cache_vs_plain",
             lambda: _packed_and_grad_cache_vs_plain(tree, groups, toks,
                                                     torch)),
            ("train_and_resume", lambda: _train_and_resume(
                root, tree, groups, toks, torch, np)),
            ("trained_on_kernels", lambda: _trained_on_the_kernels(
                root, torch, np)),
            ("packed_encode_f32", lambda: _packed_encode_f32(tree, toks,
                                                             torch, np)),
            ("bf16_steps", lambda: _bf16_steps(tree, groups, toks, torch)),
        )
        for name, fn in steps:
            t = time.perf_counter()
            out[name] = fn()
            secs[name] = time.perf_counter() - t
    emit({"phase": "train_path", "model": "distilbert-base DHR "
          "(6x768, vocab 30522, remove_dims 570, 768 + 128 dims)",
          "weights": f"random, seed {args.seed}, through an HF directory",
          "data": {"queries": TRAIN_QUERIES, "negatives": TRAIN_NEGATIVES,
                   "corpus": ENCODE_PASSAGES,
                   "passage_len_mean": float(lens.mean() + 2)},
          "flags": TRAIN_FLAGS, **out, "seconds": secs})
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# rehearsal_path: the full pipeline through the CLI, and rep_stats
# --------------------------------------------------------------------------


def _rehearsal_exact_vs_cpu(work, np, torch):
    """The trained exact run (``search --brute-force`` on the card, K1)
    against ``gip_scores_masked`` on the CPU over the same int8 index and
    query planes, for the first queries, by :func:`_vs_exact`'s rule
    (each document's score and, rank by rank, its exact score within 1e-5
    of the query's scale: the rule the BEIR check holds).  ``_ranking_check``'s stricter
    reading (runs of scores within 1e-5 relative hold the same ids) is
    reported beside it: int8 planes give many tied and near-tied scores,
    and a chain of near-ties splits into runs differently on each side."""
    from dhr_tpu_torch.ops.gip import gip_scores_masked, pad_indices_for_cls
    from dhr_tpu_torch.retrieval.index import PackedIndex

    pk = PackedIndex.load(f"{work}/trained_index.npz")
    with np.load(f"{work}/trained_queries.npz") as z:
        qv = z["values"][:REHEARSAL_CHECKED].astype(np.float32)
        qi = z["indices"][:REHEARSAL_CHECKED].astype(np.int32)
    with open(f"{work}/trained_queries.npz.qids.json") as f:
        qids = json.load(f)[:REHEARSAL_CHECKED]
    cls = pk.dim - pk.lex_dim
    with torch.inference_mode():
        exact = gip_scores_masked(
            torch.from_numpy(qv * pk.value_scales[None, :]),
            pad_indices_for_cls(torch.from_numpy(qi), cls),
            torch.from_numpy(pk.values).float(),
            pad_indices_for_cls(torch.from_numpy(pk.indices).int(),
                                cls)).numpy()
    run = _read_run(f"{work}/trained_exact.trec")
    out = _vs_exact(qids, {q: [d for d, _ in run[q]] for q in qids},
                    {q: [s for _, s in run[q]] for q in qids}, exact,
                    pk.docids, np)
    k = min(1000, pk.num_rows)
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    want = {q: [(str(pk.docids[r]), float(exact[b, r])) for r in order[b]]
            for b, q in enumerate(qids)}
    out["ranking_check_runs"] = _compare_runs(run, want, qids, 1e-5)
    return out


def _rep_stats_on_card(torch):
    """``rep_stats``' generator statistics and staged / reference-theta /
    exact agreement at 204,800 rows on the card (K1 and K2)."""
    from dhr_tpu_torch.retrieval.synth import SynthConfig
    from dhr_tpu_torch.tools.rep_stats import agreement, generator_stats

    cfg = SynthConfig()
    stats, corpus, queries = generator_stats(cfg, REP_STATS_ROWS, 64, 0.3,
                                             48)
    reset_launches()
    agree = agreement(cfg, corpus, queries, 0.3, 48, 1000, 10_000)
    launches = read_launches()
    del corpus, queries
    torch.cuda.empty_cache()
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"rep_stats launches {launches}: K1 and K2 "
                             "must launch")
    dims = stats["query_dims_above_theta"]["mean"]
    if not 30 <= dims <= 46:
        raise AssertionError(f"generator: {dims} query dims above theta "
                             "0.3, outside the calibrated 30-46")
    return {"rows": REP_STATS_ROWS, "queries": 64,
            "query_dims_above_theta": stats["query_dims_above_theta"],
            "fold_top_share_mean": stats["fold_top_share_mean"],
            "agreement": agree, "launches": launches}, launches


def phase_rehearsal_path(args, root, torch):
    """The port's pipeline rehearsal (``dhr_tpu_torch/tools/
    pipeline_rehearsal.py``, family dhr) as a process on the card at
    DistilBERT-base width: a topical wordpiece world, the untrained init
    checkpoint encoded, indexed (int8), searched staged and exact and
    evaluated, ``train --pack-passages`` (bf16), then the trained export
    the same way.  Its gates hold (trained MRR@10 above untrained, staged
    Recall@1000 at least 0.9 x exact), K1 and K2 launch in its search
    verbs (counted by each process, reported in its ``DHR_TIMING`` line),
    and the trained exact run equals the CPU's brute force on its first
    queries.  Then ``rep_stats`` on the card.  Returns the launches of
    both."""
    import numpy as np

    checkout = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "rehearsal")
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "dhr_tpu_torch.tools.pipeline_rehearsal",
         "--workdir", work, "--out", f"{work}/report.json", "--seed",
         str(args.seed), *REHEARSAL_FLAGS],
        cwd=checkout, capture_output=True, text=True, timeout=900)
    secs = {"tool": time.perf_counter() - t}
    if p.returncode:
        raise AssertionError(f"pipeline_rehearsal exited {p.returncode} "
                             f"(2: a quality gate):\n{p.stderr[-6000:]}")
    with open(f"{work}/report.json") as f:
        report = json.load(f)
    launches = {k: 0 for k in _counters()}
    for verb in report["timings"]:
        for line in verb.get("device", []):
            for k, v in line.get("launches", {}).items():
                launches[k] += v
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"rehearsal launches {launches}: K1 and K2 "
                             "must launch")
    if not (report["mrr_improves"] and report["staged_holds_exact_quality"]):
        raise AssertionError("rehearsal gates: "
                             f"{report['mrr_improves']}, "
                             f"{report['staged_holds_exact_quality']}")
    t = time.perf_counter()
    vs_cpu = _rehearsal_exact_vs_cpu(work, np, torch)
    secs["exact_vs_cpu"] = time.perf_counter() - t
    if vs_cpu["ranks_equal_up_to_ties"] != REHEARSAL_CHECKED \
            or vs_cpu["scores_match_exact"] != REHEARSAL_CHECKED:
        raise AssertionError(f"trained exact run vs the CPU: {vs_cpu}")
    rep, rep_launches = _rep_stats_on_card(torch)
    keep = ("MRR@10", "Recall@1000", "nDCG@10", "Recall@100")
    emit({"phase": "rehearsal_path", "config": report["config"],
          "flags": REHEARSAL_FLAGS,
          "quality": {stage: {mode: {k: report[stage][mode][k]
                                     for k in keep}
                              for mode in ("exact", "staged")}
                      for stage in ("untrained", "trained")},
          "staged_operating_point":
              report["trained"]["staged_operating_point"],
          "staged_ladder": report["trained"]["staged_calibration"],
          "train_loss_first_last": [report["train_loss_first"],
                                    report["train_loss_last"]],
          "mrr_improves": report["mrr_improves"],
          "staged_holds_exact_quality":
              report["staged_holds_exact_quality"],
          "launches": launches, "trained_exact_vs_cpu": vs_cpu,
          "rep_stats": rep, "seconds": secs})
    return {k: launches[k] + rep_launches[k] for k in launches}


def small_world(seed, torch):
    """A 204,803-row corpus slice, 16 prepared queries at full width and
    the 16 raw ones."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    n = SMALL_ROWS
    v, f, scales, _ = synth_index_planes(seed, n, device="cuda")
    index = DeviceIndex.from_arrays(v, f, np.arange(n).astype(str), LEX_DIM,
                                    scales, device="cuda")
    qv, qf, _ = synth_reps(seed, 16, role="query", stream=1, device="cuda")
    prep = Searcher(index, SearchConfig(theta=0.3, max_important_dims=48))
    return index, prep.prepare_queries(qv, qf), (qv, qf)


def phase_k1(index, queries, torch):
    """K1 vs plain: 8 queries, I=48 (theta=0.3) and I=896 (theta=0), rows
    204,800 and 204,803 (prime: a ragged last tile), dim-major planes built
    by ``dim_major`` (padded pitch) from the row-major plane in each dtype;
    plus a batch split forced by a small shared-memory budget.  Every case
    bit-equal (the kernel sums in the plain version's order)."""
    from dhr_tpu_torch.ops.partial_gip import (
        partial_gip, partial_gip_plain, select_important, staging_plan)
    from dhr_tpu_torch.retrieval.index import dim_major

    qv, qv1, qi = (x[:8] for x in queries)
    worst, cases, tiles, split_chunks = 0.0, 0, set(), 0
    for n in (204_800, 204_803):
        for vdt in (torch.int8, torch.bfloat16, torch.float32):
            vt = dim_major(index.values[:n].to(vdt))
            for idt in (torch.int8, torch.int16):
                it = dim_major(index.indices[:n].to(idt))
                for q, n_imp in ((qv1, 48), (qv, qv.shape[1])):
                    imp = select_important(q, qi, n_imp)
                    tiles.add(staging_plan(*imp, vt.shape[0],
                                           LEX_DIM, vt.element_size(),
                                           it.element_size()).chunks[0].tile)
                    for out in (torch.float32, torch.bfloat16):
                        name = f"partial_gip N={n} {vdt} {idt} I={n_imp} {out}"
                        got = partial_gip(*imp, vt, it, LEX_DIM, out)
                        want = partial_gip_plain(*imp, vt, it, LEX_DIM, out)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            raise AssertionError(f"{name}: not bit-equal")
                        worst = max(worst, check_close(name, got, want, 0.0,
                                                       torch))
                        cases += 1
            del vt, it
        vt = dim_major(index.values[:n])
        it = dim_major(index.indices[:n])
        imp = select_important(qv1, qi, 48)
        plan = staging_plan(*imp, vt.shape[0], LEX_DIM, 1, 1,
                            smem_bytes=16 * 2 * 64)
        split_chunks = len(plan.chunks)
        if split_chunks < 2:
            raise AssertionError("the small budget did not split the batch")
        got = partial_gip(*imp, vt, it, LEX_DIM, torch.float32, plan=plan)
        if not torch.equal(got, partial_gip_plain(*imp, vt, it, LEX_DIM)):
            raise AssertionError(f"partial_gip N={n} split batch: not "
                                 "bit-equal")
        cases += 1
    emit({"phase": "k1_vs_plain", "cases": cases, "max_abs_err": worst,
          "tiles": sorted(tiles), "split_chunks": split_chunks,
          "tol": "0 (bit-equal, f32 and bf16 out)"})
    return worst


def phase_k2(index, queries, seed, torch):
    """K2 vs plain: B=16, K=10,000 and 1,001, lex=768, int8 and int16
    indices, int8/bf16/f32 values; D=896 (rows of whole 16-byte words) and
    D=890 (not: the element path); row ids out of range on both sides."""
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain

    qv, _, qi = queries
    n = index.num_rows
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    worst, cases = 0.0, 0
    for k in (10_000, 1_001):
        rows = torch.randint(0, n, (qv.shape[0], k), generator=g,
                             device="cuda")
        rows[0, 0], rows[1, 1] = n, -1  # never read: scores -inf
        for D in (index.dim, 890):
            for vdt in (torch.int8, torch.bfloat16, torch.float32):
                vals = index.values[:, :D].to(vdt).contiguous()
                q = qv[:, :D].contiguous()
                for idt in (torch.int8, torch.int16):
                    ind = index.indices.to(idt)
                    got = rerank_gip(q, qi, rows, vals, ind, LEX_DIM)
                    want = rerank_gip_plain(q, qi, rows, vals, ind, LEX_DIM)
                    torch.cuda.synchronize()
                    if not bool(torch.isneginf(got[[0, 1], [0, 1]]).all()):
                        raise AssertionError("rerank_gip: an out-of-range "
                                             "row id did not score -inf")
                    worst = max(worst, check_close(
                        f"rerank_gip K={k} D={D} {vdt} {idt}", got, want,
                        1e-4, torch))
                    cases += 1
                del vals
    emit({"phase": "k2_vs_plain", "cases": cases, "max_abs_err": worst,
          "dims": [index.dim, 890], "tol": "1e-4 * max(|want|, 1)"})
    return worst


def phase_k3(index, queries, torch):
    """K3 vs plain: 8 queries, rows 204,800, 204,803 (ragged) and 204,700
    (the last group block partial: at G=3 whole lane tiles past N), padded
    dim-major planes (``dim_major``), value int8/bf16, index int8/int16,
    I=48 (theta 0.3) and I=896 (theta 0); G=8 packed, G=8 two planes (f32
    and bf16 out), G=3 two planes; plus, at 204,803 rows, a batch split
    into query chunks by a small shared-memory budget.  Rows equal, scores
    bit-equal, packed rows decode to the two-plane rows; the plan's launch
    limits are the built kernel's."""
    from dhr_tpu_torch.ops.gip_candidates import (
        MAX_GROUP, QUERY_ROWS, candidates_plan, decode_packed_candidates,
        gip_candidates, gip_candidates_plain, kernel_limits)
    from dhr_tpu_torch.ops.partial_gip import select_important
    from dhr_tpu_torch.retrieval.index import dim_major

    if kernel_limits() != (QUERY_ROWS, MAX_GROUP):
        raise AssertionError(f"K3's plan limits {(QUERY_ROWS, MAX_GROUP)} "
                             f"are not the kernel's {kernel_limits()}")
    qv, qv1, qi = (x[:8] for x in queries)
    variants = ((8, True, torch.float32), (8, False, torch.float32),
                (8, False, torch.bfloat16), (3, False, torch.float32))
    worst, cases, tiles, split_chunks = 0.0, 0, set(), 0

    def check(name, n, imp, vt, it, plan=None):
        nonlocal worst, cases
        two_plane_rows = None
        for G, packed, out in variants:
            case = f"{name} G={G} packed={packed} {out}"
            got = gip_candidates(*imp, vt, it, LEX_DIM, G, packed, out,
                                 plan=plan)
            want = gip_candidates_plain(*imp, vt, it, LEX_DIM, G, packed, out)
            torch.cuda.synchronize()
            if packed:
                got_v, want_v = got, want
                packed_plane = got
            else:
                (got_v, got_r), (want_v, want_r) = got, want
                if not torch.equal(got_r, want_r):
                    raise AssertionError(f"{case}: rows differ")
                if G == 8 and out == torch.float32:
                    two_plane_rows = got_r
            bits = (got_v.float().view(torch.int32),
                    want_v.float().view(torch.int32))
            if not torch.equal(*bits):
                raise AssertionError(f"{case}: scores differ")
            worst = max(worst, check_close(case, got_v, want_v, 0.0, torch))
            cases += 1
        pos = torch.arange(packed_plane.shape[1], device="cuda")
        _, rows = decode_packed_candidates(
            packed_plane, pos.expand_as(packed_plane), 8)
        valid = two_plane_rows < n
        if not (torch.equal(rows[valid], two_plane_rows[valid].long())
                and bool((rows[~valid] >= n).all())):
            raise AssertionError(f"{name}: decoded packed rows != two-plane "
                                 "rows")

    for n in (204_800, SMALL_ROWS, 204_700):
        for vdt in (torch.int8, torch.bfloat16):
            vt = dim_major(index.values[:n].to(vdt))
            for idt in (torch.int8, torch.int16):
                it = dim_major(index.indices[:n].to(idt))
                for q, n_imp in ((qv1, 48), (qv, qv.shape[1])):
                    imp = select_important(q, qi, n_imp)
                    tiles.add(candidates_plan(
                        *imp, vt.shape[0], LEX_DIM, vt.element_size(),
                        it.element_size()).chunks[0].tile)
                    check(f"gip_candidates N={n} {vdt} {idt} I={n_imp}", n,
                          imp, vt, it)
            del vt, it
    vt = dim_major(index.values[:SMALL_ROWS])
    it = dim_major(index.indices[:SMALL_ROWS])
    imp = select_important(qv1, qi, 48)
    plan = candidates_plan(*imp, vt.shape[0], LEX_DIM, 1, 1,
                           smem_bytes=4096)
    split_chunks = len(plan.chunks)
    if split_chunks < 2:
        raise AssertionError("the small budget did not split the batch")
    check(f"gip_candidates N={SMALL_ROWS} split batch", SMALL_ROWS, imp, vt,
          it, plan)
    emit({"phase": "k3_vs_plain", "cases": cases, "max_abs_err": worst,
          "tiles": sorted(tiles), "split_chunks": split_chunks,
          "limits": [QUERY_ROWS, MAX_GROUP],
          "tol": "0 (rows equal, scores bit-equal)"})
    return worst


def _pool_inputs(B, T, V, dtype, torch, pitch=None, full=False, seed=0):
    """A projection plane (B, T, V) of ``dtype`` at row pitch ``pitch``,
    its bias and weights (term weights about 1, every third of the first
    passage's negative, a ragged mask unless ``full``) on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    proj = (torch.randn(B, T, pitch or V, generator=g, device="cuda") * 3
            ).to(dtype)[..., :V]
    bias = torch.randn(V, generator=g, device="cuda").to(dtype)
    tw = torch.randn(B, T, generator=g, device="cuda") * 0.5 + 1
    tw[0, ::3] = -tw[0, ::3].abs()
    lengths = (torch.full((B,), T, device="cuda") if full else
               torch.randint(1, T + 1, (B,), generator=g, device="cuda"))
    mask = torch.arange(T, device="cuda")[None] < lengths[:, None]
    return proj, bias, tw * mask.float()


POOL_RTOL = 3e-5    # K4 vs plain: f32 sums of exponentials in another order


def _check_pool(proj, bias, w, label, torch) -> float:
    """K4 against its plain version on one input: each value within
    :data:`POOL_RTOL` of its own magnitude; the largest relative gap."""
    from dhr_tpu_torch.ops.lexical_pool import (
        lexical_pool, lexical_pool_plain)

    got = lexical_pool(proj, bias, w)
    want = lexical_pool_plain(proj, bias, w)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if not torch.allclose(got, want, rtol=POOL_RTOL, atol=1e-30):
        raise AssertionError(f"lexical_pool {label}: max relative gap {rel}")
    return rel


def phase_k4(torch):
    """K4 vs plain: the encode cell's batch (256, 79, 30,522), (1, 7),
    (3, 511), an odd pitch (element loads) in bf16, and f16 / f32 at a
    small shape, ragged masks and negative term weights; each value within
    3e-5 of its own magnitude (sums of exponentials in another order).
    Then, at the cell's batch with every position live, K4's ms beside its
    bound (one read of the bf16 plane and the (B, V) f32 write at
    3.35 TB/s), the plain version's, and the head before and after: the
    MLM transform, the projection and the pool, against today's chain of
    passes (logits with the bias, f32 softmax, weighting, max)."""
    import torch.nn.functional as F

    from dhr_tpu_torch.models.transformer import EncoderConfig, MLMHead
    from dhr_tpu_torch.ops.lexical_pool import (
        lexical_pool, lexical_pool_plain)

    worst, cases = 0.0, 0
    for B, T, V, pitch, dt in (
            (256, 79, 30522, None, torch.bfloat16),
            (1, 7, 30522, None, torch.bfloat16),
            (3, 511, 30522, None, torch.bfloat16),
            (4, 33, 30522, 30525, torch.bfloat16),
            (3, 17, 30522, None, torch.float16),
            (3, 17, 30522, None, torch.float32)):
        proj, bias, w = _pool_inputs(B, T, V, dt, torch, pitch)
        rel = _check_pool(proj, bias, w, (B, T, V, pitch, dt), torch)
        worst, cases = max(worst, rel), cases + 1
        del proj, bias, w

    B, T, V, H = 256, 79, 30522, 768
    proj, bias, w = _pool_inputs(B, T, V, torch.bfloat16, torch, full=True)
    ms = cuda_ms(lambda: lexical_pool(proj, bias, w), 20, torch)
    plain_ms = cuda_ms(lambda: lexical_pool_plain(proj, bias, w), 3, torch)
    nbytes = B * T * V * 2 + V * 2 + B * T * 4 + B * V * 4
    del proj
    head = MLMHead(EncoderConfig(), tied=False).cuda()
    head.decoder.to(torch.bfloat16)
    head.transform.to(torch.bfloat16)
    head.bias.data = bias
    hidden = torch.randn(B, T, H, device="cuda").to(torch.bfloat16)
    tw = w[..., None]
    with torch.inference_mode():
        chain_ms = cuda_ms(lambda: torch.softmax(
            head(hidden), dim=-1, dtype=torch.float32).mul_(tw).amax(-2),
            3, torch)
        head_ms = cuda_ms(lambda: lexical_pool(head.projection(hidden),
                                               head.bias, w), 5, torch)
        gemm_ms = cuda_ms(lambda: F.linear(hidden, head.decoder.weight), 5,
                          torch)
    out = {"phase": "k4_vs_plain", "cases": cases, "max_rel_err": worst,
           "tol": f"rtol {POOL_RTOL} (f32 sums of exponentials in "
                  "another order)",
           "shape": [B, T, V], "bytes_each_input_once": nbytes,
           "head_ms_now": head_ms, "head_ms_chain_before": chain_ms,
           "vocab_gemm_ms": gemm_ms}
    kernel = {"max_rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": None, "chain_ms": chain_ms}
    emit({**out, **kernel})
    return kernel


def _combine_inputs(N, k, H, dtype, torch, seed=0):
    """Rows in expert order (N * k, H), ``slot`` a random permutation of
    them (N, k) and f32 weights with zeros and negatives, on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rows = torch.randn(N * k, H, generator=g, device="cuda").to(dtype)
    slot = torch.randperm(N * k, generator=g, device="cuda").view(N, k)
    w = torch.rand(N, k, generator=g, device="cuda") * 1.5 - 0.5
    w[::3, 0] = 0.0
    return rows, slot, w


def _check_combine(N, k, H, dt, torch) -> tuple[float, float]:
    """K5 against its plain version on :func:`_combine_inputs`: each value
    within an ulp of ``dt`` at the larger result plus the f32 sums'
    round-off (2 k 2^-24 of the products' magnitudes), and at least 99%
    bit-equal in 16-bit dtypes; (the largest gap over its bound, the
    bit-equal share)."""
    from dhr_tpu_torch.ops.moe_combine import combine, moe_combine

    rows, slot, w = _combine_inputs(N, k, H, dt, torch)
    got = moe_combine(rows, slot, w)
    want = combine(rows, slot, w)
    fi = torch.finfo(dt)
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(big)
    ulp = (torch.ldexp(torch.ones_like(big), e - 1) * fi.eps).clamp_min(
        fi.tiny * fi.eps)
    picked = rows[slot.reshape(-1)].view(N, k, H).float().abs()
    tol = ulp + 2 * k * 2.0 ** -24 * (picked * w.abs()[..., None]).sum(1)
    ratio = float(((got.float() - want.float()).abs() / tol).max())
    equal = float((got == want).float().mean())
    if ratio > 1 or (dt != torch.float32 and equal < 0.99):
        raise AssertionError(f"moe_combine {(N, k, H, dt)}: gap {ratio} of "
                             f"its bound, {equal} bit-equal")
    return ratio, equal


def phase_k5(torch):
    """K5 vs plain: the dsv2 cell's batch (19,000 real tokens, k = 6,
    H = 2,048) in bf16, one token, k = 1 and 2, H = 64 and 61, 16 slots,
    f16 and f32; each value within an ulp of its dtype at the larger
    result, plus the f32 sums' round-off (2 k 2^-24 of the products'
    magnitudes: K5 sums in slot order, PyTorch's reduction in its own),
    and at least 99% bit-equal in 16-bit dtypes.  Then, at the cell's
    batch, K5's ms beside its bound (the rows read once, the output
    written once, slot ids and weights read once, at 3.35 TB/s) and the
    plain five-pass combine's."""
    from dhr_tpu_torch.ops.moe_combine import combine, moe_combine

    worst, cases, least_equal = 0.0, 0, 1.0
    for N, k, H, dt in ((19000, 6, 2048, torch.bfloat16),
                        (1, 6, 2048, torch.bfloat16),
                        (300, 1, 2048, torch.bfloat16),
                        (300, 2, 2048, torch.bfloat16),
                        (333, 6, 64, torch.bfloat16),
                        (257, 6, 61, torch.bfloat16),
                        (100, 16, 128, torch.bfloat16),
                        (999, 6, 2048, torch.float16),
                        (999, 6, 2048, torch.float32)):
        ratio, equal = _check_combine(N, k, H, dt, torch)
        worst, cases = max(worst, ratio), cases + 1
        if dt != torch.float32:
            least_equal = min(least_equal, equal)

    N, k, H = 19000, 6, 2048
    rows, slot, w = _combine_inputs(N, k, H, torch.bfloat16, torch)
    ms = cuda_ms(lambda: moe_combine(rows, slot, w), 50, torch)
    plain_ms = cuda_ms(lambda: combine(rows, slot, w), 10, torch)
    nbytes = N * k * H * 2 + N * H * 2 + N * k * (8 + 4)
    out = {"phase": "k5_vs_plain", "cases": cases,
           "max_gap_over_bound": worst, "least_bit_equal_share": least_equal,
           "tol": "an ulp of the dtype + 2 k 2^-24 sum |w x| (f32 sums in "
                  "another order)",
           "shape": [N, k, H], "bytes_each_input_once": nbytes}
    kernel = {"max_rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": None}
    emit({**out, **kernel})
    return kernel


def phase_k6(torch):
    """K6 vs plain at DeepSeek-V2-Lite's MLA (16 heads, 128 / 64 / 128):
    the dsv2 cell's batch (the middle bucket of a call of 2,048 passages of
    its length spec: 256 passages), 32 passages ragged up to 8, 128 and
    200 tokens, and ``DecoderConfig.tiny``'s dims (8 / 8 / 8) at 4 x 12
    and 2 x 1.  Each case within 2^-5 of the output's scale of the plain
    version, and on its first 8 passages within 2^-7 of the f64 core
    (``tests/mla_reference.py``, as the card tests) and no farther from it
    than the plain version plus 2^-8: K6's scores are f32 and its P is
    rounded to bf16 (2^-9); the plain version rounds the scores to bf16
    twice (~2^-7 of the scale).  Then, at the cell's batch, K6's ms beside
    its bound (kv and k_pe of the real tokens and q of every row read
    once, the output written once, at 3.35 TB/s) and the eager chain's
    (the plain version)."""
    import numpy as np

    from dhr_tpu_torch.models import decoder as dec
    from dhr_tpu_torch.ops.mla_attention import (
        mla_attention, mla_attention_plain)

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from mla_reference import f64_core, mla_inputs

    heads, dims, rank = DSV2_MLA
    mean, sigma, lo, hi = DSV2_LENGTHS
    rng = np.random.default_rng(22)
    mu = math.log(mean) - sigma * sigma / 2
    call = np.clip(np.rint(rng.lognormal(mu, sigma, 2048)), lo, hi) + 2
    cell = np.sort(call).astype(int)[1024:1280]

    def ragged(B, L):
        lens = rng.integers(1, L + 1, B)
        lens[0] = L
        return lens

    m = dec.yarn_mscale(40.0, 0.707)
    worst, cases, f64_gaps = 0.0, 0, []
    for lengths, n, d, rk in ((cell, heads, dims, rank),
                              (ragged(32, 8), heads, dims, rank),
                              (ragged(32, 128), heads, dims, rank),
                              (ragged(32, 200), heads, dims, rank),
                              (ragged(4, 12), 2, (8, 8, 8), 16),
                              (ragged(2, 1), 2, (8, 8, 8), 16)):
        scale = (d[0] + d[1]) ** -0.5 * m * m
        args = mla_inputs(lengths, n, d, seed=cases, rank=rk, device="cuda")
        with torch.inference_mode():
            got = mla_attention(*args, n, d[0], scale)
            plain = mla_attention_plain(*args, n, d[0], scale)
            top = float(plain.float().abs().max())
            gap = float((got.float() - plain.float()).abs().max()) / top
            sub = [t[:8] for t in args[:3]] + [*args[3:5], args[5][:8]]
            ref = f64_core(*sub, n, d, scale)
            ref_top = float(ref.abs().max())
            k6_gap = float((got[:8].double() - ref).abs().max()) / ref_top
            plain_gap = float((plain[:8].double() - ref).abs().max()
                              ) / ref_top
        shape = (len(lengths), int(max(lengths)), n, d)
        if not (gap <= 2.0 ** -5 and k6_gap <= 2.0 ** -7
                and k6_gap <= plain_gap + 2.0 ** -8):
            raise AssertionError(f"mla_attention {shape}: gap {gap} to the "
                                 f"plain version, {k6_gap} to f64 (plain "
                                 f"{plain_gap})")
        worst, cases = max(worst, gap), cases + 1
        f64_gaps.append([k6_gap, plain_gap])
        del args, got, plain, ref, sub

    args = mla_inputs(cell, heads, dims, rank=rank, device="cuda")
    B, L = len(cell), int(cell.max())
    scale = (dims[0] + dims[1]) ** -0.5 * m * m
    with torch.inference_mode():
        ms = cuda_ms(lambda: mla_attention(*args, heads, dims[0], scale),
                     50, torch)
        plain_ms = cuda_ms(lambda: mla_attention_plain(
            *args, heads, dims[0], scale), 10, torch)
    # what the function needs: kv and k_pe of the real tokens (a padded
    # key is never visible), q and the output of every row, the key mask
    # (one byte a key) and the first halves of cos and sin
    dn, dr, dv = dims
    real = int(cell.sum())
    nbytes = (real * (heads * (dn + dv) + dr) * 2
              + B * L * heads * (dn + dr + dv) * 2 + B * L + L * dr * 4)
    out = {"phase": "k6_vs_plain", "cases": cases,
           "f64_gaps_k6_plain": f64_gaps,
           "tol": "2^-5 of the scale to the plain version; 2^-7 to f64 "
                  "and no farther than the plain version + 2^-8",
           "shape": [B, L, heads], "real_tokens": real,
           "bytes_each_input_once": nbytes,
           "ms_27_layers": 27 * ms, "plain_ms_27_layers": 27 * plain_ms}
    kernel = {"max_rel_err": worst, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": None}
    emit({**out, **kernel})
    return kernel


def phase_kimi(torch):
    """Kimi Linear's pieces at the Kimi cell's largest bucket (8 x 2,048):
    K6 without positions (the identity tables) at 32 heads of (128, 64,
    128), ragged, within 2^-7 of an f64 core on its first 2 documents and
    no farther than the plain version + 2^-8 (as ``phase_k6``); and one KDA
    layer (published widths, random weights, TF32 off) in f32 on the card
    against its CPU twin, within 1e-4 of the output's scale (f32 products
    summed in another order), its chunked scan alone likewise (the layer
    on the card runs K7, the scan called alone the plain version).  K7
    against an f64 token-by-token recurrence on 2 documents with the
    published decay inits (a chunk's log-decay past -100), no farther from
    it than 1.5 times the plain scan.  Then the bf16 layer's ms at that
    bucket, K7's and the plain scan's from bf16 inputs laid out as the
    convolution gives them, and the bf16 layer's gap to the f32 one."""
    import numpy as np

    from dhr_tpu_torch.models import decoder as dec
    from dhr_tpu_torch.ops.kda_scan import fused_kda_scan
    from dhr_tpu_torch.ops.mla_attention import (
        mla_attention, mla_attention_plain)

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import kimi_linear_reference as kref
    from mla_reference import f64_core, mla_inputs

    B, L = KIMI_BUCKET
    H, h, d, heads = KIMI_WIDTHS
    dims = (128, 64, 128)
    rng = np.random.default_rng(23)
    lengths = rng.integers(L // 2, L + 1, B)
    lengths[0] = L
    cfg = dec.DecoderConfig.kimi_linear_48b_a3b()
    cos, sin = dec.position_tables(cfg, L, "cuda")
    scale = (dims[0] + dims[1]) ** -0.5
    q, kv, k_pe, _, _, mask = mla_inputs(lengths, heads, dims, seed=23,
                                         device="cuda")
    with torch.inference_mode():
        got = mla_attention(q, kv, k_pe, cos, sin, mask, heads, 128, scale)
        plain = mla_attention_plain(q, kv, k_pe, cos, sin, mask, heads, 128,
                                    scale)
        ref = f64_core(q[:2], kv[:2], k_pe[:2], cos, sin, mask[:2], heads,
                       dims, scale)
        top = float(ref.abs().max())
        k6_gap = float((got[:2].double() - ref).abs().max()) / top
        plain_gap = float((plain[:2].double() - ref).abs().max()) / top
        k6_ms = cuda_ms(lambda: mla_attention(q, kv, k_pe, cos, sin, mask,
                                              heads, 128, scale), 10, torch)
    if not (k6_gap <= 2.0 ** -7 and k6_gap <= plain_gap + 2.0 ** -8):
        raise AssertionError(f"K6 without positions: {k6_gap} to f64 "
                             f"(plain {plain_gap})")
    del q, kv, k_pe, got, plain, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(23)
    layer = dec.KDA(dataclasses.replace(cfg, dtype=torch.float32,
                                        param_dtype=torch.float32))
    dec.init_weights(layer, cfg.initializer_range)
    x = torch.randn(B, L, H)
    for b, n in enumerate(lengths):
        x[b, n:] = 0.0
    gens = [torch.Generator().manual_seed(s) for s in range(5)]
    scan_in = (*(torch.randn(B, L, h, d, generator=gens[i])
                 for i in range(3)),
               -torch.rand(B, L, h, d, generator=gens[3]) * 0.2,
               torch.rand(B, L, h, generator=gens[4]))
    with torch.inference_mode():
        want = layer(x)
        want_scan = dec.kda_scan(*scan_in)
        layer.cuda()
        xc = x.cuda()
        got = layer(xc)
        got_scan = dec.kda_scan(*(t.cuda() for t in scan_in))
        gaps = {"layer": float((got.cpu() - want).abs().max())
                / float(want.abs().max()),
                "scan": float((got_scan.cpu() - want_scan).abs().max())
                / float(want_scan.abs().max())}
        if not all(g <= 1e-4 for g in gaps.values()):
            raise AssertionError(f"the KDA layer card vs CPU: {gaps}")
        layer.to(torch.bfloat16)
        xb = xc.to(torch.bfloat16)
        bf16 = layer(xb)
        gaps["bf16_layer_vs_f32"] = float((bf16.float() - got).abs().max()
                                          ) / float(got.abs().max())
        ms = cuda_ms(lambda: layer(xb), 5, torch)
        gen = torch.Generator().manual_seed(24)
        a_log = torch.empty(h, 1).uniform_(1, 16, generator=gen).log_()
        dt = torch.empty(h, d).uniform_(1e-3, 1e-1, generator=gen)
        g64 = -a_log.exp() * torch.nn.functional.softplus(
            torch.randn(2, L, h, d, generator=gen) + dt
            + torch.log(-torch.expm1(-dt)))
        f64_in = [t[:2].cuda() for t in scan_in]
        f64_in[3] = g64.cuda()
        k7 = fused_kda_scan(*f64_in)
        plain = dec.kda_scan(*f64_in)
        qd, kd, vd, gd, bd = (t.double() for t in f64_in)
        ref = kref.kda_recurrence(kref.l2norm(qd) * d ** -0.5,
                                  kref.l2norm(kd), vd, gd, bd)
        top = float(ref.abs().max())
        f64_gaps = [float((k7.double() - ref).abs().max()) / top,
                    float((plain.double() - ref).abs().max()) / top]
        k7_vs_plain = float((k7 - plain).abs().max() / plain.abs().max())
        if not f64_gaps[0] <= 1.5 * f64_gaps[1]:
            raise AssertionError(f"K7 to f64 {f64_gaps[0]}, the plain scan "
                                 f"{f64_gaps[1]}")
        del k7, plain, ref, qd, kd, vd, gd, bd, f64_in
        bf_in = [t.cuda().reshape(B, L, h * d).transpose(1, 2).contiguous()
                 .to(torch.bfloat16).transpose(1, 2).reshape(B, L, h, d)
                 for t in scan_in[:3]] + [t.cuda() for t in scan_in[3:]]
        k7_ms = cuda_ms(lambda: fused_kda_scan(*bf_in), 10, torch)
        scan_ms = cuda_ms(lambda: dec.kda_scan(*bf_in), 5, torch)
        peak = torch.cuda.max_memory_allocated()
    out = {"phase": "kimi_vs_plain", "bucket": [B, L],
           "lengths": lengths.tolist(), "k6_nope_f64_gaps_k6_plain":
           [k6_gap, plain_gap], "k6_nope_ms": k6_ms,
           "kda_gaps_card_vs_cpu": gaps, "kda_layer_bf16_ms": ms,
           "k7_f64_gaps_k7_plain": f64_gaps, "k7_ms": k7_ms,
           "kda_scan_ms": scan_ms, "peak_bytes": peak,
           "tol": "K6: 2^-7 to f64 and no farther than the plain version "
                  "+ 2^-8; KDA f32: 1e-4 of the scale; K7: to f64 no "
                  "farther than 1.5x the plain scan"}
    # K7's least bytes: q, k, v in and o out in bf16, g and beta in f32
    nbytes = B * L * h * (d * (4 * 2 + 4) + 4)
    kernel = {"max_rel_err": k7_vs_plain, "ms": k7_ms, "plain_ms": scan_ms,
              "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "library_ms": None}
    emit({**out, **kernel})
    del layer, x, xc, xb, got, bf16
    torch.cuda.empty_cache()
    return kernel


def phase_nemotron(torch):
    """NVIDIA-Nemotron-3-Nano-30B-A3B's pieces at its cell's largest batch
    (:data:`NEMOTRON_BATCH`): K4 over the untied head's vocabulary (8,
    2,048, 131,072) in bf16 against its plain version (as ``phase_k4``);
    K5 at (16,218 x 6, 2,688) in bf16 against its plain version (as
    ``phase_k5``); the chunked SSD scan (64 heads of 64, 8 groups of state
    128, chunks of 128, the published ``dt`` and ``A`` inits) in f32 on
    the card against its CPU twin on 2 documents of 2,048 positions, one
    padded from 1,500, within 1e-4 of the output's scale (f32 products
    summed in another order); K8 on the card against the CPU's plain scan
    at the batch's whole bucket (8 x 2,048 positions, every one drawn) in
    f32, within 1e-6 of the scale (both f32, summed in other orders), one
    K8 launch a call and none for the plain scan on the card; K8 from
    those inputs in bf16, laid out as the convolution gives them
    (channel-major, read in place: the path the cell takes), against the
    CPU's plain scan of the same bf16 tensors, element by element within
    one bf16 ulp (1e-5 of the scale near zero);
    SDPA's causal GQA (32 query heads over 2
    key / value heads of 128) in bf16 at 2 x 2,048 within 2e-2 of an f64
    core's scale (``tests/nemotron_h_reference.py``) and no farther from
    it than twice the plain twin + 1e-3; and one MoE layer at the
    published widths (128 relu^2 experts of 1,856, top 6, one shared of
    3,712) in bf16 over the batch's real tokens: its launches read from
    zero (two grouped GEMMs, one K5, no K4), the pads' outputs 0, and the
    grouped path within 2e-2 of the output's scale of the f32 loop twin
    over the same routes.  Then K4's and K5's ms at those shapes beside
    their bounds (the real positions' plane, the bias, the weights and the
    (B, V) f32 output; K5's as ``phase_k5``) at 3.35 TB/s; and K8's and
    the plain scan's ms from bf16 x, B and C laid out as the convolution
    gives them (channel-major) at that batch, beside K8's bounds: its
    bytes (x, B, C and y in bf16, dt in f32, once each) at 3.35 TB/s, and
    the chunked algorithm's FLOPs (``benchmarks/roofline_mamba.py``'s
    count over the padded positions) at the f32 FFMA rate (67 TFLOP/s).
    Returns K8's row of the kernels line: the bf16 gap and ms, both of the
    path the cell takes."""
    import torch.nn.functional as F

    from dhr_tpu_torch.models import decoder as dec
    from dhr_tpu_torch.ops.lexical_pool import lexical_pool
    from dhr_tpu_torch.ops.moe_combine import moe_combine
    from dhr_tpu_torch.ops.ssd_scan import fused_ssd_scan
    from dhr_tpu_torch.utils import profiling

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import nemotron_h_reference as nref

    cfg = dec.DecoderConfig.nemotron_3_nano_30b_a3b(
        param_dtype=torch.bfloat16)
    B, L = len(NEMOTRON_BATCH), max(NEMOTRON_BATCH)
    V, H, k = cfg.vocab_size, cfg.hidden_size, cfg.num_experts_per_tok
    lengths = torch.tensor(NEMOTRON_BATCH, device="cuda")
    live = torch.arange(L, device="cuda")[None] < lengths[:, None]
    real = int(lengths.sum())

    proj, bias, w = _pool_inputs(B, L, V, torch.bfloat16, torch, full=True)
    w = w * live.float()
    k4_gap = _check_pool(proj, bias, w, (B, L, V), torch)
    k4_ms = cuda_ms(lambda: lexical_pool(proj, bias, w), 10, torch)
    k4_bytes = real * V * 2 + V * 2 + B * L * 4 + B * V * 4
    del proj, bias, w
    torch.cuda.empty_cache()
    k5_gap, k5_equal = _check_combine(real, k, H, torch.bfloat16, torch)
    rows, slot, cw = _combine_inputs(real, k, H, torch.bfloat16, torch)
    k5_ms = cuda_ms(lambda: moe_combine(rows, slot, cw), 20, torch)
    k5_bytes = real * k * H * 2 + real * H * 2 + real * k * (8 + 4)
    del rows, slot, cw

    h, P, g, N = (cfg.mamba_num_heads, cfg.mamba_head_dim, cfg.n_groups,
                  cfg.ssm_state_size)
    gen = torch.Generator().manual_seed(25)
    dt0 = torch.empty(h).uniform_(math.log(1e-3), math.log(0.1),
                                  generator=gen).exp_().clamp_(min=1e-4)
    dt = F.softplus(torch.randn(2, L, h, generator=gen)
                    + dt0 + torch.log(-torch.expm1(-dt0)))
    scan_in = [torch.randn(2, L, h, P, generator=gen), dt,
               -torch.arange(1, h + 1, dtype=torch.float32),
               torch.randn(2, L, g, N, generator=gen),
               torch.randn(2, L, g, N, generator=gen), torch.ones(h)]
    for i in (0, 1, 3, 4):
        scan_in[i][1, 1500:] = 0.0
    with torch.inference_mode():
        want = dec.ssd_scan(*scan_in, chunk=cfg.chunk_size)
        got = dec.ssd_scan(*(t.cuda() for t in scan_in),
                           chunk=cfg.chunk_size)
    scan_gap = float((got.cpu() - want).abs().max()) / float(
        want.abs().max())
    if not (torch.isfinite(got).all() and scan_gap <= 1e-4):
        raise AssertionError(f"ssd_scan card vs CPU: {scan_gap}")
    least_decay = float((dt * scan_in[2]).min())
    del scan_in, want, got

    # K8 at the whole batch, f32, against the CPU's plain scan
    gen = torch.Generator().manual_seed(27)
    dt = F.softplus(torch.randn(B, L, h, generator=gen)
                    + dt0 + torch.log(-torch.expm1(-dt0)))
    scan_in = [torch.randn(B, L, h, P, generator=gen), dt,
               -torch.arange(1, h + 1, dtype=torch.float32),
               torch.randn(B, L, g, N, generator=gen),
               torch.randn(B, L, g, N, generator=gen),
               1 + 0.1 * torch.randn(h, generator=gen)]
    with torch.inference_mode():
        want = dec.ssd_scan(*scan_in, chunk=cfg.chunk_size)
        on_card = [t.cuda() for t in scan_in]
        reset_launches()
        got = fused_ssd_scan(*on_card, cfg.chunk_size)
        torch.cuda.synchronize()
        k8_launches = read_launches()["ssd_scan"]
        dec.ssd_scan(*on_card, chunk=cfg.chunk_size)
        torch.cuda.synchronize()
        k8_launches = [k8_launches, read_launches()["ssd_scan"]]
        reset_launches()
    k8_gap = float((got.cpu().double() - want.double()).abs().max()) / float(
        want.abs().max())
    if not (torch.isfinite(got).all() and k8_gap <= 1e-6
            and k8_launches == [1, 1]):
        raise AssertionError(f"K8 vs the CPU's plain scan: {k8_gap}, "
                             f"launches {k8_launches}")
    del want, got
    # K8 from the convolution's layout, in bf16 (the path it takes in the
    # cell), against the CPU's plain scan of the same tensors; then timed
    # beside the plain scan on the card
    bf_in = list(on_card)
    for i in (0, 3, 4):
        t = on_card[i]
        bf_in[i] = (t.reshape(B, L, -1).transpose(1, 2).contiguous()
                    .to(torch.bfloat16).transpose(1, 2).reshape(t.shape))
    with torch.inference_mode():
        got = fused_ssd_scan(*bf_in, cfg.chunk_size).cpu().float()
        want = dec.ssd_scan(*(t.cpu() for t in bf_in),
                            chunk=cfg.chunk_size).float()
    top = float(want.abs().max())
    mag = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    k8_bf16_off = int(((got - want).abs() > torch.maximum(
        ulp, torch.full_like(ulp, 1e-5 * top))).sum())
    k8_bf16_gap = float((got - want).abs().max()) / top
    if not (torch.isfinite(got).all() and k8_bf16_off == 0):
        raise AssertionError(f"K8 from bf16 channel-major inputs vs the "
                             f"CPU's plain scan: {k8_bf16_off} elements past "
                             f"a bf16 ulp, {k8_bf16_gap} of the scale")
    del got, want, mag, ulp
    with torch.inference_mode():
        k8_ms = cuda_ms(lambda: fused_ssd_scan(*bf_in, cfg.chunk_size), 20,
                        torch)
        plain_ms = cuda_ms(lambda: dec.ssd_scan(*bf_in,
                                                chunk=cfg.chunk_size), 5,
                           torch)
    k8_bytes = B * L * (2 * h * P * 2 + 2 * g * N * 2 + 4 * h)
    c = cfg.chunk_size
    k8_flops = B * (L // c) * (g * 2 * c * c * N
                               + h * (2 * c * c * P + 4 * c * N * P))
    del scan_in, on_card, bf_in
    torch.cuda.empty_cache()

    n, kv, d = cfg.num_heads, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(26)
    q = torch.randn(2, n, L, d, generator=gen).to("cuda", torch.bfloat16)
    kk, vv = (torch.randn(2, kv, L, d, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        sdpa = F.scaled_dot_product_attention(
            q, kk, vv, is_causal=True, scale=d ** -0.5, enable_gqa=True)
        plain = dec.gqa_attention_plain(q, kk, vv, d ** -0.5)
        ref = nref.causal_gqa(*(t.double().transpose(1, 2)
                                for t in (q, kk, vv)), d ** -0.5
                              ).transpose(1, 2)
    top = float(ref.abs().max())
    gqa_gaps = [float((sdpa.double() - ref).abs().max()) / top,
                float((plain.double() - ref).abs().max()) / top]
    if not (gqa_gaps[0] < 2e-2 and gqa_gaps[0] <= 2 * gqa_gaps[1] + 1e-3):
        raise AssertionError(f"SDPA GQA to f64 {gqa_gaps[0]}, the plain "
                             f"twin {gqa_gaps[1]}")
    del q, kk, vv, sdpa, plain, ref

    torch.manual_seed(25)
    with torch.device("cuda"):
        moe = dec.MoE(cfg)
    dec.init_weights(moe, cfg.initializer_range)
    moe.gate.e_score_correction_bias.normal_(0.0, 0.01)
    x = torch.randn(B, L, H, device="cuda").to(torch.bfloat16)
    at = live.reshape(-1).nonzero()[:, 0]
    with torch.inference_mode():
        reset_launches()
        y = moe(x, at)
        torch.cuda.synchronize()
        launches = {"moe_grouped_mm":
                    profiling.counters().get("launches.moe_grouped_mm", 0),
                    **{key: read_launches()[key]
                       for key in ("moe_combine", "lexical_pool")}}
        pads = float(y.reshape(-1, H)[~live.reshape(-1)].abs().max())
        t = x.reshape(-1, H)[at]
        idx, rw = moe.gate(t)
        grouped = dec.routed_experts_grouped(t, idx, rw, moe.experts)
        loop = dec.routed_experts_loop(t.float(), idx, rw, moe.experts)
        moe_gap = float((grouped.float() - loop).abs().max()) / float(
            loop.abs().max())
        reset_launches()
    if launches != {"moe_grouped_mm": 2, "moe_combine": 1,
                    "lexical_pool": 0} or pads != 0.0 or moe_gap > 2e-2:
        raise AssertionError(f"the relu^2 MoE at the published widths: "
                             f"launches {launches}, pads {pads}, grouped "
                             f"vs loop {moe_gap}")
    del moe, x, y, t, grouped, loop
    torch.cuda.empty_cache()
    emit({"phase": "nemotron_vs_plain", "batch": list(NEMOTRON_BATCH),
          "real_tokens": real, "k4_shape": [B, L, V], "k4_max_rel_err":
          k4_gap, "k4_ms": k4_ms, "k4_bound_ms":
          k4_bytes / HBM_BYTES_PER_S * 1e3, "k5_shape": [real, k, H],
          "k5_gap_over_bound": k5_gap, "k5_bit_equal_share": k5_equal,
          "k5_ms": k5_ms, "k5_bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3,
          "ssd_scan_gap_card_vs_cpu": scan_gap,
          "ssd_least_dt_a": least_decay, "k8_gap_vs_cpu_plain": k8_gap,
          "k8_bf16_gap_vs_cpu_plain": k8_bf16_gap,
          "k8_launches_k8_then_plain": k8_launches, "k8_ms": k8_ms,
          "ssd_scan_plain_ms": plain_ms,
          "k8_bound_ms": k8_bytes / HBM_BYTES_PER_S * 1e3,
          "k8_ffma_floor_ms": k8_flops / F32_FLOPS_PER_S * 1e3,
          "gqa_f64_gaps_sdpa_plain": gqa_gaps,
          "moe_grouped_vs_f32_loop": moe_gap, "moe_launches": launches,
          "tol": f"K4: rtol {POOL_RTOL}; K5: an ulp + 2 k 2^-24 sum |w x|; "
                 "scan: 1e-4 of the scale; K8: 1e-6 of the scale in f32, "
                 "a bf16 ulp (1e-5 of the scale near 0) from bf16; SDPA: "
                 "2e-2 to f64 and no farther than 2x the plain twin + "
                 "1e-3; MoE: 2e-2 of the scale"})
    return {"max_rel_err": k8_bf16_gap, "ms": k8_ms, "plain_ms": plain_ms,
            "bound_ms": k8_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None}


def phase_search_vs_plain(index, queries_raw, torch):
    """The whole search on the card against the same search on the CPU's
    plain PyTorch path, over the 204,803-row corpus: same final scores at
    each rank, same rows apart from ties at the candidate pool's edge."""
    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher

    qv, qf = (x[:8] for x in queries_raw)
    cpu_index = DeviceIndex.from_arrays(
        index.values.cpu(), index.indices.cpu(), index.docids,
        index.lex_dim, index.value_scales.cpu(), device="cpu")
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=8)
    got_s, got_r = Searcher(index, cfg).search(qv, qf)
    want_s, want_r = Searcher(cpu_index, cfg, device="cpu").search(
        qv.cpu(), qf.cpu())
    check_close("search scores gpu vs cpu plain", torch.from_numpy(got_s),
                torch.from_numpy(want_s), 1e-4, torch)
    overlap = agreement(got_r, want_r)
    emit({"phase": "search_vs_plain", "queries": int(qv.shape[0]),
          "rows": index.num_rows, "overlap": overlap})
    if min(overlap.values()) < 0.99:
        raise AssertionError(f"search on the card vs plain: {overlap}")


def phase_modes(index, queries_raw, torch):
    """The other search modes on the card against the same search on the
    CPU's plain path, 16 queries over the 204,803-row slice: row-chunked ip
    + rerank (layout row, 5 chunks and a 3-row tail), pq (m=64, built by
    ``PackedIndex.quantize_pq`` on the card, twice: the two builds must be
    equal) + rerank, and two-tier escalation (pool 2,000 of 10,000) at a
    margin that escalates some queries; overlap >= 0.99 at every k."""
    import numpy as np

    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)

    qv, qf = queries_raw
    args = (index.docids, index.lex_dim)
    row = DeviceIndex.from_arrays(index.values, index.indices, *args,
                                  index.value_scales, layout="row",
                                  device="cuda")
    cpu_both = DeviceIndex.from_arrays(
        index.values.cpu(), index.indices.cpu(), *args,
        index.value_scales.cpu(), device="cpu")
    cpu_row = DeviceIndex.from_arrays(
        cpu_both.values, cpu_both.indices, *args, cpu_both.value_scales,
        layout="row", device="cpu")
    base = dict(topk=1000, rerank=True, agip_topk=10000, query_batch=8)
    out = {"phase": "modes_vs_plain", "queries": int(qv.shape[0]),
           "rows": index.num_rows}

    def compare(name, cfg, card_index, cpu_index):
        card = Searcher(card_index, cfg)
        cpu = Searcher(cpu_index, cfg, device="cpu")
        got_s, got_r = card.search(qv, qf)
        want_s, want_r = cpu.search(qv.cpu(), qf.cpu())
        # stage-1 scores of ip differ in the last bits between the card's
        # and the CPU's GEMM, which can move a row across the pool's edge:
        # compare the final scores of common rows
        common = [np.intersect1d(a, b, return_indices=True)
                  for a, b in zip(got_r, want_r)]
        check_close(f"{name} scores of common rows, gpu vs cpu plain",
                    torch.from_numpy(np.concatenate(
                        [got_s[i][c[1]] for i, c in enumerate(common)])),
                    torch.from_numpy(np.concatenate(
                        [want_s[i][c[2]] for i, c in enumerate(common)])),
                    1e-4, torch)
        overlap = agreement(got_r, want_r)
        out[name] = {"overlap": overlap}
        if min(overlap.values()) < 0.99:
            raise AssertionError(f"{name} on the card vs plain: {overlap}")
        return card, cpu

    ip_cfg = SearchConfig(mode="ip", row_chunk=50_000, **base)
    card, _ = compare("ip_row_chunked", ip_cfg, row, cpu_row)
    out["ip_row_chunked"]["chunks"] = card._row_chunks
    if card._row_chunks != 5:
        raise AssertionError(f"row chunks {card._row_chunks}, expected 5")

    floats = PackedIndex(
        values=(row.values.float() * row.value_scales[None, :]).cpu().numpy(),
        indices=row.indices.cpu().numpy(), docids=index.docids,
        lex_dim=index.lex_dim)
    packed = floats.quantize_pq(m=64, device="cuda")
    again = floats.quantize_pq(m=64, device="cuda")
    if not (np.array_equal(packed.pq_codes, again.pq_codes)
            and np.array_equal(packed.pq_centroids, again.pq_centroids)):
        raise AssertionError("two pq builds of the same plane differ")
    del floats, again
    compare("pq_m64", SearchConfig(mode="pq", **base),
            DeviceIndex.from_packed(packed, layout="row", device="cuda"),
            DeviceIndex.from_packed(packed, layout="row", device="cpu"))
    out["pq_m64"]["builds_equal"] = True

    gip = dict(theta=0.3, max_important_dims=48, escalate_pool=2000, **base)
    probe = Searcher(index, SearchConfig(**gip))
    s, _, floors = probe._run(probe.prepare_queries(qv, qf))
    m = np.sort(s[:, -1] - floors)
    mid = len(m) // 2
    margin = float((m[mid - 1] + m[mid]) / 2)
    card, cpu = compare("escalation", SearchConfig(escalate_margin=margin,
                                                   **gip), index, cpu_both)
    out["escalation"].update(margin=margin,
                             escalated_card=card.escalated_queries,
                             escalated_cpu=cpu.escalated_queries)
    emit(out)
    if not 0 < card.escalated_queries < qv.shape[0]:
        raise AssertionError(f"escalated {card.escalated_queries} of "
                             f"{qv.shape[0]}: expected some, not all")


def phase_modes_full(searcher, queries, torch):
    """ip over the dim-major plane, row-chunked ip over the row-major plane
    and pq (m=64) over codes of the int8 plane, each + rerank, on the main
    path's index (the row-major twin and the pq index share its planes):
    one pass of the main path's queries each, its launches (K2 only), its
    result and its agreement with the exact search."""
    from dhr_tpu_torch.ops.pq import train_encode_pq
    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    idx = searcher.index
    row = dataclasses.replace(idx, values_T=None, indices_T=None)
    torch.cuda.empty_cache()
    codes, centroids = train_encode_pq(idx.values, 64,
                                       value_scales=idx.value_scales)
    pq = dataclasses.replace(row, pq_codes=codes, pq_centroids=centroids)
    base = searcher.config
    out = {"phase": "modes_full", "rows": idx.num_rows,
           "queries": int(qv.shape[0]), "query_batch": base.query_batch}
    for name, index, mode in (("ip_dim_major", idx, "ip"),
                              ("ip_row_chunked", row, "ip"),
                              ("pq_m64", pq, "pq")):
        s = Searcher(index, dataclasses.replace(base, mode=mode))
        torch.cuda.empty_cache()
        reset_launches()
        scores, rows = s.search(qv, qf)
        launches = read_launches()
        want = {"partial_gip": 0, "gip_candidates": 0, "lexical_pool": 0,
                "moe_combine": 0, "mla_attention": 0,
                "rerank_gip": -(-qv.shape[0] // base.query_batch)}
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, expected "
                                 f"{want}")
        check_result(scores, rows, qv.shape[0], base.topk, idx.num_rows)
        out[name] = {"row_chunks": s._row_chunks, "launches": launches,
                     "staged_vs_exact": agreement(rows[:erows.shape[0]],
                                                  erows)}
        del s, scores, rows
    emit(out)


def agreement(staged, exact, ks=(10, 100, 1000)):
    import numpy as np

    return {str(k): float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
        for a, b in zip(staged, exact)])) for k in ks}


def _counters() -> tuple[str, ...]:
    """The kernels whose launches the recorder counts."""
    from dhr_tpu_torch.ops import kernel_launches

    return tuple(kernel_launches())


def reset_launches() -> None:
    """Zero the recorder: its launch counts, with its other counters and
    its spans."""
    from dhr_tpu_torch.utils import profiling

    profiling.reset()


def read_launches() -> dict:
    from dhr_tpu_torch.ops import kernel_launches

    return kernel_launches()


def check_result(scores, rows, n_queries, topk, n_rows):
    import numpy as np

    if scores.shape != (n_queries, topk) or rows.shape != scores.shape:
        raise AssertionError(f"result shape {scores.shape} / {rows.shape}")
    if not np.isfinite(scores).all() or rows.min() < 0 \
            or rows.max() >= n_rows:
        raise AssertionError("non-finite scores or row ids out of range")
    if (np.diff(scores, axis=1) > 0).any():
        raise AssertionError("final scores are not in descending order")


def phase_main(args, torch):
    """The main path at full width and the given row count: one pass of
    the queries, K1 and K2 once a batch, the result's form and its
    agreement with the exact search."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    v, f, scales, _ = synth_index_planes(args.seed, args.rows, device="cuda")
    index = DeviceIndex.from_arrays(
        v, f, np.arange(args.rows).astype(str), LEX_DIM, scales,
        device="cuda")
    del v, f
    qv, qf, _ = synth_reps(args.seed, args.queries, role="query", stream=1,
                           device="cuda")
    above = (qv[:, :LEX_DIM] > 0.3).sum(dim=1).float()
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=128)
    searcher = Searcher(index, cfg)

    reset_launches()
    scores, rows = searcher.search(qv, qf)
    launches = read_launches()
    want_launches = -(-args.queries // cfg.query_batch)  # once a batch
    emit({"phase": "kernels", "path": "main", "launches": launches,
          "expected": {"partial_gip": want_launches,
                       "rerank_gip": want_launches, "gip_candidates": 0,
                       "lexical_pool": 0, "moe_combine": 0,
                       "mla_attention": 0}})
    if launches != {"partial_gip": want_launches,
                    "rerank_gip": want_launches, "gip_candidates": 0,
                    "lexical_pool": 0, "moe_combine": 0, "mla_attention": 0}:
        raise AssertionError(f"main path launches {launches}, expected K1 "
                             f"and K2 {want_launches} times, K3 never")
    check_result(scores, rows, args.queries, cfg.topk, args.rows)
    n_agree = min(64, args.queries)
    exact = Searcher(index, dataclasses.replace(
        cfg, theta=0.0, rerank=False, approx_candidates=False,
        candidate_bf16=False, query_batch=n_agree))
    reset_launches()
    _, erows = exact.search(qv[:n_agree], qf[:n_agree])
    exact_launches = read_launches()
    emit({"phase": "kernels", "path": "exact_brute_force",
          "launches": exact_launches})
    if exact_launches != {"partial_gip": 1, "rerank_gip": 0,
                          "gip_candidates": 0, "lexical_pool": 0,
                          "moe_combine": 0, "mla_attention": 0}:
        raise AssertionError(f"exact search launches {exact_launches}, "
                             "expected K1 once, K2 and K3 never")
    agree = agreement(rows[:n_agree], erows)

    # the first batch's candidates: the kernels' shapes in phase_timing
    bs = cfg.query_batch
    qvb, qv1b, qib = searcher.prepare_queries(qv[:bs], qf[:bs])
    _, cand = searcher.select(searcher.stage1(qv1b, qib))
    emit({
        "phase": "main_path", "rows": args.rows,
        "rows_full_size": args.rows == MSMARCO_PASSAGES,
        "queries": args.queries, "query_batch": bs,
        "index_bytes": sum(t.untyped_storage().nbytes() for t in (
            index.values, index.values_T, index.indices, index.indices_T)),
        "query_dims_above_theta_mean": float(above.mean()),
        "frac_queries_above_scan_cap": float((above > 48).float().mean()),
        "staged_vs_exact": agree, "agreement_queries": n_agree,
    })
    for k, a in agree.items():
        if a < 0.99:
            raise AssertionError(f"staged-vs-exact agreement@{k} = {a} < 0.99")
    del exact, scores
    return searcher, (qvb, qv1b, qib, cand), launches, (qv, qf, erows)


def phase_fused(searcher, queries, torch):
    """The fused path on the main path's index and queries: K3 (G=8, packed
    ids) in place of K1 + selection over the full plane; K2 as before."""
    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    cfg = dataclasses.replace(searcher.config, fused_candidates=True,
                              candidate_block=8)
    fused = Searcher(searcher.index, cfg)
    if not (fused._fused and fused._packed_ids):
        raise AssertionError("the fused path did not engage")
    torch.cuda.empty_cache()
    reset_launches()
    scores, rows = fused.search(qv, qf)
    launches = read_launches()
    n_batches = -(-qv.shape[0] // cfg.query_batch)  # once a batch
    want = {"partial_gip": 0, "rerank_gip": n_batches,
            "gip_candidates": n_batches, "lexical_pool": 0,
            "moe_combine": 0, "mla_attention": 0}
    emit({"phase": "kernels", "path": "fused", "launches": launches,
          "expected": want})
    if launches != want:
        raise AssertionError(f"fused path launches {launches}, expected "
                             f"{want}")
    check_result(scores, rows, qv.shape[0], cfg.topk, fused.index.num_rows)
    agree = agreement(rows[:erows.shape[0]], erows)
    emit({
        "phase": "fused_path", "rows": fused.index.num_rows,
        "candidate_block": cfg.candidate_block, "queries": int(qv.shape[0]),
        "query_batch": cfg.query_batch, "staged_vs_exact": agree,
        "agreement_queries": int(erows.shape[0]),
    })
    for k, a in agree.items():
        if a < 0.99:
            raise AssertionError(f"fused staged-vs-exact agreement@{k} = {a} "
                                 "< 0.99")
    return launches


def phase_timing(searcher, batch, launches, errs, torch):
    """Kernel, plain and bound times at the main path's first-batch shapes
    (K3 at the fused path's, which are the same queries and planes)."""
    from dhr_tpu_torch.ops.gip_candidates import (
        candidates_plan, gip_candidates, gip_candidates_plain)
    from dhr_tpu_torch.ops.partial_gip import (
        partial_gip, partial_gip_plain, select_important, staging_plan)
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip, rerank_gip_plain

    idx = searcher.index
    qvb, qv1b, qib, cand = batch
    B, N, D, lex = qvb.shape[0], idx.num_rows, idx.dim, idx.lex_dim
    torch.cuda.empty_cache()

    imp = select_important(qv1b, qib, 48)
    vt, it = idx.values_T, idx.indices_T
    out_dt = torch.bfloat16
    # the kernel's time with its plan made beforehand, and the plan's own
    # (device work and the host's one read of |U|, per call)
    make_plan = lambda: staging_plan(  # noqa: E731
        *imp, D, lex, vt.element_size(), it.element_size())
    plan = make_plan()
    k1 = lambda: partial_gip(*imp, vt, it, lex, out_dt, plan=plan)  # noqa: E731
    k1_plain = lambda: partial_gip_plain(*imp, vt, it, lex, out_dt)  # noqa: E731
    k1_ms = cuda_ms(k1, 5, torch)
    k1_with_plan_ms = cuda_ms(
        lambda: partial_gip(*imp, vt, it, lex, out_dt), 5, torch)
    plan_ms = cuda_ms(make_plan, 5, torch)
    k1_plain_ms = cuda_ms(k1_plain, 1, torch)
    got, want = k1(), k1_plain()
    if not torch.equal(got, want):
        raise AssertionError("partial_gip main path: not bit-equal")
    k1_err = check_close("partial_gip main path", got, want, 0.0, torch)
    del got, want
    used = imp[0] != 0
    dims = imp[1][used]
    union = torch.unique(dims)
    n_lex_union = int((union < lex).sum())
    nnz, nnz_lex = int(used.sum()), int((dims < lex).sum())
    v_b, i_b, o_b = vt.element_size(), it.element_size(), 2
    k1_bytes = (union.numel() * N * v_b + n_lex_union * N * i_b
                + B * N * o_b + imp[0].numel() * 12)
    k1_stream_bytes = nnz * N * v_b + nnz_lex * N * i_b + B * N * o_b
    k1_ops = 2 * nnz * N
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS_PER_S)

    G = 8
    make_k3_plan = lambda: candidates_plan(  # noqa: E731
        *imp, D, lex, vt.element_size(), it.element_size())
    k3_plan = make_k3_plan()
    k3 = lambda: gip_candidates(*imp, vt, it, lex, G, True, plan=k3_plan)  # noqa: E731
    k3_plain = lambda: gip_candidates_plain(*imp, vt, it, lex, G, True)  # noqa: E731
    k3_ms = cuda_ms(k3, 5, torch)
    k3_with_plan_ms = cuda_ms(
        lambda: gip_candidates(*imp, vt, it, lex, G, True), 5, torch)
    k3_plan_ms = cuda_ms(make_k3_plan, 5, torch)
    k3_plain_ms = cuda_ms(k3_plain, 1, torch)
    got, want = k3(), k3_plain()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("gip_candidates main path: packed plane differs")
    k3_err = check_close("gip_candidates main path", got, want, 0.0, torch)
    del got, want
    P = -(-N // (128 * G)) * 128
    k3_bytes = k1_bytes - B * N * o_b + B * P * 4
    k3_stream_bytes = k1_stream_bytes - B * N * o_b + B * P * 4
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS_PER_S)

    vals, ind = idx.values, idx.indices
    k2 = lambda: rerank_gip(qvb, qib, cand, vals, ind, lex)  # noqa: E731
    k2_plain = lambda: rerank_gip_plain(qvb, qib, cand, vals, ind, lex)  # noqa: E731
    k2_ms = cuda_ms(k2, 5, torch)
    k2_plain_ms = cuda_ms(k2_plain, 1, torch)
    k2_err = check_close("rerank_gip main path", k2(), k2_plain(), 1e-4,
                         torch)
    K = cand.shape[1]
    n_unique = torch.unique(cand).numel()
    row_bytes = D * vals.element_size() + lex * ind.element_size()
    k2_bytes = n_unique * row_bytes + B * K * (8 + 4) + B * (D + D) * 4
    k2_ops = 2 * B * K * D
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_FLOPS_PER_S)

    def by(nbytes, ops):
        return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS_PER_S
                else "operations")

    emit({"phase": "kernel_shapes",
          "partial_gip": {"B": B, "N": N, "I": 48, "nonzero_imp": nnz,
                          "distinct_dims": union.numel(),
                          "plan_tile": plan.chunks[0].tile,
                          "plan_ms": plan_ms,
                          "ms_with_plan": k1_with_plan_ms,
                          "plan_staged_dims": [c.dims.numel()
                                               for c in plan.chunks],
                          "plan_chunks": len(plan.chunks),
                          "bytes_each_input_once": k1_bytes,
                          "bytes_per_query_streams": k1_stream_bytes,
                          "stream_bound_ms": k1_stream_bytes
                          / HBM_BYTES_PER_S * 1e3},
          "gip_candidates": {"B": B, "N": N, "G": G, "reduced_lanes": P,
                             "plan_tile": k3_plan.chunks[0].tile,
                             "plan_chunks": len(k3_plan.chunks),
                             "plan_ms": k3_plan_ms,
                             "ms_with_plan": k3_with_plan_ms,
                             "bytes_each_input_once": k3_bytes,
                             "bytes_per_query_streams": k3_stream_bytes,
                             "stream_bound_ms": k3_stream_bytes
                             / HBM_BYTES_PER_S * 1e3},
          "rerank_gip": {"B": B, "K": K, "D": D, "lex": lex,
                         "distinct_rows": n_unique,
                         "bytes_each_input_once": k2_bytes,
                         "bytes_per_query_rows": B * K * row_bytes}})
    return [
        {"name": "partial_gip", "route": "cuda", "source": K1_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_gip.py:115",
         "launches": launches["partial_gip"],
         "max_abs_err": max(errs[0], k1_err), "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound * 1e3,
         "bound_by": by(k1_bytes, k1_ops), "library_ms": None},
        {"name": "rerank_gip", "route": "cuda", "source": K2_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_rerank.py:81",
         "launches": launches["rerank_gip"],
         "max_abs_err": max(errs[1], k2_err), "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound * 1e3,
         "bound_by": by(k2_bytes, k2_ops), "library_ms": None},
        {"name": "gip_candidates", "route": "cuda", "source": K3_SOURCE,
         "replaces": "dhr_tpu/ops/pallas_gip.py:346",
         "launches": launches["gip_candidates"],
         "max_abs_err": max(errs[2], k3_err), "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound * 1e3,
         "bound_by": by(k3_bytes, k1_ops), "library_ms": None},
    ]


# --------------------------------------------------------------------------
# densify_path: an existing sparse model's vectors (BM25) -> DLR planes
# --------------------------------------------------------------------------


def _zipf_ranks(rng, n, vocab, np):
    """``n`` word ranks in [0, vocab), P(r) proportional to 1 / (r + 1)."""
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1))
    return np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1]),
                      vocab - 1)


def _ranking_check(got_ids, got_s, want_ids, want_s, rel):
    """``(scores equal rank by rank within rel, ids exact, ids equal apart
    from order inside runs of scores within rel of each other)``; the run
    that reaches the cut is compared by its count only (which of its rows
    a top-k keeps is the ordering's choice)."""
    import numpy as np

    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    if got_s.shape != want_s.shape or not np.allclose(got_s, want_s,
                                                      rtol=rel, atol=0):
        return False, False, False
    exact = list(got_ids) == list(want_ids)
    n, start, ties = len(want_s), 0, True
    for i in range(1, n + 1):
        if i == n or abs(want_s[i] - want_s[start]) > rel * abs(
                want_s[start]):
            if i < n and set(got_ids[start:i]) != set(want_ids[start:i]):
                ties = False
            start = i
    return True, exact, ties


def _compare_runs(got, want, qids, rel):
    """``_ranking_check`` counted over ``qids`` of two runs ``{qid:
    [(docid, score), ...]}``."""
    checks = [_ranking_check([d for d, _ in got[q]], [s for _, s in got[q]],
                             [d for d, _ in want[q]], [s for _, s in want[q]],
                             rel) for q in qids]
    return {"queries": len(qids), "rel_tol": rel,
            "scores_equal": sum(c[0] for c in checks),
            "ids_exact": sum(c[1] for c in checks),
            "ids_equal_up_to_ties": sum(c[2] for c in checks)}


def phase_densify_path(args, root, torch):
    """The DLR paper's BM25 -> DLR path on the port's C++ host runtime:
    synthetic whole-word passages (Zipf words over 2^18 terms, MS MARCO
    lengths) analyzed by ``simple_analyzer``, a ``TermDictionary``, BM25 by
    ``native.bm25_csr``, the vectors as JSONL, then the CLI: ``densify
    --weight-model bm25`` (int16 folds) -> ``index --quantize`` ->
    ``search`` with 1,024 BM25 queries (``densify_query_rows``) on K1 and
    K2, against the brute force on the same planes and against the CPU's
    plain path on 8 queries.  Returns the files ``serve_path`` serves and
    the launches of the search."""
    import numpy as np

    from dhr_tpu_torch import native
    from dhr_tpu_torch.densify_offline import (
        BM25Vectorizer, DensifyConfig, TermDictionary, bm25_query_vectors,
        densify_query_rows, simple_analyzer)
    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)

    if not native.available():
        raise AssertionError("the C++ host runtime did not build (g++ of "
                             "dhr_tpu_torch/native_src/dhr_native.cpp)")
    so = native.so_path()
    checkout = os.path.dirname(os.path.abspath(__file__))
    if not so.startswith(checkout):
        raise AssertionError(f"native runtime loaded from {so}")
    rng = np.random.default_rng(args.seed + 7)
    n, secs = DENSIFY_PASSAGES, {}
    t = time.perf_counter()
    words = np.asarray([f"w{r:x}" for r in range(DENSIFY_VOCAB)])
    lens = np.clip(rng.lognormal(np.log(50.0), 0.45, n), 8, 200).astype(int)
    flat = words[_zipf_ranks(rng, int(lens.sum()), DENSIFY_VOCAB, np)]
    texts = [" ".join(w).capitalize() + "."
             for w in np.split(flat, np.cumsum(lens)[:-1])]
    del flat

    terms = [simple_analyzer(x) for x in texts]
    dic = TermDictionary()
    for ts in terms:
        dic.add_document(ts)
    dic.build(reserve=DensifyConfig(model="bm25").omission)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(ts) for ts in terms], out=offsets[1:])
    tokens = np.fromiter((dic.term_id(w) for ts in terms for w in ts),
                         np.int32, int(offsets[-1]))
    tids, ws, off, _ = native.bm25_csr(tokens, offsets, dic.vocab_size)
    vec = BM25Vectorizer(dic)
    for d in range(4):  # the C++ weights are the Python vectorizer's
        want = vec.doc_vector(terms[d])
        got = dict(zip(tids[off[d]:off[d + 1]].tolist(),
                       ws[off[d]:off[d + 1]].tolist()))
        if sorted(got) != sorted(want) or not np.allclose(
                [got[k] for k in want], list(want.values()), rtol=1e-6):
            raise AssertionError(f"bm25_csr differs from BM25Vectorizer "
                                 f"on passage {d}")
    del terms
    cfg = DensifyConfig(model="bm25")
    vocab = cfg.padded_vocab(dic.vocab_size)
    _, folds, collisions = native.densify_csr(tids, ws, off, cfg.omission,
                                              cfg.out_dim, vocab)

    vec_path = f"{root}/bm25_vectors.jsonl"
    with open(vec_path, "w") as f:
        for d in range(n):
            a, b = off[d], off[d + 1]
            f.write('{"id": "p%d", "vector": {%s}}\n' % (d, ", ".join(
                '"%d": %.6g' % tw for tw in zip(tids[a:b].tolist(),
                                                ws[a:b].tolist()))))
    del tokens, tids, ws, off
    secs["host_bm25_to_jsonl"] = time.perf_counter() - t

    t = time.perf_counter()
    dens, idx = f"{root}/densified.npz", f"{root}/densified_int8.npz"
    t_dens = _run_cli(["densify", "--input", vec_path, "--output", dens,
                       "--weight-model", "bm25", "--vocab-size",
                       str(dic.vocab_size)], "densify")
    _run_cli(["index", "--inputs", dens, "--output", idx, "--quantize"])
    packed = PackedIndex.load(idx)
    if (packed.indices.dtype != np.int16 or packed.values.dtype != np.int8
            or packed.values.shape != (n, LEX_DIM)
            or packed.lex_dim != LEX_DIM):
        raise AssertionError(f"densified index planes {packed.values.dtype}"
                             f" {packed.values.shape} / "
                             f"{packed.indices.dtype}")
    max_fold = int(packed.indices.max())
    if not 127 < max_fold < (vocab - cfg.omission) // LEX_DIM:
        raise AssertionError(f"max fold {max_fold}: expected int16 folds")
    if t_dens["collisions"] != collisions or not np.array_equal(
            packed.indices, folds):
        raise AssertionError("the densify verb's folds or collisions differ "
                             "from native.densify_csr's")
    del folds
    half = f"{root}/densified_half.npz"
    packed.slice_rows(0, n // 2).save(half)

    qrng = np.random.default_rng(args.seed + 8)
    q_lens = qrng.integers(2, 9, DENSIFY_QUERIES)
    q_words = words[(_zipf_ranks(qrng, int(q_lens.sum()), DENSIFY_VOCAB, np)
                     + 50) % DENSIFY_VOCAB]
    q_texts = [" ".join(w) for w in np.split(q_words,
                                             np.cumsum(q_lens)[:-1])]
    qv, qi, qids = densify_query_rows(bm25_query_vectors(
        [(f"q{i}", x) for i, x in enumerate(q_texts)], vec), cfg,
        dic.vocab_size)
    q_path = f"{root}/bm25_queries.npz"
    np.savez(q_path, values=qv, indices=qi)
    with open(q_path + ".qids.json", "w") as f:
        json.dump(qids, f)
    np.savez(f"{root}/q8.npz", values=qv[:8].astype(np.float32),
             indices=qi[:8].astype(np.int32))
    with open(f"{root}/q8.qids.json", "w") as f:
        json.dump(qids[:8], f)

    search = ["search", "--index-path", idx, "--query-path", q_path,
              "--topk", "1000", "--query-batch", "128"]
    reset_launches()
    _run_cli([*search, *DENSIFY_SEARCH, "--output", f"{root}/bm25.trec"],
             "search")
    launches = read_launches()
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"densify path launches {launches}: K1 and K2 "
                             "must launch on the int16 planes")
    _run_cli([*search, "--brute-force", "--exact-candidates",
              "--no-candidate-bf16", "--output", f"{root}/bm25_exact.trec"],
             "search")
    run = _read_run(f"{root}/bm25.trec")
    exact = _read_run(f"{root}/bm25_exact.trec")
    if len(run) != DENSIFY_QUERIES or any(
            len(r) != 1000 or not np.isfinite([s for _, s in r]).all()
            for r in run.values()):
        raise AssertionError("the BM25 run lacks queries, rows or finite "
                             "scores")
    vs_exact = _compare_runs(run, exact, qids, 1e-5)
    vs_exact["agreement_informative_only"] = agreement(
        [np.array([d for d, _ in run[q]]) for q in qids],
        [np.array([d for d, _ in exact[q]]) for q in qids])

    cpu = Searcher(DeviceIndex.from_packed(packed, device="cpu"),
                   SearchConfig(topk=1000, theta=0.1, rerank=True,
                                agip_topk=10000, query_batch=128),
                   device="cpu")
    r8, s8 = cpu.search_run(qids[:8], qv[:8], qi[:8])
    vs_cpu = _compare_runs(run, {q: list(zip(r8[q], s8[q])) for q in r8},
                           qids[:8], 1e-5)
    del cpu
    secs["cli_and_checks"] = time.perf_counter() - t
    emit({"phase": "densify_path", "passages": n,
          "words": int(lens.sum()), "passage_words_mean": float(lens.mean()),
          "vocab_terms": dic.vocab_size - cfg.omission,
          "padded_vocab": vocab, "max_fold": max_fold,
          "fold_dtype": str(packed.indices.dtype),
          "slice_collisions": collisions,
          "native_so": so,
          "index_file_bytes": os.path.getsize(idx),
          "index_plane_bytes": packed.values.nbytes + packed.indices.nbytes,
          "queries": DENSIFY_QUERIES,
          "query_terms_mean": float((qv != 0).sum(axis=1).mean()),
          "search_flags": DENSIFY_SEARCH, "launches": launches,
          "vs_brute_force": vs_exact, "vs_cpu_plain_8_queries": vs_cpu,
          "seconds": secs})
    if vs_exact["scores_equal"] != DENSIFY_QUERIES:
        raise AssertionError(f"staged vs brute force scores: {vs_exact}")
    if vs_cpu["scores_equal"] != 8 or vs_cpu["ids_equal_up_to_ties"] != 8:
        raise AssertionError(f"card vs CPU plain: {vs_cpu}")
    return {"index": idx, "half": half, "rows": n, "q8": f"{root}/q8.npz",
            "queries": (qv, qi, qids)}, launches


# --------------------------------------------------------------------------
# eval_path: ColBERT full ranking, rerank-eval and BEIR at DistilBERT-base
# --------------------------------------------------------------------------


def _colbert_config(dtype):
    from dhr_tpu_torch.models import EncoderConfig, RetrieverConfig

    return RetrieverConfig(
        model_type="colbert", add_pooler=True, projection_dim=128,
        encoder=dataclasses.replace(EncoderConfig.distilbert_base(),
                                    dtype=dtype))


def _rel_diff(got, want, torch):
    """max |got - want| over max |want| (f32)."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return float((got - want).abs().max() / want.abs().max())


def _colbert_card_vs_cpu(seed, toks, q_toks, torch):
    """f32 token reps of 8 passages (128) and 8 queries (32) on the card
    and on the CPU (the same random tree), and ``maxsim_listwise`` over
    each device's reps; within 1e-5 of scale."""
    from dhr_tpu_torch.data.collate import pad_token_batch
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.models.transformer import compute_copy
    from dhr_tpu_torch.retrieval.colbert import maxsim_listwise

    cfg = _colbert_config(torch.float32)
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(seed + 9)))
    sides = {"passage": (pad_token_batch([t.tolist() for t in toks[:8]],
                                         128, 0, 101, 102), False),
             "query": (pad_token_batch([t.tolist() for t in q_toks[:8]],
                                       32, 0, 101, 102), True)}
    reps = {}
    for dev in ("cpu", "cuda"):
        m = compute_copy(model, torch.float32, torch.device(dev)).eval()
        for role, (b, is_q) in sides.items():
            with torch.inference_mode():
                r = m.encoder_q(torch.from_numpy(b["input_ids"]).to(dev),
                                torch.from_numpy(b["attention_mask"]).to(dev),
                                is_query=is_q)
            reps[dev, role] = torch.cat([r.token_cls, r.token], 1)
        reps[dev, "maxsim"] = maxsim_listwise(reps[dev, "query"],
                                              reps[dev, "passage"])
        del m
    out = {k: _rel_diff(reps["cuda", k].cpu(), reps["cpu", k], torch)
           for k in ("passage", "query", "maxsim")}
    if max(out.values()) > 1e-5:
        raise AssertionError(f"colbert card vs CPU f32: {out}")
    return {"max_rel_diff_of_scale": out, "shapes": {
        k: list(reps["cpu", k].shape) for k in ("query", "passage",
                                                "maxsim")}}


def _colbert_path(root, toks, q_toks, seed, torch, np):
    """(a): ``encode --model colbert`` over encode_path's corpus and
    queries, ``colbert-score --full-ranking --topk 1000`` on the card, and
    its checks: the CPU's plain ``full_ranking`` on 4 queries, a run forced
    into host slabs (``--plane-budget-gb 0.25``) on 128 queries and
    ``colbert-score --pairs`` over 64 queries' retrieved pairs."""
    from dhr_tpu_torch.retrieval.colbert import full_ranking

    out = {"card_vs_cpu_f32": _colbert_card_vs_cpu(seed, toks, q_toks,
                                                   torch)}
    model = ["--model", "colbert", "--add-pooler", "--projection-dim", "128",
             "--batch-size", "256"]
    _run_cli(["encode", *model, "--input", f"{root}/corpus.jsonl",
              "--output", f"{root}/p_reps"], "encode")
    _run_cli(["encode", *model, "--input", f"{root}/queries.jsonl",
              "--output", f"{root}/q_reps", "--encode-is-qry"], "encode")
    with np.load(f"{root}/p_reps.npz") as z:
        p_reps = z["token"]
    with np.load(f"{root}/q_reps.npz") as z:
        q_reps = z["token"]
    if (p_reps.shape != (ENCODE_PASSAGES, 128, 128)
            or q_reps.shape != (ENCODE_QUERIES, 32, 128)
            or p_reps.dtype != np.float16 or q_reps.dtype != np.float16):
        raise AssertionError(f"token reps {p_reps.shape} {p_reps.dtype} / "
                             f"{q_reps.shape} {q_reps.dtype}")
    score = ["colbert-score", "--passage-reps", f"{root}/p_reps"]
    _run_cli([*score, "--query-reps", f"{root}/q_reps", "--full-ranking",
              "--topk", "1000", "--output", f"{root}/colbert.trec"],
             "colbert-score")
    run = _read_run(f"{root}/colbert.trec")
    qids = [f"q{i}" for i in range(ENCODE_QUERIES)]
    if sorted(run) != sorted(qids) or any(
            len(run[q]) != 1000
            or not np.isfinite([s for _, s in run[q]]).all() for q in qids):
        raise AssertionError("the ColBERT run lacks queries, rows or finite "
                             "scores")

    cpu_s, cpu_r = full_ranking(q_reps[:4], p_reps, topk=1000, device="cpu")
    cpu_run = {q: [(str(r), float(s)) for r, s in zip(rr, ss)]
               for q, rr, ss in zip(qids, cpu_r, cpu_s)}
    out["vs_cpu_plain_4_queries"] = _compare_runs(run, cpu_run, qids[:4],
                                                  1e-5)

    np.savez(f"{root}/q128.npz", token=q_reps[:128])
    with open(f"{root}/q128.npz.ids.json", "w") as f:
        json.dump(qids[:128], f)
    _run_cli([*score, "--query-reps", f"{root}/q128.npz", "--full-ranking",
              "--topk", "1000", "--plane-budget-gb", "0.25", "--output",
              f"{root}/slabs.trec"], "colbert-score")
    out["slabs_vs_resident_128_queries"] = _compare_runs(
        _read_run(f"{root}/slabs.trec"), run, qids[:128], 1e-6)

    with open(f"{root}/pairs.tsv", "w") as f:
        for q in qids[:64]:
            f.writelines(f"{q}\t{d}\n" for d, _ in run[q])
    _run_cli([*score, "--query-reps", f"{root}/q_reps", "--pairs",
              f"{root}/pairs.tsv", "--output", f"{root}/pairs_scores.tsv"],
             "colbert-score")
    with open(f"{root}/pairs_scores.tsv") as f:
        got = np.asarray([float(line.split("\t")[2]) for line in f])
    want = np.asarray([s for q in qids[:64] for _, s in run[q]])
    out["pairs_vs_run_64_queries"] = {
        "pairs": int(got.size),
        "max_rel_diff_of_scale": float(np.abs(got - want).max()
                                       / np.abs(want).max()),
        "max_rel_diff": float((np.abs(got - want) / np.abs(want)).max())}
    out.update({"passages": ENCODE_PASSAGES, "queries": ENCODE_QUERIES,
                "plane_gb": p_reps.nbytes / 1e9, "topk": 1000})
    vc = out["vs_cpu_plain_4_queries"]
    if vc["scores_equal"] != 4 or vc["ids_equal_up_to_ties"] != 4:
        raise AssertionError(f"ColBERT card vs CPU plain: {vc}")
    sv = out["slabs_vs_resident_128_queries"]
    if sv["scores_equal"] != 128 or sv["ids_exact"] != 128:
        raise AssertionError(f"ColBERT slabs vs resident: {sv}")
    if out["pairs_vs_run_64_queries"]["max_rel_diff_of_scale"] > 1e-6:
        raise AssertionError(f"colbert-score --pairs vs the run: "
                             f"{out['pairs_vs_run_64_queries']}")
    return out


def _rerank_eval_path(root, seed, toks, q_toks, torch, np):
    """(b): ``make_pair_scorer`` on the card against the CPU in f32 (dhr on
    32 pairs, colbert on 8), then the ``rerank-eval`` verb (DHR
    DistilBERT-base, bf16) over 16 queries x 1,000 candidates of the
    corpus, 1-3 of them relevant."""
    from dhr_tpu_torch.data.collate import pad_token_batch
    from dhr_tpu_torch.data.examples import write_jsonl
    from dhr_tpu_torch.eval.rerank import make_pair_scorer
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)

    out = {}
    for name, cfg, tree_seed, n in (
            ("dhr", _dhr_config(torch.float32), seed, 32),
            ("colbert", _colbert_config(torch.float32), seed + 9, 8)):
        model = load_flax_params(BiEncoder(cfg), random_flax_params(
            cfg, torch.Generator().manual_seed(tree_seed)))
        q = pad_token_batch([t.tolist() for t in q_toks[:n]], 32, 0, 101,
                            102)
        p = pad_token_batch([t.tolist() for t in toks[:n]], 128, 0, 101, 102)
        got = make_pair_scorer(model, cfg, ENCODE_REMOVE_DIMS,
                               device="cuda")(q, p).cpu()
        want = make_pair_scorer(model, cfg, ENCODE_REMOVE_DIMS,
                                device="cpu")(q, p)
        out[f"{name}_card_vs_cpu_f32_{n}_pairs"] = _rel_diff(got, want,
                                                             torch)
        del model
    if max(out.values()) > 1e-5:
        raise AssertionError(f"pair scorer card vs CPU f32: {out}")

    rng = np.random.default_rng(seed + 11)
    rows, n_rel = [], []
    for i in range(EVAL_RERANK_QUERIES):
        cand = rng.choice(ENCODE_PASSAGES, EVAL_RERANK_CANDIDATES,
                          replace=False)
        n_rel.append(int(rng.integers(1, 4)))
        rows.extend({"qry_text_id": f"q{i}", "qry_text": q_toks[i].tolist(),
                     "psg_text_id": str(d), "psg_text": toks[d].tolist(),
                     "rel": int(j < n_rel[-1])} for j, d in enumerate(cand))
    write_jsonl(f"{root}/rerank_eval.jsonl", rows)
    _, metrics = _run_cli([
        "rerank-eval", "--model", "dhr", "--add-pooler", "--projection-dim",
        "128", "--dlr-out-dim", str(LEX_DIM), "--batch-size", "256",
        "--input", f"{root}/rerank_eval.jsonl"], "rerank-eval", stdout=True)
    if metrics.get("num_queries") != EVAL_RERANK_QUERIES or not all(
            np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"rerank-eval metrics {metrics}")
    out.update({"queries": EVAL_RERANK_QUERIES,
                "candidates_per_query": EVAL_RERANK_CANDIDATES,
                "relevant_per_query_mean": float(np.mean(n_rel)),
                "pairs": len(rows), "batch": 256,
                "metrics_random_weights": metrics})
    return out


def _beir_dataset(root, seed, np):
    """A local BEIR directory shaped like SciFact (Thakur et al., 2021,
    Table 1): 5,183 titled documents of ~214 words (lognormal), 300 test
    queries of ~12 words, ~1.1 relevant documents a query in
    ``qrels/test.tsv`` (header row), numeric ids, and 10 queries whose id
    is a document's (the self-hit filter's case).  Words are Zipf over
    30,000 terms; each query takes half its words from a relevant
    document."""
    rng = np.random.default_rng(seed + 12)
    d = f"{root}/scifact_like"
    os.makedirs(f"{d}/qrels")
    words = np.asarray([f"w{r:x}" for r in range(30_000)])
    ids = rng.choice(10**7, BEIR_DOCS + BEIR_QUERIES, replace=False)
    doc_ids = [str(x) for x in ids[:BEIR_DOCS]]
    sigma = 0.5
    lens = np.clip(rng.lognormal(np.log(214.0) - sigma**2 / 2, sigma,
                                 BEIR_DOCS), 20, 1000).astype(int)
    texts = []
    with open(f"{d}/corpus.jsonl", "w") as f:
        for i, n in enumerate(lens):
            body = words[_zipf_ranks(rng, int(n), len(words), np)]
            title = words[_zipf_ranks(rng, int(rng.integers(6, 18)),
                                      len(words), np)]
            texts.append(body)
            f.write(json.dumps({"_id": doc_ids[i], "title": " ".join(title),
                                "text": " ".join(body)}) + "\n")
    q_ids = [str(x) for x in ids[BEIR_DOCS:]]
    selves = rng.choice(BEIR_DOCS, BEIR_SELF_HITS, replace=False)
    for j, s in enumerate(selves):
        q_ids[j] = doc_ids[s]
    qrels = []
    with open(f"{d}/queries.jsonl", "w") as f:
        for j, q in enumerate(q_ids):
            rel = [r for r in rng.choice(BEIR_DOCS, 1 + int(rng.random()
                                                            < 0.1),
                                         replace=False) if doc_ids[r] != q]
            rel = rel or [(int(selves[j]) + 1) % BEIR_DOCS]
            n = int(np.clip(rng.normal(12, 3), 4, 30))
            own = rng.choice(texts[rel[0]], n // 2)
            other = words[_zipf_ranks(rng, n - n // 2, len(words), np)]
            f.write(json.dumps({"_id": q, "text": " ".join(
                np.concatenate([own, other]))}) + "\n")
            qrels.extend((q, doc_ids[r]) for r in rel)
    with open(f"{d}/qrels/test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.writelines(f"{q}\t{doc}\t1\n" for q, doc in qrels)
    return d, {"documents": BEIR_DOCS, "doc_words_mean": float(lens.mean()),
               "queries": BEIR_QUERIES, "self_id_queries": BEIR_SELF_HITS,
               "relevant_per_query": len(qrels) / BEIR_QUERIES}


class _BeirCapture:
    """Records, inside ``with``, what ``evaluate_beir`` searched
    (``Searcher.search_run``: the index, queries and unfiltered results)
    and the run it scored (the argument of its ``ndcg_at_k``)."""

    def __enter__(self):
        from dhr_tpu_torch.eval import beir
        from dhr_tpu_torch.retrieval.searcher import Searcher

        self.search_run, self.ndcg = Searcher.search_run, beir.ndcg_at_k
        cap = self

        def search_run(searcher, qids, qv, qi=None):
            cap.searched = (searcher.index, qids, qv, qi)
            cap.results = cap.search_run(searcher, qids, qv, qi)
            return cap.results

        def ndcg(qrels, run, k=10):
            cap.run = run
            return cap.ndcg(qrels, run, k)

        Searcher.search_run, beir.ndcg_at_k = search_run, ndcg
        return self

    def __exit__(self, *exc):
        from dhr_tpu_torch.eval import beir
        from dhr_tpu_torch.retrieval.searcher import Searcher

        Searcher.search_run, beir.ndcg_at_k = self.search_run, self.ndcg


def _vs_exact(qids, results, scores, exact, docids, np, rel=1e-5):
    """A run ``{qid: [docid...]}, {qid: [score...]}`` against the exact
    scores ``(B, N)`` of its queries (in ``qids`` order), per query at a
    tolerance of ``rel`` times its largest exact score: each returned
    document's score equals its exact score, and rank by rank the exact
    score of the returned document equals the exact top-k's (the ranking
    equals the exact one up to ties, chains of near-ties included)."""
    k = min(1000, exact.shape[1])
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    best_s = np.take_along_axis(exact, order, axis=1)
    row = {str(d): r for r, d in enumerate(docids)}
    out = {"queries": len(qids), "rel_tol_of_scale": rel,
           "scores_match_exact": 0, "ranks_equal_up_to_ties": 0,
           "ids_exact": 0, "max_score_diff_of_scale": 0.0,
           "max_rank_diff_of_scale": 0.0}
    for b, q in enumerate(map(str, qids)):
        rows = np.asarray([row[d] for d in results[q]])
        got = np.asarray(scores[q], np.float32)
        scale = float(np.abs(best_s[b]).max())
        d_score = float(np.abs(got - exact[b, rows]).max()) / scale
        d_rank = float(np.abs(exact[b, rows] - best_s[b]).max()) / scale
        out["scores_match_exact"] += d_score <= rel
        out["ranks_equal_up_to_ties"] += (rows.size == k
                                          and d_rank <= rel)
        out["ids_exact"] += np.array_equal(rows, order[b])
        out["max_score_diff_of_scale"] = max(
            out["max_score_diff_of_scale"], d_score)
        out["max_rank_diff_of_scale"] = max(
            out["max_rank_diff_of_scale"], d_rank)
    return out


def _vs_brute_force(cap, torch, np, rel=1e-5):
    """The captured search's results against ``gip_scores_masked`` over the
    same device planes and queries (:func:`_vs_exact`)."""
    from dhr_tpu_torch.ops.gip import gip_scores_masked, pad_indices_for_cls

    index, qids, qv, qi = cap.searched
    cls = index.dim - index.lex_dim
    with torch.inference_mode():
        exact = gip_scores_masked(
            torch.as_tensor(qv, device=index.device).float(),
            pad_indices_for_cls(
                torch.as_tensor(qi, device=index.device).int(), cls),
            index.values, pad_indices_for_cls(index.indices, cls)).cpu()
    results, scores = cap.results
    return _vs_exact(qids, results, scores, exact.numpy(), index.docids, np,
                     rel)


def _beir_path(root, seed, torch, np):
    """(c): ``evaluate_beir`` (what the ``beir`` verb calls) over the
    SciFact-shaped directory with the DHR DistilBERT-base ``Encoder`` (bf16,
    batch 32, lengths 512 / 512, length bucketing) and the hashing word
    tokenizer: theta 0 (K1 over all 896 dims) and theta 0.3 with rerank
    (K1 + K2, a pool of every row), each against the brute force on the
    same planes.  Returns the report and the launches of both runs."""
    from dhr_tpu_torch.encode import EncodeConfig, Encoder
    from dhr_tpu_torch.eval.beir import evaluate_beir
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.retrieval.searcher import SearchConfig

    d, shape = _beir_dataset(root, seed, np)
    out = {"dataset": shape}
    cfg = _dhr_config(torch.bfloat16)
    enc = Encoder(load_flax_params(BiEncoder(cfg), random_flax_params(
        _dhr_config(torch.float32), torch.Generator().manual_seed(seed))),
        cfg, EncodeConfig(batch_size=32, remove_dims=ENCODE_REMOVE_DIMS))
    n_batches = -(-BEIR_QUERIES // 64)
    launches = {k: 0 for k in _counters()}
    for name, search in (
            ("theta0", SearchConfig(topk=1000, query_batch=64)),
            ("theta0.3_rerank", SearchConfig(topk=1000, theta=0.3,
                                             rerank=True, agip_topk=10000,
                                             query_batch=64))):
        reset_launches()
        with _BeirCapture() as cap:
            metrics = evaluate_beir(enc, search, d, HashTokenizer(),
                                    cls_id=101, sep_id=102,
                                    length_bucketing=True)
        got = read_launches()
        results, _ = cap.results
        vs = _vs_brute_force(cap, torch, np)
        self_after = sum(q in cap.run[q] for q in cap.run)
        out[name] = {"metrics_random_weights": metrics, "launches": got,
                     "self_hits_before_filter": sum(
                         q in results[q] for q in results),
                     "self_hits_after_filter": self_after,
                     "vs_brute_force": vs}
        want_k2 = n_batches if search.rerank else 0
        if got["partial_gip"] < n_batches or got["rerank_gip"] != want_k2 \
                or got["gip_candidates"]:
            raise AssertionError(f"BEIR {name} launches {got}: K1 >= "
                                 f"{n_batches}, K2 {want_k2}, K3 0")
        if self_after or metrics["num_queries"] != BEIR_QUERIES:
            raise AssertionError(f"BEIR {name}: {self_after} self-hits "
                                 f"after the filter, {metrics}")
        if vs["scores_match_exact"] != BEIR_QUERIES \
                or vs["ranks_equal_up_to_ties"] != BEIR_QUERIES:
            raise AssertionError(f"BEIR {name} vs brute force: {vs}")
        for k in launches:
            launches[k] += got[k]
    return out, launches


def phase_eval_path(args, root, torch):
    """The eval slice at DistilBERT-base width, random weights: (a) ColBERT
    full-ranking retrieval and ``colbert-score``; (b) ``rerank-eval``; (c)
    BEIR through ``evaluate_beir``.  Returns the K1 / K2 / K3 launches of
    (c), the part of the path that runs the kernels."""
    import numpy as np

    root = f"{root}/eval"
    os.makedirs(root)
    secs = {}
    t = time.perf_counter()
    _, _, toks, _, q_toks = _encode_corpus(root, args.seed, np)
    secs["write_corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    colbert = _colbert_path(root, toks, q_toks, args.seed, torch, np)
    secs["colbert"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rerank = _rerank_eval_path(root, args.seed, toks, q_toks, torch, np)
    secs["rerank_eval"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    beir, launches = _beir_path(root, args.seed, torch, np)
    secs["beir"] = time.perf_counter() - t
    emit({"phase": "eval_path", "model": "distilbert-base (6x768, vocab "
          "30522): ColBERT (projection 128) and DHR (768 + 128 dims)",
          "weights": f"random: seed {args.seed} (DHR), {args.seed + 9} "
          "(ColBERT card vs CPU), the CLI verbs' own seed 0",
          "colbert": colbert, "rerank_eval": rerank, "beir": beir,
          "launches": launches, "seconds": secs})
    _CLI_WEIGHTS.clear()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# family_path: dense, Aggretriever and DLR, with TCT and margin-KD training
# --------------------------------------------------------------------------

# the model flags of each variant: tools/pipeline_rehearsal.py:family_flags
# (dlr: dhr's flags with --model dlr)
FAMILY_VARIANTS = {
    "dense-cls": ["--model", "dense", "--pooling", "cls"],
    "dense-mean": ["--model", "dense", "--pooling", "mean"],
    "agg-full": ["--model", "agg", "--agg-dim", "640"],
    "agg-semi": ["--model", "agg", "--agg-dim", "640", "--semi-aggregate"],
    "agg-skip-mlm": ["--model", "agg", "--agg-dim", "640", "--skip-mlm"],
    "dlr": ["--model", "dlr", "--dlr-out-dim", str(LEX_DIM)],
}
FAMILY_COMMON = ["--add-pooler", "--projection-dim", "128"]
# the CLI chains and what each trains with: agg margin-KD from bin_pairs,
# dense the in-graph ColBERT teacher, dlr plain
FAMILY_CHAINS = {"dense-cls": "tct", "agg-full": "kd", "dlr": "plain"}
FAMILY_PASSAGES = 16_384       # encode_path's first passages
FAMILY_QUERIES = 1_024         # drawn from passages: the qrels
FAMILY_GROUPS = 1_024          # train groups (32 negatives, bin_pairs)
FAMILY_STEPS = 40              # the CLI runs (warmup 10), as train_path's
# the documented batch; lr 1e-4, the rehearsal's rate at this width: a
# random dlr model's lexical scores start near 0 (softmax over 30,522
# terms), and at 7e-6 its loss moves in the 7th digit in 40 steps
FAMILY_TRAIN_FLAGS = [*TRAIN_FLAGS, "--learning-rate", "1e-4"]
FAMILY_CHECKED = 4             # exact-run queries held on the CPU


def _family_world(root, seed, np):
    """encode_path's first 16,384 passages as a corpus, 1,024 train groups
    (each query's ids drawn from its positive passage, 32 negatives, and
    one bin set of (0, negative, margin) pairs for margin-KD) and 1,024
    eval queries drawn from a passage each (their qrels)."""
    from dhr_tpu_torch.data.examples import write_jsonl

    toks, _ = _passage_tokens(np.random.default_rng(seed + 4),
                              ENCODE_PASSAGES, np)
    toks = toks[:FAMILY_PASSAGES]
    rng = np.random.default_rng(seed + 14)
    paths = {k: f"{root}/{k}.jsonl" for k in ("corpus", "train", "queries")}
    paths["qrels"] = f"{root}/qrels.tsv"
    write_jsonl(paths["corpus"], ({"text_id": str(i), "text": t.tolist()}
                                  for i, t in enumerate(toks)))
    groups = []
    for _ in range(FAMILY_GROUPS):
        pos = int(rng.integers(FAMILY_PASSAGES))
        negs = rng.choice(FAMILY_PASSAGES - 1, TRAIN_NEGATIVES, replace=False)
        negs = negs + (negs >= pos)
        bins = [[[0, int(j), float(m)] for j, m in zip(
            rng.integers(TRAIN_NEGATIVES, size=4), rng.uniform(lo, lo + 3, 4))]
            for lo in (1.0, 4.0)]
        groups.append({
            "query": rng.choice(toks[pos], int(rng.integers(6, 31))).tolist(),
            "positive_pids": [str(pos)],
            "negative_pids": [str(int(n)) for n in negs],
            "bin_pairs": [bins]})
    write_jsonl(paths["train"], groups)
    rel = rng.choice(FAMILY_PASSAGES, FAMILY_QUERIES, replace=False)
    write_jsonl(paths["queries"], (
        {"text_id": f"q{i}", "text": rng.choice(
            toks[r], int(rng.integers(4, 21))).tolist()}
        for i, r in enumerate(rel)))
    with open(paths["qrels"], "w") as f:
        f.writelines(f"q{i}\t0\t{int(r)}\t1\n" for i, r in enumerate(rel))
    return paths, toks, groups


_CLI_WEIGHTS: dict = {}


def _family_model(variant, init, dtype, torch, dropout=True):
    """``(BiEncoder with the export's weights, its config in ``dtype``)``
    of a family variant (:func:`_cli_model`)."""
    return _cli_model([*FAMILY_VARIANTS[variant], *FAMILY_COMMON,
                       "--model-name-or-path", init], dtype, torch, dropout)


def _cli_model(flags, dtype, torch, dropout=True):
    """``(BiEncoder, its config in ``dtype``)`` of the model flags
    ``flags``: the weights come through the CLI's own loader
    (``_load_init_params``) once per set of flags; ``dropout=False`` zeroes
    both dropout rates."""
    from dhr_tpu_torch.cli.main import (
        _load_init_params, _model_cfg_from_args, build_parser)
    from dhr_tpu_torch.models import BiEncoder

    key = tuple(flags)
    if key not in _CLI_WEIGHTS:
        args = build_parser().parse_args(
            ["encode", *flags, "--input", "-", "--output", "-"])
        cfg = _model_cfg_from_args(args)
        _CLI_WEIGHTS[key] = (cfg, _load_init_params(args, cfg).state_dict())
    cfg, state = _CLI_WEIGHTS[key]
    enc = dataclasses.replace(cfg.encoder, dtype=dtype)
    if not dropout:
        enc = dataclasses.replace(enc, hidden_dropout=0.0,
                                  attention_dropout=0.0)
    cfg = dataclasses.replace(cfg, encoder=enc)
    model = BiEncoder(cfg)
    model.load_state_dict(state)
    return model, cfg


def _family_reps(model, cfg, batches, dev, torch):
    """The f32 reps a variant's planes come from, per side: dense its
    vector; agg its vocabulary rep, CLS projection and folded lanes (full:
    also the sign competition's two halves); dlr its vocabulary rep and
    densified values and folds."""
    from dhr_tpu_torch.models.transformer import compute_copy
    from dhr_tpu_torch.ops.aggregate import _fold_max, aggregate
    from dhr_tpu_torch.ops.densify import densify

    m = compute_copy(model, cfg.encoder.dtype, torch.device(dev)).eval()
    out = {}
    for side, (b, is_q) in batches.items():
        with torch.inference_mode():
            r = m.encoder_q(torch.from_numpy(b["input_ids"]).to(dev),
                            torch.from_numpy(b["attention_mask"]).to(dev),
                            is_query=is_q)
        if cfg.model_type == "dense":
            out[side] = {"dense": r.dense}
        elif cfg.model_type == "agg":
            out[side] = {"lexical": r.lexical, "semantic": r.semantic,
                         "lanes": aggregate(r.lexical, cfg.agg_dim,
                                            full=not cfg.semi_aggregate)}
            if not cfg.semi_aggregate:
                half = _fold_max(r.lexical, 2 * cfg.agg_dim)
                out[side].update(pos=half[..., 0::2], neg=half[..., 1::2])
        else:
            v, i = densify(r.lexical, cfg.dlr_out_dim, ENCODE_REMOVE_DIMS)
            out[side] = {"lexical": r.lexical, "values": v, "folds": i}
        out[side] = {k: t.float().cpu() for k, t in out[side].items()}
    del m
    return out


def _family_card_vs_cpu(variant, init, toks, q_toks, torch, np):
    """f32 reps of 8 passages x 128 and 8 queries x 32 on the card against
    the CPU (one weight set), each within 1e-3 of its scale; dlr's folds
    equal except at near ties (1e-5), agg-full's output lanes of the same
    sign except where |pos - neg| <= 1e-5 |pos| (counted); the card's bf16
    reps against its f32 reps (no bound).  agg-skip-mlm also backpropagates
    through its scatter-max on both sides (every gradient within 1e-3,
    relative L2)."""
    from dhr_tpu_torch.data.collate import pad_token_batch

    p_toks = [t.tolist() for t in toks[:8]]
    p_toks[0] = np.resize(toks[8], 126).tolist()  # a full row
    b_p = pad_token_batch(p_toks, 128, 0, 101, 102)
    b_q = pad_token_batch([t.tolist() for t in q_toks], 32, 0, 101, 102)
    batches = {"passage": (b_p, False), "query": (b_q, True)}
    reps = {}
    for name, dtype, dev in (("cpu_f32", torch.float32, "cpu"),
                             ("card_f32", torch.float32, "cuda"),
                             ("card_bf16", torch.bfloat16, "cuda")):
        model, cfg = _family_model(variant, init, dtype, torch)
        reps[name] = _family_reps(model, cfg, batches, dev, torch)
    res = {"card_f32_vs_cpu_f32": {}, "card_bf16_vs_card_f32": {}}
    for key, got_name, want_name in (
            ("card_f32_vs_cpu_f32", "card_f32", "cpu_f32"),
            ("card_bf16_vs_card_f32", "card_bf16", "card_f32")):
        for side in batches:
            got, want = reps[got_name][side], reps[want_name][side]
            for k in want:
                if k in ("folds", "pos", "neg"):
                    continue
                g, w = got[k], want[k]
                if k == "lanes" and variant == "agg-full":
                    # a near tie of the sign competition may pick the other
                    # half: those lanes are counted below, not measured
                    keep = ~_sign_near_tie(want)
                    g, w = g[keep], w[keep]
                res[key][f"{side}.{k}"] = _rel_diff(g, w, torch)
            if variant == "agg-full":
                res[key][f"{side}.lanes_of_other_sign"] = int((torch.sign(
                    got["lanes"]) != torch.sign(want["lanes"])).sum())
    worst = max(v for k, v in res["card_f32_vs_cpu_f32"].items()
                if not k.endswith("_sign"))
    if worst > 1e-3:
        raise AssertionError(f"{variant} card vs CPU f32 reps: {res}")
    for side in batches:
        cpu, card = reps["cpu_f32"][side], reps["card_f32"][side]
        if "folds" in cpu:  # dlr
            folded = cpu["lexical"][:, ENCODE_REMOVE_DIMS:].reshape(
                cpu["lexical"].shape[0], -1, LEX_DIM)
            top2 = folded.topk(2, dim=1).values
            tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs()
            diff = card["folds"] != cpu["folds"]
            res[f"{side}.unequal_folds"] = int(diff.sum())
            res[f"{side}.unequal_folds_not_near_tie"] = int(
                (diff & ~tie).sum())
            if res[f"{side}.unequal_folds_not_near_tie"]:
                raise AssertionError(f"{variant} folds differ beyond near "
                                     f"ties: {res}")
        if variant == "agg-full":
            tie = _sign_near_tie(cpu)
            flip = torch.sign(card["lanes"]) != torch.sign(cpu["lanes"])
            res[f"{side}.sign_near_ties"] = int(tie.sum())
            res[f"{side}.sign_flips"] = int(flip.sum())
            res[f"{side}.sign_flips_not_near_tie"] = int((flip & ~tie).sum())
            if res[f"{side}.sign_flips_not_near_tie"]:
                raise AssertionError(f"agg-full lanes change sign beyond "
                                     f"near ties: {res}")
    if variant == "agg-skip-mlm":
        res["scatter_max_grad_rel_l2"] = _skip_mlm_grads(
            init, b_p, torch, np)
        if res["scatter_max_grad_rel_l2"] > 1e-3:
            raise AssertionError(f"skip-MLM backward, card vs CPU: {res}")
    return res


def _sign_near_tie(reps):
    """agg-full's output lanes whose two halves lie within 1e-5 of
    |pos|."""
    return (reps["pos"] - reps["neg"]).abs() <= 1e-5 * reps["pos"].abs()


def _skip_mlm_grads(init, b, torch, np):
    """The gradients of a fixed random projection of the skip-MLM vocabulary
    rep (its scatter-max, pads included), f32, dropout 0, on the card
    against the CPU: the largest relative L2 difference over the
    parameters (:func:`_grad_rel_diff`)."""
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b["input_ids"].shape[0], 30522)).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        model, _ = _family_model("agg-skip-mlm", init, torch.float32, torch,
                                 dropout=False)
        model = model.to(dev)
        lex = model.encoder_q(torch.from_numpy(b["input_ids"]).to(dev),
                              torch.from_numpy(b["attention_mask"]).to(dev)
                              ).lexical
        (lex * w.to(dev)).sum().backward()
        grads[dev] = _grads(model)
        del model
    if "encoder_q.term_weight.linear.weight" not in grads["cpu"]:
        raise AssertionError("skip-MLM: no term-weight gradient")
    return _grad_rel_diff(grads["cuda"], grads["cpu"])[0]


def _family_train_card_vs_cpu(variant, mode, init, teacher, corpus, groups,
                              torch):
    """One plain f32 step (dropout 0) at 4 queries x 4 passages on the card
    and on the CPU from the same weights: agg with its batch's margin-KD
    scores, dense with the in-graph ColBERT teacher, dlr plain.  Loss
    within 1e-4 and every gradient within 1e-3 (relative L2)."""
    from dhr_tpu_torch.cli.main import _build_teacher
    from dhr_tpu_torch.data import SamplingConfig, TrainLoader
    from dhr_tpu_torch.train.step import LossConfig, plain_loss, to_device

    batch = next(iter(TrainLoader(groups[:8], SamplingConfig(
        n_passages=4, q_max_len=32, p_max_len=128, seed=42, cls_id=101,
        sep_id=102), batch_size=4, corpus=corpus, kd=mode == "kd").epoch(0)))
    loss_cfg = LossConfig(n_passages=4, use_tct_teacher=mode == "tct")
    out = {}
    for dev in ("cpu", "cuda"):
        model, cfg = _family_model(variant, init, torch.float32, torch,
                                   dropout=False)
        model = model.to(dev).train()
        t = None
        if mode == "tct":  # what train --tct builds
            t = _build_teacher(argparse.Namespace(
                model_name_or_path=None, teacher_path=teacher), cfg)
            t = t.to(dev).eval()
        loss, _ = plain_loss(model, cfg, loss_cfg, to_device(batch, dev),
                             teacher=t)
        loss.backward()
        out[dev] = (loss.item(), _grads(model))
        del model, t
    torch.cuda.empty_cache()
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda"]
    l2, mx = _grad_rel_diff(g_card, g_cpu)
    res = {"mode": mode, "queries": 4, "passages": 16,
           "teacher_scores_in_batch": "teacher_scores" in batch,
           "loss_cpu": l_cpu, "loss_card": l_card,
           "loss_rel_diff": abs(l_card - l_cpu) / abs(l_cpu),
           "grad_rel_l2_diff": l2, "grad_max_rel_diff": mx}
    if (mode == "kd") != res["teacher_scores_in_batch"]:
        raise AssertionError(f"{variant}: margin-KD scores {res}")
    if not (res["loss_rel_diff"] < 1e-4 and l2 < 1e-3):
        raise AssertionError(f"{variant} train step, card vs CPU f32: {res}")
    return res


def _family_exact_vs_cpu(d, run_path, torch, np):
    """The card's exact run (``--IP``, or GIP at theta 0 for planes with
    folds: dlr, dhr) against the CPU's brute force over the same planes and
    queries, on the first queries, by :func:`_vs_exact`'s rule.  The IP
    brute force rounds both sides to bf16, the search's product (f32
    accumulation)."""
    from dhr_tpu_torch.ops.gip import gip_scores_masked, pad_indices_for_cls
    from dhr_tpu_torch.retrieval.index import PackedIndex

    pk = PackedIndex.load(f"{d}/index.npz")
    with np.load(f"{d}/q.npz") as z:
        qv = z["values"][:FAMILY_CHECKED].astype(np.float32)
        qi = z["indices"][:FAMILY_CHECKED].astype(np.int32) \
            if "indices" in z.files else None
    with open(f"{d}/q.npz.qids.json") as f:
        qids = json.load(f)[:FAMILY_CHECKED]
    with torch.inference_mode():
        if qi is not None:
            cls = pk.dim - pk.lex_dim
            exact = gip_scores_masked(
                torch.from_numpy(qv * pk.value_scales[None, :]),
                pad_indices_for_cls(torch.from_numpy(qi), cls),
                torch.from_numpy(pk.values).float(),
                pad_indices_for_cls(torch.from_numpy(pk.indices).int(), cls))
        else:
            exact = (torch.from_numpy(qv).bfloat16().float()
                     @ torch.from_numpy(pk.values.astype(np.float32))
                     .bfloat16().float().T)
    run = _read_run(run_path)
    return _vs_exact(qids, {q: [doc for doc, _ in run[q]] for q in qids},
                     {q: [s for _, s in run[q]] for q in qids},
                     exact.numpy(), pk.docids, np)


def _family_chain(root, variant, mode, init, teacher, paths, corpus, groups,
                  torch, np):
    """``train`` (the documented 24 x 8 bf16 run, 40 steps: agg with
    ``--kd``, dense with ``--tct --teacher-path``) -> ``encode`` (16,384
    passages and 1,024 queries, bf16, batch 256, bucketed) -> ``index``
    (dlr ``--quantize --lex-dim 768``) -> ``search`` (dense and agg
    ``--IP``; dlr theta 0.3 with rerank and theta 0, K1 and K2 launched)
    -> ``eval``; the eval-mode loss of the first 96 queries must fall, and
    the exact run must equal the CPU's brute force on 4 queries.  Returns
    the report and the launches: K4 in the encodes (the MLM families
    only), K1 / K2 / K3 in the searches."""
    from dhr_tpu_torch.data import SamplingConfig, TrainLoader
    from dhr_tpu_torch.train.step import LossConfig, plain_loss, to_device

    d = f"{root}/{variant}"
    flags = [*FAMILY_VARIANTS[variant], *FAMILY_COMMON]
    extra = {"kd": ["--kd"], "tct": ["--tct", "--teacher-path", teacher],
             "plain": []}[mode]
    _run_cli(["train", *flags, "--model-name-or-path", init, "--train-path",
              paths["train"], "--corpus-path", paths["corpus"],
              *FAMILY_TRAIN_FLAGS, *extra, "--warmup-steps", "10",
              "--max-steps", str(FAMILY_STEPS), "--save-steps",
              str(FAMILY_STEPS), "--log-steps", "1", "--metrics-path",
              f"{d}.jsonl", "--output-dir", d], "train")
    losses = _metrics_losses(f"{d}.jsonl")
    if len(losses) != FAMILY_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{variant} train: {losses}")
    # the loss the run trains with (margin-KD's from the batch), in eval
    # mode and f32, before and after
    loader = TrainLoader(groups, SamplingConfig(
        n_passages=8, q_max_len=32, p_max_len=128, seed=42, cls_id=101,
        sep_id=102), batch_size=24, corpus=corpus, kd=mode == "kd")
    batches = [to_device(b, "cuda") for b, _ in zip(loader.epoch(0),
                                                    range(4))]
    model, cfg = _family_model(variant, init, torch.float32, torch)
    model = model.cuda().eval()

    def eval_loss():  # the dense loss reads no teacher scores
        with torch.no_grad():
            return float(sum(plain_loss(model, cfg, LossConfig(), b)[0]
                             .item() for b in batches) / 4)

    before = eval_loss()
    snap = torch.load(f"{d}/step_{FAMILY_STEPS:08d}/state.pt",
                      map_location="cuda", weights_only=True)
    model.load_state_dict(snap["model"])
    after = eval_loss()
    del model, snap, batches
    torch.cuda.empty_cache()
    if not after < before:
        raise AssertionError(f"{variant}: the loss did not fall ({before} "
                             f"-> {after})")

    enc = ["encode", *flags, "--model-name-or-path", f"{d}/export", "--bf16",
           "--batch-size", "256"]
    reset_launches()
    _run_cli([*enc, "--input", paths["corpus"], "--length-bucketing",
              "--output", f"{d}/corpus.npz"], "encode")
    _run_cli([*enc, "--input", paths["queries"], "--output", f"{d}/q.npz",
              "--encode-is-qry"], "encode")
    launches = read_launches()   # K4 where the family has an MLM head
    if (launches["lexical_pool"] > 0) != (variant != "dense-cls"):
        raise AssertionError(f"{variant} encode launches {launches}")
    _run_cli(["index", "--inputs", f"{d}/corpus.npz", "--output",
              f"{d}/index.npz", *(["--quantize", "--lex-dim", str(LEX_DIM)]
                                  if variant == "dlr" else [])])
    with np.load(f"{d}/index.npz") as z:
        planes = {k: [list(z[k].shape), str(z[k].dtype)] for k in z.files
                  if k in ("values", "indices")}
    want_d = {"dense-cls": 128, "agg-full": 640 + 128, "dlr": LEX_DIM}
    if planes["values"][0] != [FAMILY_PASSAGES, want_d[variant]] or (
            ("indices" in planes) != (variant == "dlr")):
        raise AssertionError(f"{variant} index planes {planes}")
    search = ["search", "--index-path", f"{d}/index.npz", "--query-path",
              f"{d}/q.npz", "--topk", "1000", "--query-batch", "128"]
    runs = ({"exact": ["--theta", "0"],
             "staged": ["--theta", "0.3", "--rerank", "--agip-topk",
                        "10000"]} if variant == "dlr" else {"exact": ["--IP"]})
    out = {}
    for label, sflags in runs.items():
        reset_launches()
        _run_cli([*search, *sflags, "--output", f"{d}/{label}.trec"],
                 "search")
        got = read_launches()
        if variant == "dlr" and not (got["partial_gip"] > 0 and (
                got["rerank_gip"] > 0) == (label == "staged")):
            raise AssertionError(f"dlr {label} launches {got}: K1 > 0, K2 "
                                 "> 0 with rerank only")
        for k in launches:
            launches[k] += got[k]
        _, metrics = _run_cli(["eval", "--qrels", paths["qrels"], "--run",
                               f"{d}/{label}.trec"], stdout=True)
        out[label] = {"flags": sflags, "launches": got, "metrics": metrics}
    run = _read_run(f"{d}/exact.trec")
    if len(run) != FAMILY_QUERIES or any(
            len(r) != 1000 or not np.isfinite([s for _, s in r]).all()
            for r in run.values()):
        raise AssertionError(f"{variant}: the run lacks queries, rows or "
                             "finite scores")
    vs = _family_exact_vs_cpu(d, f"{d}/exact.trec", torch, np)
    if vs["scores_match_exact"] != FAMILY_CHECKED \
            or vs["ranks_equal_up_to_ties"] != FAMILY_CHECKED:
        raise AssertionError(f"{variant} exact run vs the CPU: {vs}")
    if variant == "dlr":
        staged, exact = _read_run(f"{d}/staged.trec"), run
        qids = sorted(exact)
        out["staged"]["agreement_vs_exact"] = agreement(
            [np.array([x for x, _ in staged[q]]) for q in qids],
            [np.array([x for x, _ in exact[q]]) for q in qids])
    return {"mode": mode, "steps": len(losses),
            "loss_first_last": [losses[0], losses[-1]],
            "eval_loss_first_96_queries": [before, after],
            "index_planes": planes, "search": out,
            "exact_vs_cpu_4_queries": vs}, launches


def phase_family_path(args, root, smi, torch):
    """The retriever families at DistilBERT-base width from one random tree
    (train_path's DHR tree, exported as an HF directory; each family loads
    what it uses of it): for each of dense-cls, dense-mean, agg-full,
    agg-semi, agg-skip-mlm and dlr, card against CPU f32 reps; one f32
    train step card against CPU for agg
    (margin-KD), dense (TCT, the ColBERT tree of eval_path's check as the
    teacher) and dlr; then the CLI chain train -> encode -> index ->
    search -> eval for dense-cls, agg-full and dlr.  Returns the chains'
    launches: K4 in their encodes, K1 / K2 / K3 in their searches."""
    import numpy as np

    from dhr_tpu_torch.data import Corpus
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint

    root = f"{root}/family"
    os.makedirs(root)
    secs = {}
    t = time.perf_counter()
    paths, toks, groups = _family_world(root, args.seed, np)
    q_toks = [np.random.default_rng(args.seed + 15).integers(
        ENCODE_REMOVE_DIMS, 30522, n) for n in (4, 9, 12, 17, 20, 25, 30, 30)]
    for name, cfg, seed in (("init", _dhr_config(torch.float32), args.seed),
                            ("teacher", _colbert_config(torch.float32),
                             args.seed + 9)):
        export_hf_checkpoint(f"{root}/{name}", load_flax_params(
            BiEncoder(cfg), random_flax_params(
                cfg, torch.Generator().manual_seed(seed))), cfg)
    init, teacher = f"{root}/init", f"{root}/teacher"
    secs["setup"] = time.perf_counter() - t
    t = time.perf_counter()
    parity = {v: _family_card_vs_cpu(v, init, toks, q_toks, torch, np)
              for v in FAMILY_VARIANTS}
    secs["card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    corpus = Corpus([str(i) for i in range(len(toks))],
                    [x.tolist() for x in toks])
    steps = {v: _family_train_card_vs_cpu(v, mode, init, teacher, corpus,
                                          groups, torch)
             for v, mode in FAMILY_CHAINS.items()}
    secs["train_steps_card_vs_cpu"] = time.perf_counter() - t
    chains, launches = {}, {k: 0 for k in _counters()}
    for variant, mode in FAMILY_CHAINS.items():
        t = time.perf_counter()
        chains[variant], got = _family_chain(root, variant, mode, init,
                                             teacher, paths, corpus, groups,
                                             torch, np)
        for k in launches:
            launches[k] += got[k]
        secs[f"chain_{variant}"] = time.perf_counter() - t
    emit({"phase": "family_path", "card": smi,
          "model": "distilbert-base (6x768, 12 heads, FFN 3072, vocab "
          "30522): dense (cls / mean, projection 128), agg (agg_dim 640: "
          "full, semi, skip-MLM; projection 128), dlr (768 lexical dims)",
          "weights": f"random: train_path's DHR tree (seed {args.seed}) as "
          f"an HF directory; teacher: ColBERT, seed {args.seed + 9}",
          "world": {"passages": FAMILY_PASSAGES, "queries": FAMILY_QUERIES,
                    "train_groups": FAMILY_GROUPS},
          "card_vs_cpu": parity, "train_step_card_vs_cpu_f32": steps,
          "chains": chains, "launches": launches, "seconds": secs})
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# bert_path: BERT-base towers with token types; untied, TASB-batched DHR and
# packed ColBERT training through the CLI chain
# --------------------------------------------------------------------------


TOKEN_TYPE_KEY = "bert.embeddings.token_type_embeddings.weight"


def _bert_config(dtype, untie=False):
    from dhr_tpu_torch.models import EncoderConfig

    return dataclasses.replace(
        _dhr_config(dtype), untie_encoder=untie,
        encoder=dataclasses.replace(EncoderConfig.bert_base(), dtype=dtype))


def _bert_setup(root, seed, torch, np):
    """family_path's world (16,384 passages, 1,024 queries, 1,024 train
    groups), TASB clusters (64 of 16 group indices, a permutation drawn
    from the seed), a random BERT-base DHR tree exported as a ``bert`` HF
    directory (the chains' init) and a random untied tree whose towers
    come from two other seeds."""
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.train.checkpoint import export_hf_checkpoint

    paths, toks, groups = _family_world(root, seed, np)
    perm = np.random.default_rng(seed + 16).permutation(FAMILY_GROUPS)
    clusters = [{"qidx": c.tolist()} for c in perm.reshape(BERT_CLUSTERS,
                                                           -1)]
    paths["clusters"] = f"{root}/clusters.jsonl"
    with open(paths["clusters"], "w") as f:
        f.writelines(json.dumps(c) + "\n" for c in clusters)
    cfg = _bert_config(torch.float32)

    def tree(s):
        return random_flax_params(cfg, torch.Generator().manual_seed(s))

    export_hf_checkpoint(f"{root}/init", load_flax_params(
        BiEncoder(cfg), tree(seed + 17)), cfg, arch="bert")
    untied = {"encoder_q": tree(seed + 18)["encoder_q"],
              "encoder_p": tree(seed + 19)["encoder_q"]}
    return paths, toks, groups, clusters, untied


def _bert_card_vs_cpu(init, untied, toks, q_toks, torch, np):
    """f32 reps of 8 passages x 128 and 8 queries x 32, each through its
    side's tower, on the card against the CPU: the tied init (through the
    CLI's loader) and the untied tree.  Lexical and CLS reps within 1e-3
    of their scale, folds equal except at near ties (1e-5); the untied
    towers' passage reps must differ."""
    from dhr_tpu_torch.data.collate import pad_token_batch
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.models.transformer import compute_copy
    from dhr_tpu_torch.ops.densify import densify

    p_toks = [t.tolist() for t in toks[:8]]
    p_toks[0] = np.resize(toks[8], 126).tolist()  # a full row
    sides = {"passage": pad_token_batch(p_toks, 128, 0, 101, 102),
             "query": pad_token_batch([t.tolist() for t in q_toks], 32, 0,
                                      101, 102)}
    models = {"tied": _cli_model([*BERT_DHR_FLAGS, "--model-name-or-path",
                                  init], torch.float32, torch)[0],
              "untied": load_flax_params(BiEncoder(_bert_config(
                  torch.float32, untie=True)), untied)}
    res = {}
    for name, model in models.items():
        # (side, tower): each side through its tower; untied, the passages
        # through the query tower too
        views = [("passage", "passage"), ("query", "query")] + (
            [("passage", "query")] if name == "untied" else [])
        reps = {}
        for dev in ("cpu", "cuda"):
            m = compute_copy(model, torch.float32, torch.device(dev)).eval()
            for side, tower in views:
                if dev == "cpu" and side != tower:
                    continue  # the towers' difference is read on the card
                ids, mask = (torch.from_numpy(sides[side][k]).to(dev)
                             for k in ("input_ids", "attention_mask"))
                with torch.inference_mode():
                    r = m.encoder(tower)(ids, mask, is_query=side == "query")
                reps[dev, side, tower] = (r.lexical.float().cpu(),
                                          r.semantic.float().cpu())
            del m
        out = {}
        for role in sides:
            (lex, sem), (w_lex, w_sem) = (reps["cuda", role, role],
                                          reps["cpu", role, role])
            folded = w_lex[:, ENCODE_REMOVE_DIMS:].reshape(
                w_lex.shape[0], -1, LEX_DIM)
            top2 = folded.topk(2, dim=1).values
            tie = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs()
            diff = (densify(lex, LEX_DIM, ENCODE_REMOVE_DIMS)[1]
                    != densify(w_lex, LEX_DIM, ENCODE_REMOVE_DIMS)[1])
            out[role] = {"lexical_max_rel_diff": _rel_diff(lex, w_lex, torch),
                         "cls_max_rel_diff": _rel_diff(sem, w_sem, torch),
                         "unequal_folds": int(diff.sum()),
                         "unequal_folds_not_near_tie": int(
                             (diff & ~tie).sum())}
            if (max(out[role]["lexical_max_rel_diff"],
                    out[role]["cls_max_rel_diff"]) > 1e-3
                    or out[role]["unequal_folds_not_near_tie"]):
                raise AssertionError(f"bert {name} {role} reps, card vs "
                                     f"CPU f32: {out}")
        if name == "untied":
            out["passage_rel_diff_query_vs_passage_tower"] = _rel_diff(
                reps["cuda", "passage", "query"][0],
                reps["cuda", "passage", "passage"][0], torch)
            if not out["passage_rel_diff_query_vs_passage_tower"] > 1e-2:
                raise AssertionError(f"bert untied towers agree: {out}")
        res[name] = out
    del models
    return res


def _bert_batch(groups, corpus, torch, **kw):
    """The first batch of ``BERT_STEP_BATCH`` queries x 4 passages (32 /
    128 tokens, specials 101 / 102) of a loader over ``groups``."""
    from dhr_tpu_torch.data import SamplingConfig, TrainLoader

    return next(iter(TrainLoader(groups, SamplingConfig(
        n_passages=4, q_max_len=32, p_max_len=128, seed=42, cls_id=101,
        sep_id=102), batch_size=BERT_STEP_BATCH, corpus=corpus,
        **kw).epoch(0)))


def _grads_vs_f64(got, want, ref):
    """f32 gradients ``got`` (the card's) against ``want`` (the CPU's, or
    the plain step's), each tensor within family_path's bar (1e-3,
    relative L2) widened by four times ``want``'s own distance from the
    f64 step's ``ref``.  Where f32 resolves a gradient that is the family
    bar; where its sums cancel to their rounding the rounding sets the bar
    (an untied passage tower's pooler bias has a gradient of exactly 0:
    each query's in-batch softmax is blind to a shift shared by every
    passage; its last LayerNorm bias keeps only a small lexical share).
    The attention-key biases are left out (:func:`_grad_rel_diff`)."""
    res = {"tensors": 0, "within_1e-4_of_f64": 0, "grad_rel_l2_diff_max":
           0.0, "worst_of_bar": {}}
    ratio = {}
    for n, r in ref.items():
        if "attention.key.bias" in n or not r.abs().max() > 0:
            continue
        res["tensors"] += 1
        e_want = float((want[n].double() - r).norm() / r.norm())
        d = float((got[n] - want[n]).norm() / want[n].norm())
        res["within_1e-4_of_f64"] += e_want <= 1e-4
        res["grad_rel_l2_diff_max"] = max(res["grad_rel_l2_diff_max"], d)
        ratio[n] = (d / (1e-3 + 4 * e_want), d, e_want)
    for n, (q, d, e) in sorted(ratio.items(), key=lambda kv: -kv[1][0])[:3]:
        res["worst_of_bar"][n] = {"diff_over_bar": q, "diff": d,
                                  "want_vs_f64": e}
    if max(q for q, _, _ in ratio.values()) >= 1.0:
        raise AssertionError(f"gradients: {res}")
    return res


def _bert_steps_card_vs_cpu(init, untied, clusters, corpus, groups, torch):
    """Steps at 4 queries x 4 passages, dropout 0: the untied tree's plain
    step on the first TASB batch and a ColBERT model's (the init's encoder
    and pooler) packed step, each in f32 on the card against the CPU, and
    the packed step against the plain one on the card.  The loss within
    1e-4 of max(|loss|, 1) and the gradients by :func:`_grads_vs_f64`,
    with the same step in f64 on the card as the reference.  ColBERT's
    MaxSim scores (a sum over 32 query tokens) saturate its softmax at
    random weights, so the f32 gradient of its loss is rounding; its
    gradients are those of a fixed random projection of the step's scores
    (the same graph below the softmax), and the scores are held within
    1e-4 of their scale."""
    from dhr_tpu_torch.data import TASBSampler
    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.train.step import (
        LossConfig, packed_loss, plain_loss, to_device)

    loss_cfg = LossConfig(n_passages=4)
    tasb = TASBSampler(clusters, seed=42)
    batches = {"untied_plain": _bert_batch(groups, corpus, torch, tasb=tasb),
               "colbert_plain": _bert_batch(groups, corpus, torch),
               "colbert_packed": _bert_batch(groups, corpus, torch,
                                             pack_passages=True)}
    colbert_flags = [*BERT_COLBERT_FLAGS, "--model-name-or-path", init]
    runs = {}
    for name, dev, dtype in (
            ("untied_plain", "cpu", torch.float32),
            ("untied_plain", "cuda", torch.float32),
            ("untied_plain", "cuda", torch.float64),
            ("colbert_packed", "cpu", torch.float32),
            ("colbert_packed", "cuda", torch.float32),
            ("colbert_plain", "cuda", torch.float32),
            ("colbert_plain", "cuda", torch.float64)):
        if name == "untied_plain":
            cfg = _bert_config(dtype, untie=True)
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, hidden_dropout=0.0, attention_dropout=0.0))
            model = load_flax_params(BiEncoder(cfg), untied)
        else:
            model, cfg = _cli_model(colbert_flags, dtype, torch,
                                    dropout=False)
        fn = packed_loss if name == "colbert_packed" else plain_loss
        model = model.to(dev, dtype).train()
        loss, scores = fn(model, cfg, loss_cfg, to_device(batches[name],
                                                          dev))
        if name == "untied_plain":
            loss.backward()
        else:
            w = torch.randn(scores.shape, generator=torch.Generator()
                            .manual_seed(7), dtype=torch.float64)
            (scores.to(dtype) * w.to(dev, dtype)).sum().backward()
        runs[name, dev, dtype] = (loss.item(), {
            n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None}, scores.detach().double().cpu())
        del model
    torch.cuda.empty_cache()
    f32, f64 = torch.float32, torch.float64
    res = {"tasb_first_batch_indices": tasb.batch_indices(
               0, BERT_STEP_BATCH),
           "packed_rows": int(batches["colbert_packed"]["packed_passage"]
                              ["input_ids"].shape[0])}
    for label, got, want, ref in (
            ("untied_tasb_card_vs_cpu", ("untied_plain", "cuda", f32),
             ("untied_plain", "cpu", f32), ("untied_plain", "cuda", f64)),
            ("colbert_packed_card_vs_cpu", ("colbert_packed", "cuda", f32),
             ("colbert_packed", "cpu", f32), ("colbert_plain", "cuda", f64)),
            ("colbert_packed_vs_plain_card", ("colbert_packed", "cuda", f32),
             ("colbert_plain", "cuda", f32),
             ("colbert_plain", "cuda", f64))):
        (l_got, g_got, s_got), (l_want, g_want, s_want) = runs[got], \
            runs[want]
        res[label] = {"loss": l_got, "loss_want": l_want,
                      "loss_f64": runs[ref][0],
                      "loss_diff_of_max_1": abs(l_got - l_want)
                      / max(abs(l_want), 1.0),
                      "scores_max_rel_diff": _rel_diff(s_got, s_want, torch)}
        if not (res[label]["loss_diff_of_max_1"] < 1e-4
                and res[label]["scores_max_rel_diff"] < 1e-4):
            raise AssertionError(f"bert {label}: {res}")
        try:
            res[label]["grads"] = _grads_vs_f64(g_got, g_want, runs[ref][1])
        except AssertionError as e:
            raise AssertionError(f"bert {label}: {e}") from e
    towers = {n.split(".")[0] for n in runs["untied_plain", "cpu", f32][1]}
    if towers != {"encoder_q", "encoder_p"}:
        raise AssertionError(f"bert untied step: gradients of {towers}")
    return res


def _bert_train(d, flags, init, paths, extra, torch, np):
    """``train`` (the documented 24 x 8 bf16 batch, lr 1e-4, 40 steps,
    warmup 10) from ``init`` through the CLI: the per-step losses, each
    finite."""
    torch.cuda.empty_cache()
    _run_cli(["train", *flags, "--model-name-or-path", init, "--train-path",
              paths["train"], "--corpus-path", paths["corpus"],
              *FAMILY_TRAIN_FLAGS, *extra, "--warmup-steps", "10",
              "--max-steps", str(BERT_STEPS), "--log-steps", "1",
              "--metrics-path", f"{d}.jsonl", "--output-dir", d], "train")
    losses = _metrics_losses(f"{d}.jsonl")
    if len(losses) != BERT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"bert train {flags}: {losses}")
    return losses


def _bert_eval_loss(d, flags, init, groups, corpus, torch):
    """The f32 eval-mode loss of the first 96 queries (4 plain batches of
    24 x 8) before and after the run at ``d``; it must fall."""
    from dhr_tpu_torch.data import SamplingConfig, TrainLoader
    from dhr_tpu_torch.train.step import LossConfig, plain_loss, to_device

    loader = TrainLoader(groups, SamplingConfig(
        n_passages=8, q_max_len=32, p_max_len=128, seed=42, cls_id=101,
        sep_id=102), batch_size=24, corpus=corpus)
    batches = [to_device(b, "cuda") for b, _ in zip(loader.epoch(0),
                                                    range(4))]
    model, cfg = _cli_model([*flags, "--model-name-or-path", init],
                            torch.float32, torch)
    model = model.cuda().eval()

    def eval_loss():
        with torch.no_grad():
            return float(sum(plain_loss(model, cfg, LossConfig(), b)[0]
                             .item() for b in batches) / 4)

    before = eval_loss()
    snap = torch.load(f"{d}/step_{BERT_STEPS:08d}/state.pt",
                      map_location="cuda", weights_only=True)
    model.load_state_dict(snap["model"])
    after = eval_loss()
    del model, snap, batches
    torch.cuda.empty_cache()
    if not after < before:
        raise AssertionError(f"bert {flags}: the loss did not fall "
                             f"({before} -> {after})")
    return [before, after]


def _bert_dhr_chain(root, init, paths, corpus, groups, torch, np):
    """``train --untie-encoder --query-cluster-path`` (TASB batches) ->
    ``encode`` (16,384 passages by the passage tower, bucketed, and 1,024
    queries by the query tower) -> ``index --quantize`` -> ``search`` at
    theta 0 (K1) and at theta 0.3 with rerank (K1 + K2) -> ``eval``.  The
    export must hold both towers with token types; the exact run must
    equal the CPU's brute force on 4 queries.  Returns the report and the
    chain's launches (K4 in the encodes, K1 / K2 / K3 in the searches)."""
    from dhr_tpu_torch.models.hf_io import load_hf_state_dict

    d = f"{root}/dhr"
    flags = [*BERT_DHR_FLAGS, "--untie-encoder"]
    losses = _bert_train(d, flags, init, paths, ["--query-cluster-path",
                                                 paths["clusters"]], torch, np)
    eval_loss = _bert_eval_loss(d, flags, init, groups, corpus, torch)
    export = f"{d}/export"
    layout = {tower: TOKEN_TYPE_KEY in load_hf_state_dict(
        f"{export}/{tower}") for tower in ("query_model", "passage_model")}
    if not all(layout.values()) or os.path.exists(f"{export}/config.json"):
        raise AssertionError(f"bert untied export: {layout}")

    enc = ["encode", *flags, "--model-name-or-path", export, "--bf16",
           "--batch-size", "256"]
    reset_launches()
    _run_cli([*enc, "--input", paths["corpus"], "--length-bucketing",
              "--output", f"{d}/corpus.npz"], "encode")
    _run_cli([*enc, "--input", paths["queries"], "--output", f"{d}/q.npz",
              "--encode-is-qry"], "encode")
    launches = read_launches()   # K4, once a batch
    if not launches["lexical_pool"] > 0:
        raise AssertionError(f"bert encode launches {launches}")
    _run_cli(["index", "--inputs", f"{d}/corpus.npz", "--output",
              f"{d}/index.npz", "--quantize"])
    with np.load(f"{d}/index.npz") as z:
        planes = {k: [list(z[k].shape), str(z[k].dtype)] for k in
                  ("values", "indices")}
    if planes["values"] != [[FAMILY_PASSAGES, LEX_DIM + 128], "int8"] \
            or planes["indices"][0] != [FAMILY_PASSAGES, LEX_DIM]:
        raise AssertionError(f"bert index planes {planes}")
    search = ["search", "--index-path", f"{d}/index.npz", "--query-path",
              f"{d}/q.npz", "--topk", "1000", "--query-batch", "128"]
    out = {}
    for label, sflags in (("exact", ["--theta", "0"]),
                          ("staged", ["--theta", "0.3", "--rerank",
                                      "--agip-topk", "10000"])):
        reset_launches()
        _run_cli([*search, *sflags, "--output", f"{d}/{label}.trec"],
                 "search")
        got = read_launches()
        if not (got["partial_gip"] > 0 and (
                got["rerank_gip"] > 0) == (label == "staged")):
            raise AssertionError(f"bert {label} launches {got}: K1 > 0, "
                                 "K2 > 0 with rerank only")
        for k in launches:
            launches[k] += got[k]
        _, metrics = _run_cli(["eval", "--qrels", paths["qrels"], "--run",
                               f"{d}/{label}.trec"], stdout=True)
        out[label] = {"flags": sflags, "launches": got, "metrics": metrics}
    run, staged = _read_run(f"{d}/exact.trec"), _read_run(
        f"{d}/staged.trec")
    if len(run) != FAMILY_QUERIES or any(
            len(r) != 1000 or not np.isfinite([s for _, s in r]).all()
            for r in run.values()):
        raise AssertionError("bert: the run lacks queries, rows or finite "
                             "scores")
    qids = sorted(run)
    out["staged"]["agreement_vs_exact"] = agreement(
        [np.array([x for x, _ in staged[q]]) for q in qids],
        [np.array([x for x, _ in run[q]]) for q in qids])
    vs = _family_exact_vs_cpu(d, f"{d}/exact.trec", torch, np)
    if vs["scores_match_exact"] != BERT_CHECKED \
            or vs["ranks_equal_up_to_ties"] != BERT_CHECKED:
        raise AssertionError(f"bert exact run vs the CPU: {vs}")
    return {"flags": flags, "steps": len(losses),
            "loss_first_last": [losses[0], losses[-1]],
            "eval_loss_first_96_queries": eval_loss,
            "export_token_types": layout, "index_planes": planes,
            "search": out, "exact_vs_cpu_4_queries": vs}, launches


def _bert_colbert_chain(root, init, paths, corpus, groups, torch, np):
    """``train --model colbert --pack-passages`` from the BERT init (bf16,
    40 steps; the f32 eval loss must fall) -> ``encode --model colbert``
    (16,384 passages, 1,024 queries) -> ``colbert-score --full-ranking
    --topk 1000``, held against the CPU's plain ``full_ranking`` of every
    passage on 4 queries (:func:`_vs_exact`)."""
    from dhr_tpu_torch.models.hf_io import load_hf_state_dict
    from dhr_tpu_torch.retrieval.colbert import full_ranking

    d = f"{root}/colbert"
    losses = _bert_train(d, BERT_COLBERT_FLAGS, init, paths,
                         ["--pack-passages"], torch, np)
    eval_loss = _bert_eval_loss(d, BERT_COLBERT_FLAGS, init, groups, corpus,
                                torch)
    export = f"{d}/export"
    if TOKEN_TYPE_KEY not in load_hf_state_dict(export):
        raise AssertionError("bert ColBERT export lacks token types")
    enc = ["encode", *BERT_COLBERT_FLAGS, "--model-name-or-path", export,
           "--bf16", "--batch-size", "256"]
    _run_cli([*enc, "--input", paths["corpus"], "--output", f"{d}/p_reps"],
             "encode")
    _run_cli([*enc, "--input", paths["queries"], "--output", f"{d}/q_reps",
              "--encode-is-qry"], "encode")
    with np.load(f"{d}/p_reps.npz") as z:
        p_reps = z["token"]
    with np.load(f"{d}/q_reps.npz") as z:
        q_reps = z["token"]
    if (p_reps.shape != (FAMILY_PASSAGES, 128, 128)
            or q_reps.shape != (FAMILY_QUERIES, 32, 128)):
        raise AssertionError(f"bert ColBERT reps {p_reps.shape} / "
                             f"{q_reps.shape}")
    _run_cli(["colbert-score", "--passage-reps", f"{d}/p_reps",
              "--query-reps", f"{d}/q_reps", "--full-ranking", "--topk",
              "1000", "--output", f"{d}/colbert.trec"], "colbert-score")
    run = _read_run(f"{d}/colbert.trec")
    qids = [f"q{i}" for i in range(FAMILY_QUERIES)]
    if sorted(run) != sorted(qids) or any(
            len(run[q]) != 1000
            or not np.isfinite([s for _, s in run[q]]).all() for q in qids):
        raise AssertionError("bert ColBERT run lacks queries, rows or "
                             "finite scores")
    # every passage's score on the CPU's plain path, held by PR 9's rule:
    # trained token reps tie more often than random ones, in chains
    cpu_s, cpu_r = full_ranking(q_reps[:BERT_CHECKED], p_reps,
                                topk=FAMILY_PASSAGES, device="cpu")
    exact = np.empty_like(cpu_s)
    np.put_along_axis(exact, cpu_r, cpu_s, axis=1)
    checked = qids[:BERT_CHECKED]
    vc = _vs_exact(checked, {q: [doc for doc, _ in run[q]] for q in checked},
                   {q: [sc for _, sc in run[q]] for q in checked}, exact,
                   [str(i) for i in range(FAMILY_PASSAGES)], np)
    if vc["scores_match_exact"] != BERT_CHECKED \
            or vc["ranks_equal_up_to_ties"] != BERT_CHECKED:
        raise AssertionError(f"bert ColBERT run vs CPU plain: {vc}")
    _, metrics = _run_cli(["eval", "--qrels", paths["qrels"], "--run",
                           f"{d}/colbert.trec"], stdout=True)
    del p_reps, q_reps
    return {"flags": [*BERT_COLBERT_FLAGS, "--pack-passages"],
            "steps": len(losses), "loss_first_last": [losses[0], losses[-1]],
            "eval_loss_first_96_queries": eval_loss, "metrics": metrics,
            "vs_cpu_plain_4_queries": vc}


def phase_bert_path(args, root, smi, torch):
    """BERT-base width (12 layers, token types) with random weights: card
    against CPU f32 reps of the tied init and of an untied tree, an untied
    step on a TASB batch and a packed ColBERT step (against the CPU and
    the plain step); then the untied, TASB-batched DHR chain and the packed
    ColBERT chain through the CLI from the ``bert`` init directory.
    Returns the DHR chain's launches: K4 in its encodes, K1 / K2 / K3 in
    its searches."""
    import numpy as np

    from dhr_tpu_torch.data import Corpus

    root = f"{root}/bert"
    os.makedirs(root)
    secs = {}
    t = time.perf_counter()
    paths, toks, groups, clusters, untied = _bert_setup(root, args.seed,
                                                        torch, np)
    init = f"{root}/init"
    corpus = Corpus([str(i) for i in range(len(toks))],
                    [x.tolist() for x in toks])
    q_toks = [np.random.default_rng(args.seed + 15).integers(
        ENCODE_REMOVE_DIMS, 30522, n) for n in (4, 9, 12, 17, 20, 25, 30, 30)]
    secs["setup"] = time.perf_counter() - t
    t = time.perf_counter()
    parity = _bert_card_vs_cpu(init, untied, toks, q_toks, torch, np)
    secs["reps_card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    steps = _bert_steps_card_vs_cpu(init, untied, clusters, corpus, groups,
                                    torch)
    del untied
    secs["steps_card_vs_cpu"] = time.perf_counter() - t
    t = time.perf_counter()
    dhr, launches = _bert_dhr_chain(root, init, paths, corpus, groups, torch,
                                    np)
    secs["dhr_chain"] = time.perf_counter() - t
    t = time.perf_counter()
    colbert = _bert_colbert_chain(root, init, paths, corpus, groups, torch,
                                  np)
    secs["colbert_chain"] = time.perf_counter() - t
    _CLI_WEIGHTS.clear()
    emit({"phase": "bert_path", "card": smi,
          "model": "bert-base (12x768, 12 heads, FFN 3072, vocab 30522, "
          "512 positions, 2 token types, eps 1e-12): DHR (768 lexical + "
          "128 CLS dims, untied towers) and ColBERT (projection 128)",
          "weights": f"random: the init (seed {args.seed + 17}) as a bert "
          f"HF directory; the untied tree's towers seeds {args.seed + 18} "
          f"and {args.seed + 19}",
          "world": {"passages": FAMILY_PASSAGES, "queries": FAMILY_QUERIES,
                    "train_groups": FAMILY_GROUPS,
                    "tasb_clusters": BERT_CLUSTERS},
          "card_vs_cpu_f32": parity, "steps_f32": steps,
          "dhr_chain": dhr, "colbert_chain": colbert,
          "launches": launches, "seconds": secs})
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# serve_path: the resident service, as the verb and in-process at full size
# --------------------------------------------------------------------------


def _http(port, path, payload=None, headers=None, timeout=300):
    """``(status, body dict, Retry-After)`` of a GET (no payload) or of a
    POST of a dict or of JSON bytes."""
    import urllib.error
    import urllib.request

    data = None
    if payload is not None:
        data = payload if isinstance(payload, bytes) else json.dumps(
            payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _client_proc(port, path, bodies, n_threads, barrier, out):
    """One load-generating process: ``n_threads`` closed-loop threads send
    ``bodies`` (``(qid, JSON bytes)``) in turn; puts ``[(qid, status,
    response)]`` on ``out``."""
    import threading
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    lock, nxt, done = threading.Lock(), [0], []

    def worker():
        while True:
            with lock:
                k = nxt[0]
                nxt[0] += 1
            if k >= len(bodies):
                return
            qid, body = bodies[k]
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    code, data = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, data = e.code, e.read()
            done.append((qid, code, json.loads(data)))

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    barrier.wait()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out.put(done)


def _closed_loop(port, path, bodies, concurrency, n_requests):
    """``n_requests`` requests cycling over ``bodies``, ``concurrency`` in
    flight, from ``min(concurrency, SERVE_CLIENT_PROCS)`` spawned client
    processes (threads share a process only past that count), all
    released at once.  Returns ``[(qid, status, response)]``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    n_procs = min(concurrency, SERVE_CLIENT_PROCS)
    reqs = [bodies[k % len(bodies)] for k in range(n_requests)]
    barrier = ctx.Barrier(n_procs + 1)
    out = ctx.Queue()
    procs = [ctx.Process(target=_client_proc, daemon=True, args=(
        port, path, reqs[p::n_procs], concurrency // n_procs, barrier, out))
        for p in range(n_procs)]
    for p in procs:
        p.start()
    try:
        barrier.wait(timeout=300)
        done = [r for _ in procs for r in out.get(timeout=900)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return done


class _Server:
    """A threaded HTTP server over a ``SearchService`` in this process."""

    def __init__(self, service):
        import threading

        from dhr_tpu_torch.serve import _ThreadingServer, make_handler

        self.service = service
        self.httpd = _ThreadingServer(("127.0.0.1", 0),
                                      make_handler(service))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        if self.service.batcher is not None:
            self.service.batcher.pause()  # parks the worker, drops searchers


def _batcher_counts(batcher):
    return (batcher.batches_run, batcher.queries_run,
            batcher.small_batches_run)


def _batcher_report(done, counts_before, batcher):
    """Requests, errors and the micro-batches the service ran for them."""
    b0, q0, s0 = counts_before
    batches = batcher.batches_run - b0
    return {"requests": len(done),
            "errors": sum(code != 200 for _, code, _ in done),
            "micro_batches": batches,
            "mean_pool": (batcher.queries_run - q0) / max(batches, 1),
            "low_latency_share": (batcher.small_batches_run - s0)
            / max(batches, 1)}


def _served_equal(done, want_r, want_s):
    """Served responses against direct ``search_run`` results: ids exact,
    scores within 1e-6 relative; returns the count checked."""
    import numpy as np

    for qid, code, resp in done:
        if code != 200:
            raise AssertionError(f"{qid}: HTTP {code} {resp}")
        if resp["results"][qid] != want_r[qid] or not np.allclose(
                resp["scores"][qid], want_s[qid], rtol=1e-6, atol=0):
            raise AssertionError(f"served {qid} differs from search_run")
    return len(done)


def _serve_verb(root, checkout, paths, want8):
    """``python -m dhr_tpu_torch serve`` on the densified index as a
    process: serve_client stats / search, reloads (to the first half, then
    free_first back), 503 shedding past --max-pending, token refusal and a
    clean stop on SIGINT."""
    import signal
    import threading

    import numpy as np

    port, token = _free_port(), "chip-smoke-token"
    log_path = f"{root}/serve_verb.log"
    cmd = [sys.executable, "-m", "dhr_tpu_torch", "serve", "--index-path",
           paths["index"], "--host", "127.0.0.1", "--port", str(port),
           *DENSIFY_SEARCH, "--topk", "1000", "--query-batch", "128",
           "--micro-batch-ms", "2", "--low-latency-batch", "8",
           "--max-pending", "64", "--allow-reload", "--reload-token", token]
    client = [sys.executable, os.path.join(checkout, "tools",
                                           "serve_client.py")]
    out, t0 = {"flags": cmd[6:]}, time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=checkout, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError("serve exited during start-up")
            try:
                if _http(port, "/healthz", timeout=5)[1]["status"] == "ok":
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                raise AssertionError("serve did not come up in 300 s")
            time.sleep(0.2)

        def tool(*argv):
            res = subprocess.run(client + [*argv, "--port", str(port)],
                                 capture_output=True, text=True, timeout=300,
                                 check=True)
            return json.loads(res.stdout)

        search8 = ("search", "--values-npz", paths["q8"], "--qids-json",
                   paths["q8"][:-len(".npz")] + ".qids.json")
        out["stats_at_start"] = tool("stats")
        if out["stats_at_start"]["rows"] != paths["rows"]:
            raise AssertionError(f"stats {out['stats_at_start']}")
        for name, want_rows, body in (
                ("full", paths["rows"], None),
                ("half", paths["rows"] // 2, {"index_path": paths["half"]}),
                ("full_free_first", paths["rows"],
                 {"index_path": paths["index"], "free_first": True})):
            if body is not None:
                code, resp, _ = _http(port, "/admin/reload", body,
                                      {"X-Reload-Token": token})
                if code != 200 or resp["rows"] != want_rows:
                    raise AssertionError(f"reload {name}: {code} {resp}")
            got = tool(*search8)
            want_r, want_s = want8["half" if name == "half" else "full"]
            for q, ids in want_r.items():
                if got["results"][q] != ids or not np.allclose(
                        got["scores"][q], want_s[q], rtol=1e-6, atol=0):
                    raise AssertionError(f"served {name} {q} differs from "
                                         "a direct search of that index")
            out[f"rows_after_{name}"] = want_rows
        for headers in ({}, {"X-Reload-Token": "wrong"}):
            code, _, _ = _http(port, "/admin/reload",
                               {"index_path": paths["half"]}, headers)
            if code != 403:
                raise AssertionError(f"reload with {headers}: HTTP {code}")
        out["bad_token_refused"] = True

        qv, qi, qids = paths["queries"]
        m = SERVE_FLOOD_QUERIES
        flood_body = json.dumps({
            "values": qv[:m].astype(np.float32).tolist(),
            "indices": qi[:m].astype(np.int32).tolist(),
            "qids": qids[:m]}).encode()
        codes, lock = [], threading.Lock()

        def flood():
            code, _, retry = _http(port, "/search", flood_body)
            with lock:
                codes.append((code, retry))

        threads = [threading.Thread(target=flood)
                   for _ in range(SERVE_FLOOD)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        stats = tool("stats")
        ok = sum(c == 200 for c, _ in codes)
        shed = [r for c, r in codes if c == 503]
        out["flood"] = {"requests": SERVE_FLOOD, "queries_each": m,
                        "ok": ok, "shed_503": len(shed),
                        "retry_after": sorted(set(shed)),
                        "rejects_in_stats": stats["rejects"]}
        if not (shed and ok and ok + len(shed) == SERVE_FLOOD
                and set(shed) == {"1"} and stats["rejects"] == len(shed)):
            raise AssertionError(f"flood past --max-pending: {out['flood']}")
        out["stats_at_end"] = stats
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    with open(log_path) as f:
        text = f.read()
    if rc != 0 or "interrupted; stopping" not in text:
        raise AssertionError(f"serve did not stop cleanly (rc {rc}):\n"
                             + text[-3000:])
    out["exit_code_on_sigint"] = rc
    return out


def _densified_service(path, cfg, loader):
    """A micro-batching service (low-latency route at 8) over the index at
    ``path`` on the card, and the bytes of its device planes; built in a
    frame of its own so that nothing but the service holds the planes."""
    from dhr_tpu_torch.retrieval import DeviceIndex, PackedIndex, Searcher
    from dhr_tpu_torch.serve import SearchService

    index = DeviceIndex.from_packed(PackedIndex.load(path), device="cuda")
    nbytes = sum(t.untyped_storage().nbytes() for t in (
        index.values, index.values_T, index.indices, index.indices_T,
        index.value_scales))
    small = Searcher(index, dataclasses.replace(cfg, query_batch=8))
    return SearchService(Searcher(index, cfg), micro_batch_ms=2.0,
                         small_searcher=small, index_loader=loader), nbytes


def _free_first_memory(paths, torch):
    """A free-first reload in this process: ``torch.cuda.memory_allocated``
    before it, inside the loader (the old planes released, the new ones not
    loaded yet) and after it."""
    import gc

    from dhr_tpu_torch.retrieval import DeviceIndex, PackedIndex, SearchConfig

    marks = {}

    def loader(path):
        torch.cuda.synchronize()
        marks["between"] = torch.cuda.memory_allocated()
        return DeviceIndex.from_packed(PackedIndex.load(path), device="cuda")

    cfg = SearchConfig(topk=1000, theta=0.1, rerank=True, agip_topk=10000,
                       query_batch=128)
    service, full_bytes = _densified_service(paths["index"], cfg, loader)
    qv, qi, qids = paths["queries"]
    service.search({"values": qv[:4].astype("float32").tolist(),
                    "indices": qi[:4].astype("int32").tolist(),
                    "qids": qids[:4]})
    torch.cuda.synchronize()
    marks["before"] = torch.cuda.memory_allocated()
    resp = service.reload({"index_path": paths["half"], "free_first": True})
    torch.cuda.synchronize()
    marks["after"] = torch.cuda.memory_allocated()
    service.batcher.pause()
    del service
    gc.collect()
    torch.cuda.empty_cache()
    out = {"full_index_device_bytes": full_bytes, **marks,
           "freed_before_load": marks["before"] - marks["between"],
           "loaded": marks["after"] - marks["between"], "reload": resp}
    if out["freed_before_load"] < 0.95 * full_bytes:
        raise AssertionError(f"free_first freed {out['freed_before_load']} "
                             f"of {full_bytes} bytes before loading")
    return out


class HashTokenizer:
    """Whole words hashed into the wordpiece ids [570, 30522): the query
    side of ``/search_text`` without a tokenizer file."""

    def encode(self, text, add_special_tokens=False, max_length=None,
               truncation=True):
        import zlib

        ids = [ENCODE_REMOVE_DIMS + zlib.crc32(w.encode())
               % (30522 - ENCODE_REMOVE_DIMS) for w in text.lower().split()]
        return ids[:max_length] if truncation and max_length else ids


def _serve_full_size(searcher, qv, qf, out):
    """(b): the service over the main path's searcher and a low-latency
    searcher at batch 8 over the same DeviceIndex; closed-loop client
    processes at each concurrency of ``SERVE_LEVELS``; then the same over a
    fused-candidates searcher at concurrency 64.  Every response equals
    ``search_run``'s.  Fills ``out``; returns the launches."""
    from dhr_tpu_torch.retrieval import Searcher
    from dhr_tpu_torch.serve import SearchService

    n_q = qv.shape[0]
    qids = [f"q{i}" for i in range(n_q)]
    bodies = [(q, json.dumps({"values": qv[i:i + 1].tolist(),
                              "indices": qf[i:i + 1].tolist(),
                              "qids": [q]}).encode())
              for i, q in enumerate(qids)]
    cfg = searcher.config
    small = Searcher(searcher.index, dataclasses.replace(cfg, query_batch=8))
    want_r, want_s = searcher.search_run(qids, qv, qf)
    service = SearchService(searcher, micro_batch_ms=2.0,
                            small_searcher=small)
    server = _Server(service)
    levels = {}
    try:
        reset_launches()
        for conc, n_req in SERVE_LEVELS.items():
            before = _batcher_counts(service.batcher)
            done = _closed_loop(server.port, "/search", bodies, conc, n_req)
            lv = levels[str(conc)] = _batcher_report(done, before,
                                                     service.batcher)
            lv["client_processes"] = min(conc, SERVE_CLIENT_PROCS)
            if lv["errors"]:
                raise AssertionError(f"errors at concurrency {conc}: {lv}")
            lv["checked_vs_search_run"] = _served_equal(done, want_r, want_s)
        launches = read_launches()
    finally:
        server.close()
    out["levels"] = levels
    out["launches_search"] = launches
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"served search launches {launches}")

    fcfg = dataclasses.replace(cfg, fused_candidates=True, candidate_block=8)
    fused = Searcher(searcher.index, fcfg)
    fsmall = Searcher(searcher.index,
                      dataclasses.replace(fcfg, query_batch=8))
    if not (fused._fused and fsmall._fused):
        raise AssertionError("the fused service did not engage K3")
    fwant_r, fwant_s = fused.search_run(qids, qv, qf)
    service = SearchService(fused, micro_batch_ms=2.0, small_searcher=fsmall)
    server = _Server(service)
    try:
        reset_launches()
        before = _batcher_counts(service.batcher)
        done = _closed_loop(server.port, "/search", bodies, 64, n_q)
        fused_launches = read_launches()
        lv = _batcher_report(done, before, service.batcher)
        lv["checked_vs_search_run"] = _served_equal(done, fwant_r, fwant_s)
    finally:
        server.close()
    lv["launches"] = fused_launches
    out["fused_service_c64"] = lv
    if not (fused_launches["gip_candidates"] > 0
            and fused_launches["rerank_gip"] > 0
            and fused_launches["partial_gip"] == 0):
        raise AssertionError(f"fused service launches {fused_launches}")
    return {k: launches[k] + fused_launches[k] for k in launches}, small


def _serve_text(args, searcher, small, out, torch):
    """(c): ``/search_text`` through the DistilBERT-base DHR query encoder
    (the random tree of ``encode_path``) at concurrency 8; each response
    against encoding that text alone plus ``search_run``."""
    import numpy as np

    from dhr_tpu_torch.encode import EncodeConfig, Encoder, make_query_encoder
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.serve import SearchService

    mcfg = _dhr_config(torch.bfloat16)
    tree = random_flax_params(_dhr_config(torch.float32),
                              torch.Generator().manual_seed(args.seed))
    enc = Encoder(load_flax_params(BiEncoder(mcfg), tree), mcfg,
                  EncodeConfig(batch_size=8, remove_dims=ENCODE_REMOVE_DIMS))
    del tree
    qenc = make_query_encoder(enc, HashTokenizer(), 32, 101, 102)
    rng = np.random.default_rng(args.seed + 9)
    vocab = [f"term{i}" for i in range(5000)]
    texts = [" ".join(rng.choice(vocab, int(rng.integers(3, 12))))
             for _ in range(SERVE_TEXT_QUERIES)]
    tids = [f"t{i}" for i in range(len(texts))]
    planes = [qenc([x]) for x in texts]  # one text a call, as served
    tv = np.concatenate([p[0] for p in planes])
    ti = np.concatenate([p[1] for p in planes])
    if tv.shape != (len(texts), LEX_DIM + 128) or ti.shape != (
            len(texts), LEX_DIM):
        raise AssertionError(f"query planes {tv.shape} / {ti.shape}")
    want_r, want_s = searcher.search_run(tids, tv, ti)
    bodies = [(q, json.dumps({"queries": [x], "qids": [q]}).encode())
              for q, x in zip(tids, texts)]
    service = SearchService(searcher, micro_batch_ms=2.0,
                            small_searcher=small, query_encoder=qenc)
    server = _Server(service)
    try:
        reset_launches()
        before = _batcher_counts(service.batcher)
        done = _closed_loop(server.port, "/search_text", bodies, 8,
                            len(bodies))
        launches = read_launches()
        lv = _batcher_report(done, before, service.batcher)
        lv["checked_vs_encode_and_search_run"] = _served_equal(
            done, want_r, want_s)
    finally:
        server.close()
    lv["launches"] = launches
    lv["encoder"] = ("distilbert-base DHR, bf16, random tree of seed "
                     f"{args.seed}, hashing word tokenizer, q_max_len 32")
    out["search_text_c8"] = lv
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"/search_text launches {launches}")
    return launches


def phase_serve_path(args, root, paths, searcher, main_queries, smi, torch):
    """The serve slice: (a) the ``serve`` verb as a process on the
    densified index; (a2) a free-first reload's device memory; (b) the
    service in this process at 8,841,823 rows (``_serve_full_size``); (c)
    ``/search_text`` (``_serve_text``).  Returns the kernel launches of (b)
    and (c)."""
    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)

    checkout = os.path.dirname(os.path.abspath(__file__))
    secs, out = {}, {"phase": "serve_path", "card": smi}
    t = time.perf_counter()
    dcfg = SearchConfig(topk=1000, theta=0.1, rerank=True, agip_topk=10000,
                        query_batch=8)
    qv8, qi8, qids8 = (x[:8] for x in paths["queries"])
    want8 = {}
    for name in ("index", "half"):
        direct = Searcher(DeviceIndex.from_packed(
            PackedIndex.load(paths[name]), device="cuda"), dcfg)
        want8["full" if name == "index" else name] = direct.search_run(
            qids8, qv8, qi8)
        del direct
    torch.cuda.empty_cache()
    out["verb"] = _serve_verb(root, checkout, paths, want8)
    secs["verb"] = time.perf_counter() - t

    t = time.perf_counter()
    out["free_first_memory"] = _free_first_memory(paths, torch)
    secs["free_first_memory"] = time.perf_counter() - t

    t = time.perf_counter()
    qv, qf = (x.cpu().numpy() for x in main_queries[:2])
    launches, small = _serve_full_size(searcher, qv, qf, out)
    secs["full_size"] = time.perf_counter() - t

    t = time.perf_counter()
    text = _serve_text(args, searcher, small, out, torch)
    secs["search_text"] = time.perf_counter() - t
    out["seconds"] = secs
    emit(out)
    torch.cuda.empty_cache()
    return {k: launches[k] + text[k] for k in launches}


# --------------------------------------------------------------------------
# parallel_path: the row-sharded search, DP training, DP encoding and the
# sharded service, two ranks sharing the one card over gloo
# --------------------------------------------------------------------------

PARALLEL_RANKS = 2
PARALLEL_AGREE = 64          # queries held against the one-process results
PARALLEL_ENCODE = 1_024      # passages of the Encoder(mesh=) check
PARALLEL_CLI_QUERIES = 64    # densified-index queries of the sharded CLI
PARALLEL_SERVE_REQUESTS = 64
FSDP_MAX_GRAD_NORM = 1e-3    # below the step's gradient norm: the clip acts


def _par_search(job, z, dev, torch, np):
    """(a): the bench point over this rank's half of the MS MARCO-sized
    corpus (each rank draws only its own rows' chunks, the int8 scales
    from a MAX all-reduce of the amaxes), the fused path and the exact
    candidates, one pass each."""
    import torch.distributed as dist
    from torch.distributed import ReduceOp

    from dhr_tpu_torch.parallel import make_mesh
    from dhr_tpu_torch.parallel.collectives import all_reduce_
    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes

    rank, world = dist.get_rank(), dist.get_world_size()
    n = job["rows"]
    per = -(-n // world)
    mesh = make_mesh(axis="index")
    v, f, scales, _ = synth_index_planes(
        job["seed"], n, device=dev, rows=(rank * per, rank * per + per),
        reduce_amax=lambda a: all_reduce_(a, ReduceOp.MAX))
    index = DeviceIndex.from_arrays(
        v, f, np.arange(n).astype(str), LEX_DIM, scales, device=dev,
        mesh=mesh, num_rows=n)
    del v, f
    qv = torch.from_numpy(z["qv"]).to(dev)
    qf = torch.from_numpy(z["qf"]).to(dev)
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=128)
    s = Searcher(index, cfg, device=dev)
    reset_launches()
    scores, rows = s.search(qv, qf)
    launches = read_launches()
    n_batches = -(-qv.shape[0] // cfg.query_batch)  # once a batch
    want = {"partial_gip": n_batches, "rerank_gip": n_batches,
            "gip_candidates": 0, "lexical_pool": 0, "moe_combine": 0,
            "mla_attention": 0}
    if launches != want:
        raise AssertionError(f"rank {rank}: sharded main path launches "
                             f"{launches}, expected {want}")
    check_result(scores, rows, qv.shape[0], cfg.topk, n)
    erows = z["erows"]
    agree = agreement(rows[:erows.shape[0]], erows)

    # exact candidates (f32, one top-k per shard, merged): the one-process
    # results of the same configuration
    exact_cfg = dataclasses.replace(cfg, approx_candidates=False,
                                    candidate_bf16=False,
                                    query_batch=PARALLEL_AGREE)
    reset_launches()
    xs, xr = Searcher(index, exact_cfg, device=dev).search(
        qv[:PARALLEL_AGREE], qf[:PARALLEL_AGREE])
    exact_launches = read_launches()
    checks = [_ranking_check(xr[i].tolist(), xs[i], z["x_rows"][i].tolist(),
                             z["x_scores"][i], 1e-6)
              for i in range(PARALLEL_AGREE)]
    vs_one = {"queries": PARALLEL_AGREE,
              "scores_equal_rtol_1e-6": sum(c[0] for c in checks),
              "ids_exact": sum(c[1] for c in checks),
              "ids_equal_up_to_ties": sum(c[2] for c in checks),
              "score_max_abs_diff": float(np.abs(xs - z["x_scores"]).max())}

    fcfg = dataclasses.replace(cfg, fused_candidates=True, candidate_block=8)
    fused = Searcher(index, fcfg, device=dev)
    if not fused._fused:
        raise AssertionError("the sharded fused path did not engage")
    reset_launches()
    _, frows = fused.search(qv, qf)
    fused_launches = read_launches()
    fwant = {"partial_gip": 0, "rerank_gip": n_batches,
             "gip_candidates": n_batches, "lexical_pool": 0,
             "moe_combine": 0, "mla_attention": 0}
    if fused_launches != fwant:
        raise AssertionError(f"rank {rank}: sharded fused launches "
                             f"{fused_launches}, expected {fwant}")
    fagree = agreement(frows[:erows.shape[0]], erows)
    out = {"rows": n, "shard_rows": index.local_rows,
           "row_offset": index.row_offset,
           "shard_index_bytes": sum(
               t.untyped_storage().nbytes() for t in (
                   index.values, index.values_T, index.indices,
                   index.indices_T)),
           "launches": launches, "fused_launches": fused_launches,
           "exact_launches": exact_launches,
           "staged_vs_exact": agree, "fused_staged_vs_exact": fagree,
           "exact_candidates_vs_one_process": vs_one}
    del s, fused, index
    torch.cuda.empty_cache()
    return out


def _par_batch(seed, np, torch):
    """The documented model's batch: 24 queries x 8 passages (32 / 128
    tokens), from a 4,096-passage corpus of encode_path's kind."""
    rng = np.random.default_rng(seed + 9)
    toks, _ = _passage_tokens(rng, 4096, np)
    groups = []
    for _ in range(24):
        pos = int(rng.integers(4096))
        negs = rng.choice(4095, TRAIN_NEGATIVES, replace=False)
        negs = negs + (negs >= pos)
        groups.append({
            "query": rng.choice(toks[pos], int(rng.integers(6, 31))).tolist(),
            "positive_pids": [str(pos)],
            "negative_pids": [str(int(x)) for x in negs]})
    return next(iter(_train_loader(groups, toks, 24, torch).epoch(0)))


def _clipped(grads, max_norm):
    """``grads`` scaled as ``clip_grad_norm`` scales them (optax
    ``clip_by_global_norm``), from their f64 global norm."""
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in grads.values()))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {n: g * scale for n, g in grads.items()}, norm


def _par_train(job, dev, torch, np):
    """(b): one DP step of the DistilBERT-base DHR model (f32, dropout 0.1
    with the global masks) on 2 ranks against the one-process step on
    rank 0; then FSDP (its shards on the card) with ``max_grad_norm`` set
    below the gradient's norm: the clipped step against the one-process
    step clipped (loss and gradients within 1e-5 relative, L2; the
    sharded gradients' norm summed by c10d all-reduces), a save after it
    (the state gathered by c10d all-gathers), the next step, and the same
    next step from a fresh FSDP state restored from the save: its loss
    bit-equal to the uninterrupted run's; then the TP leg (``_par_tp``)."""
    import torch.distributed as dist

    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.parallel import axes_group, make_mesh, shard_batch
    from dhr_tpu_torch.parallel.collectives import gather_full
    from dhr_tpu_torch.train.checkpoint import (
        restore_train_state, save_train_state)
    from dhr_tpu_torch.train.driver import RunConfig, parallelize
    from dhr_tpu_torch.train.optimizer import OptimizerConfig
    from dhr_tpu_torch.train.state import TrainState
    from dhr_tpu_torch.train.step import LossConfig, make_train_step

    rank = dist.get_rank()
    cfg = _dhr_config(torch.float32)
    tree = random_flax_params(cfg, torch.Generator().manual_seed(job["seed"]))
    batch = _par_batch(job["seed"], np, torch)
    opt = OptimizerConfig(learning_rate=7e-6, warmup_steps=0,
                          total_steps=100)
    one = None
    if rank == 0:
        model = load_flax_params(BiEncoder(cfg), tree).to(dev)
        state = TrainState.create(model, opt)
        loss = float(make_train_step(model, cfg, LossConfig())(
            state, batch, job["seed"]))
        one = (loss, _grads(model))
        del model, state
        torch.cuda.empty_cache()
    mesh = make_mesh()
    model = load_flax_params(BiEncoder(cfg), tree).to(dev)
    state = TrainState.create(model, opt,
                              data_group=axes_group(mesh, ("data",)))
    step = make_train_step(model, cfg, LossConfig())
    local = shard_batch(batch, mesh)
    loss = float(step(state, local, job["seed"]))
    out = {"queries": 24, "passages": 192, "local_queries": 12,
           "loss": loss}
    if one is not None:
        l2, mx = _grad_rel_diff(_grads(model), one[1])
        out.update(loss_one_process=one[0],
                   loss_rel_diff=abs(loss - one[0]) / abs(one[0]),
                   grad_rel_l2_diff=l2, grad_max_rel_diff=mx)
        if not (out["loss_rel_diff"] <= 1e-5 and l2 <= 1e-5):
            raise AssertionError(f"DP step vs one process: {out}")
    del model, state
    torch.cuda.empty_cache()

    # FSDP over the 2 ranks: a gloo mesh of ranks on the card lives on the
    # card, so its parameter shards stay there
    clip = dataclasses.replace(opt, max_grad_norm=FSDP_MAX_GRAD_NORM)

    def fsdp_state():
        # shard first: the optimizer must hold the sharded parameters
        model = load_flax_params(BiEncoder(cfg), tree).to(dev)
        group = parallelize(model, mesh, RunConfig(fsdp=True))
        state = TrainState.create(model, clip, data_group=group)
        return state, make_train_step(model, cfg, LossConfig())

    state, step = fsdp_state()
    model = state.model
    out["fsdp_params_on_card"] = all(p.device.type == "cuda"
                                     for p in model.parameters())
    loss = float(step(state, local, job["seed"]))
    grads = {n: gather_full(p.grad).float().cpu()
             for n, p in model.named_parameters() if p.grad is not None}
    if one is not None:
        want, norm = _clipped(one[1], FSDP_MAX_GRAD_NORM)
        l2, mx = _grad_rel_diff(grads, want)
        out.update(fsdp_max_grad_norm=FSDP_MAX_GRAD_NORM,
                   fsdp_grad_norm_one_process=norm,
                   fsdp_loss_rel_diff=abs(loss - one[0]) / abs(one[0]),
                   fsdp_grad_rel_l2_diff=l2, fsdp_grad_max_rel_diff=mx)
        if not (out["fsdp_params_on_card"] and norm > FSDP_MAX_GRAD_NORM
                and out["fsdp_loss_rel_diff"] <= 1e-5 and l2 <= 1e-5):
            raise AssertionError(f"clipped FSDP step vs one process: {out}")
    ckpt = os.path.join(job["dir"], "fsdp_ckpt")
    save_train_state(ckpt, state)
    nxt = _par_batch(job["seed"] + 1, np, torch)
    nxt = shard_batch(nxt, mesh)
    out["fsdp_next_loss"] = float(step(state, nxt, job["seed"]))
    del model, state, step, grads
    torch.cuda.empty_cache()
    state, step = fsdp_state()
    restore_train_state(ckpt, state)
    out["fsdp_restored_step"] = state.step
    out["fsdp_resumed_loss"] = float(step(state, nxt, job["seed"]))
    out["fsdp_resume_bit_equal"] = (out["fsdp_resumed_loss"]
                                    == out["fsdp_next_loss"])
    if out["fsdp_restored_step"] != 1 or not out["fsdp_resume_bit_equal"]:
        raise AssertionError(f"FSDP restore: {out}")
    del state, step
    torch.cuda.empty_cache()
    out["tp"] = _par_tp(job, dev, cfg, tree, batch, opt, one, torch, np)
    return out


def _par_tp(job, dev, cfg, tree, batch, opt, one, torch, np):
    """(b'): Megatron TP over a (data, model) = (1, 2) mesh of the two
    ranks (6 of the 12 heads and 1,536 of the 3,072 FFN columns a rank;
    embeddings and norms replicated), its collectives c10d all-reduces
    (``copy_to_model`` / ``reduce_from_model``).  Checked against the
    one-process step on rank 0, the same batch on both ranks: dropout off
    (a one-process step of its own) and 0.1 (``one``, _par_train's), loss
    within 1e-5 relative and ``gather_full`` gradients within 1e-5
    relative L2 over all of them; a step clipped at
    ``FSDP_MAX_GRAD_NORM`` against ``one`` clipped; a save, the next step
    and a fresh TP state restored from the save, whose next loss must be
    bit-equal.  Reported: the all-reduces of a step and their bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from dhr_tpu_torch.models import BiEncoder, load_flax_params
    from dhr_tpu_torch.parallel import collectives, shard_batch
    from dhr_tpu_torch.parallel.collectives import gather_full
    from dhr_tpu_torch.parallel.mesh import _device_mesh
    from dhr_tpu_torch.parallel.tp import tp_param_specs
    from dhr_tpu_torch.train.checkpoint import (
        restore_train_state, save_train_state)
    from dhr_tpu_torch.train.driver import RunConfig, data_axes, parallelize
    from dhr_tpu_torch.train.state import TrainState
    from dhr_tpu_torch.train.step import LossConfig, make_train_step

    rank, seed = dist.get_rank(), job["seed"]
    dry = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, hidden_dropout=0.0, attention_dropout=0.0))
    mesh = _device_mesh(np.arange(PARALLEL_RANKS).reshape(1, -1),
                        ("data", "model"))
    local = shard_batch(batch, mesh, data_axes(mesh))
    out = {"mesh": {"data": 1, "model": PARALLEL_RANKS}}

    def tp_state(c, o):
        model = load_flax_params(BiEncoder(c), tree).to(dev)
        group = parallelize(model, mesh, RunConfig())
        return (TrainState.create(model, o, data_group=group),
                make_train_step(model, c, LossConfig()))

    def full_grads(model):
        return {n: gather_full(p.grad).float().cpu()
                for n, p in model.named_parameters() if p.grad is not None}

    def check(key, loss, grads, want):
        # the relative L2 over every gradient (the CPU tests' measure) is
        # held to 1e-5; the largest per-tensor one (what the DP and FSDP
        # legs hold) is reported: TP reorders the sums inside each layer,
        # and attention's query / key gradients, behind the softmax's
        # cancellation, move most
        worst = {}
        l2, mx = _grad_rel_diff(grads, want[1], worst)
        names = [n for n in want[1] if "attention.key.bias" not in n]
        d = math.sqrt(sum(float((grads[n].double() - want[1][n].double())
                                .square().sum()) for n in names))
        w = math.sqrt(sum(float(want[1][n].double().square().sum())
                          for n in names))
        out[key] = {"loss": loss, "loss_one_process": want[0],
                    "loss_rel_diff": abs(loss - want[0]) / abs(want[0]),
                    "grad_rel_l2_diff": d / w,
                    "grad_rel_l2_diff_worst_tensor": l2,
                    "grad_max_rel_diff": mx, "worst_tensors": worst}
        if not (out[key]["loss_rel_diff"] <= 1e-5
                and out[key]["grad_rel_l2_diff"] <= 1e-5):
            raise AssertionError(f"TP {key} vs one process: {out[key]}")

    dry_one = None
    if rank == 0:
        model = load_flax_params(BiEncoder(dry), tree).to(dev)
        state = TrainState.create(model, opt)
        step = make_train_step(model, dry, LossConfig())
        dry_one = (float(step(state, batch, seed)), _grads(model))
        del model, state, step
        torch.cuda.empty_cache()
    dist.barrier()

    # dropout off: placement, the step against one process and its
    # all-reduces
    state, step = tp_state(dry, opt)
    model = state.model
    specs = tp_param_specs(model)
    sharded = {n for n, p in model.named_parameters()
               if isinstance(p, DTensor)
               and any(isinstance(q, Shard) for q in p.placements)}
    want = {n for n, q in specs.items() if isinstance(q, Shard)}
    out["params_on_card"] = all(p.device.type == dev.type
                                for p in model.parameters())
    out["sharded_params"] = len(sharded)
    if not (out["params_on_card"] and sharded and sharded == want):
        raise AssertionError(f"TP placement: on card "
                             f"{out['params_on_card']}, sharded - specs "
                             f"{sorted(sharded - want)[:4]}, specs - "
                             f"sharded {sorted(want - sharded)[:4]}")
    counted = {"calls": 0, "bytes": 0}

    def counting(x, *a, **kw):
        if collectives.size(kw.get("group")) > 1:
            counted["calls"] += 1
            counted["bytes"] += x.numel() * x.element_size()
        return all_reduce(x, *a, **kw)

    all_reduce, collectives.all_reduce_ = collectives.all_reduce_, counting
    try:
        loss = float(step(state, local, seed))
    finally:
        collectives.all_reduce_ = all_reduce
    out["all_reduces_a_step"] = counted["calls"]
    out["all_reduced_bytes_a_step"] = counted["bytes"]
    grads = full_grads(model)
    if dry_one is not None:
        check("dropout_off", loss, grads, dry_one)
    del model, state, step, grads
    torch.cuda.empty_cache()

    # dropout 0.1 (a TP rank keeps its heads' block of the global mask)
    state, step = tp_state(cfg, opt)
    loss = float(step(state, local, seed))
    grads = full_grads(state.model)
    if one is not None:
        check("dropout", loss, grads, one)
    del state, step, grads
    torch.cuda.empty_cache()

    # clipped, saved, stepped on, restored
    clip = dataclasses.replace(opt, max_grad_norm=FSDP_MAX_GRAD_NORM)
    state, step = tp_state(cfg, clip)
    loss = float(step(state, local, seed))
    grads = full_grads(state.model)
    if one is not None:
        want, norm = _clipped(one[1], FSDP_MAX_GRAD_NORM)
        check("clipped", loss, grads, (one[0], want))
        out["clipped"]["grad_norm_one_process"] = norm
        if not norm > FSDP_MAX_GRAD_NORM:
            raise AssertionError(f"TP clip did not act: norm {norm}")
    del grads
    ckpt = os.path.join(job["dir"], "tp_ckpt")
    save_train_state(ckpt, state)
    nxt = _par_batch(seed + 1, np, torch)
    nxt = shard_batch(nxt, mesh, data_axes(mesh))
    out["next_loss"] = float(step(state, nxt, seed))
    del state, step
    torch.cuda.empty_cache()
    state, step = tp_state(cfg, clip)
    restore_train_state(ckpt, state)
    out["restored_step"] = state.step
    out["resumed_loss"] = float(step(state, nxt, seed))
    out["resume_bit_equal"] = out["resumed_loss"] == out["next_loss"]
    if out["restored_step"] != 1 or not out["resume_bit_equal"]:
        raise AssertionError(f"TP restore: {out}")
    del state, step
    torch.cuda.empty_cache()
    return out


def _par_encode(job, dev, torch, np):
    """(d): Encoder(mesh=) planes of 1,024 passages (f32 model, batch 128:
    64 rows a rank) against the one-process Encoder on rank 0."""
    import torch.distributed as dist

    from dhr_tpu_torch.encode import EncodeConfig, Encoder, iter_batches
    from dhr_tpu_torch.models import (
        BiEncoder, load_flax_params, random_flax_params)
    from dhr_tpu_torch.parallel import make_mesh

    rank = dist.get_rank()
    cfg = _dhr_config(torch.float32)
    model = load_flax_params(BiEncoder(cfg), random_flax_params(
        cfg, torch.Generator().manual_seed(job["seed"])))
    rng = np.random.default_rng(job["seed"] + 11)
    toks, _ = _passage_tokens(rng, PARALLEL_ENCODE, np)
    ids = np.zeros((PARALLEL_ENCODE, 128), np.int32)
    mask = np.zeros_like(ids)
    for i, t in enumerate(toks):
        row = [101, *t.tolist(), 102]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    docids = [str(i) for i in range(PARALLEL_ENCODE)]
    ecfg = EncodeConfig(batch_size=128, remove_dims=ENCODE_REMOVE_DIMS)
    sharded = Encoder(model, cfg, ecfg, device=dev, mesh=make_mesh())
    got = sharded.encode_corpus(iter_batches(docids, ids, mask, 128))
    out = {"passages": PARALLEL_ENCODE}
    if rank == 0:
        want = Encoder(model, cfg, ecfg, device=dev).encode_corpus(
            iter_batches(docids, ids, mask, 128))
        out.update(
            values_byte_equal=got.values.tobytes() == want.values.tobytes(),
            indices_byte_equal=(got.indices.tobytes()
                                == want.indices.tobytes()),
            values_differing=int((got.values != want.values).sum()),
            indices_differing=int((got.indices != want.indices).sum()),
            docids_equal=list(got.docids) == list(want.docids))
        if not (out["values_byte_equal"] and out["indices_byte_equal"]
                and out["docids_equal"]):
            raise AssertionError(f"Encoder(mesh=) vs one process: {out}")
    del sharded
    torch.cuda.empty_cache()
    return out


def parallel_worker(job_dir: str) -> int:
    """One rank of parallel_path (launched by torchrun): (a), (b) and (d);
    writes ``rank<r>.json`` into ``job_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dhr_tpu_torch.parallel import init_distributed

    dev = init_distributed("gloo")  # two ranks share the card: not NCCL
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    z = dict(np.load(os.path.join(job_dir, "queries.npz")))
    secs, out = {}, {"rank": dist.get_rank(), "device": str(dev)}
    for name, fn in (("search", lambda: _par_search(job, z, dev, torch,
                                                    np)),
                     ("train", lambda: _par_train(job, dev, torch, np)),
                     ("encode", lambda: _par_encode(job, dev, torch, np))):
        t = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t
    out["seconds"] = secs
    with open(os.path.join(job_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _torchrun(argv, timeout):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2
    <argv>``; raises with the output's tail unless it exits 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(PARALLEL_RANKS), *argv]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if p.returncode:
        raise AssertionError(f"{' '.join(argv[:3])} on {PARALLEL_RANKS} "
                             f"ranks exited {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-6000:]}")
    return p


def _sharded_search_cli(root, index_path, queries):
    """``search --shard-over-devices`` under torchrun (gloo, two ranks on
    the card) against the one-process ``search`` on the same index: the
    TREC runs must agree (exact candidates, f32)."""
    import numpy as np

    qv, qi, qids = queries
    k = PARALLEL_CLI_QUERIES
    qpath = f"{root}/par_q.npz"
    np.savez(qpath, values=qv[:k], indices=qi[:k])
    with open(qpath + ".qids.json", "w") as f:
        json.dump(list(qids[:k]), f)
    flags = ["--index-path", index_path, "--query-path", qpath,
             *DENSIFY_SEARCH, "--exact-candidates", "--no-candidate-bf16",
             "--topk", "100"]
    _run_cli(["search", *flags, "--output", f"{root}/par_one.trec"],
             verb="search")
    p = _torchrun(["-m", "dhr_tpu_torch", "search", *flags, "--output",
                   f"{root}/par_sharded.trec", "--shard-over-devices",
                   "--dist-backend", "gloo"], 600)
    timing = _timing_line(p.stderr, "search")
    cmp = _compare_runs(_read_run(f"{root}/par_sharded.trec"),
                        _read_run(f"{root}/par_one.trec"), list(qids[:k]),
                        1e-6)
    out = {"queries": k, "vs_one_process": cmp, "shards": timing["shards"]}
    if timing["shards"] != PARALLEL_RANKS or cmp["scores_equal"] != k \
            or cmp["ids_equal_up_to_ties"] != k:
        raise AssertionError(f"sharded search CLI: {out}")
    return out


def _sharded_serve(root, index_path, queries, torch):
    """(c): ``serve --shard-over-devices`` as two rank processes (the
    launcher's environment set here, so SIGINT reaches rank 0 alone):
    64 single-query requests, 8 at a time, each equal to ``search_run``
    on one process; /stats reports the shards; SIGINT stops both."""
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from dhr_tpu_torch.retrieval import (
        DeviceIndex, PackedIndex, SearchConfig, Searcher)

    qv, qi, qids = queries
    k = PARALLEL_SERVE_REQUESTS
    cfg = SearchConfig(topk=100, theta=0.1, rerank=True, agip_topk=10000,
                       approx_candidates=False, candidate_bf16=False,
                       query_batch=8)
    direct = Searcher(DeviceIndex.from_packed(PackedIndex.load(index_path),
                                              device="cuda"), cfg)
    want_r, want_s = direct.search_run(list(qids[:k]), qv[:k], qi[:k])
    del direct
    torch.cuda.empty_cache()
    port, master = _free_port(), _free_port()
    procs = []
    for r in range(PARALLEL_RANKS):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(PARALLEL_RANKS), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(master))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dhr_tpu_torch", "serve", "--index-path",
             index_path, "--port", str(port), "--theta", "0.1", "--rerank",
             "--agip-topk", "10000", "--topk", "100", "--exact-candidates",
             "--no-candidate-bf16", "--query-batch", "8", "--micro-batch-ms",
             "2", "--shard-over-devices", "--dist-backend", "gloo"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = {}
    try:
        deadline = time.time() + 240
        while True:
            try:
                _http(port, "/healthz", timeout=5)
                break
            except OSError:
                if time.time() > deadline or any(
                        p.poll() is not None for p in procs):
                    raise AssertionError("the sharded service did not "
                                         "start")
                time.sleep(0.5)

        def one(i):
            return (qids[i],) + _http(port, "/search", {
                "values": qv[i:i + 1].tolist(),
                "indices": qi[i:i + 1].tolist(),
                "qids": [qids[i]]})[:2]

        with ThreadPoolExecutor(8) as pool:
            done = list(pool.map(one, range(k)))
        out["requests"] = _served_equal(done, want_r, want_s)
        _, stats, _ = _http(port, "/stats")
        out["sharded_over"] = stats["sharded_over"]
        out["micro_batches_run"] = stats["micro_batches_run"]
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGINT)
        codes = []
        for p in procs:
            try:
                p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
            codes.append(p.returncode)
    out["exit_codes"] = codes
    if out.get("sharded_over") != PARALLEL_RANKS or codes != [0] * len(
            codes):
        raise AssertionError(f"sharded serve: {out}")
    return out


def parallel_reference(searcher, queries, torch):
    """What parallel_path holds the shards against, from the main path's
    one-process searcher: the exact-candidate results (f32, one top-k) of
    its first queries and the brute-force rows."""
    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    cfg = dataclasses.replace(searcher.config, approx_candidates=False,
                              candidate_bf16=False,
                              query_batch=PARALLEL_AGREE)
    xs, xr = Searcher(searcher.index, cfg, device=searcher.device).search(
        qv[:PARALLEL_AGREE], qf[:PARALLEL_AGREE])
    return {"qv": qv.cpu().numpy(), "qf": qf.cpu().numpy(), "erows": erows,
            "x_scores": xs, "x_rows": xr}


def phase_parallel_path(args, root, index_path, dense_queries, ref, smi,
                        torch):
    """Two ranks share the card over gloo: (a) the bench-point search over
    the MS MARCO-sized corpus, each rank holding half (plus the fused path
    and the exact candidates against one process), (b) the DP step of the
    DistilBERT-base DHR model, (d) Encoder(mesh=) (all three in one
    torchrun job), then ``search --shard-over-devices`` through the CLI and
    (c) the sharded service, both on the densified index.  Returns the
    kernel launches of (a)'s paths, summed over the ranks."""
    import numpy as np

    job = os.path.join(root, "parallel_job")
    os.makedirs(job, exist_ok=True)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"rows": args.rows, "seed": args.seed, "dir": job}, f)
    np.savez(os.path.join(job, "queries.npz"), **ref)
    secs, out = {}, {"phase": "parallel_path", "card": smi,
                     "ranks": PARALLEL_RANKS, "backend": "gloo"}
    t = time.perf_counter()
    _torchrun([os.path.abspath(__file__), "--parallel-worker", job], 900)
    secs["torchrun_job"] = time.perf_counter() - t
    ranks = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["ranks_detail"] = ranks
    for res in ranks:
        for k, a in res["search"]["staged_vs_exact"].items():
            if a < SHARDED_AGREEMENT[k]:
                raise AssertionError(
                    f"sharded staged-vs-exact agreement@{k} = {a} < "
                    f"{SHARDED_AGREEMENT[k]}")
        for k, a in res["search"]["fused_staged_vs_exact"].items():
            if a < 0.99:
                raise AssertionError(f"sharded fused agreement@{k} = {a}")
        x = res["search"]["exact_candidates_vs_one_process"]
        if x["scores_equal_rtol_1e-6"] != PARALLEL_AGREE \
                or x["ids_equal_up_to_ties"] != PARALLEL_AGREE:
            raise AssertionError(f"sharded exact candidates vs one "
                                 f"process: {x}")
    t = time.perf_counter()
    out["search_cli"] = _sharded_search_cli(root, index_path, dense_queries)
    secs["search_cli"] = time.perf_counter() - t
    t = time.perf_counter()
    out["serve"] = _sharded_serve(root, index_path, dense_queries, torch)
    secs["serve"] = time.perf_counter() - t
    out["seconds"] = secs
    emit(out)
    launches = {k: 0 for k in _counters()}
    for res in ranks:
        for key in ("launches", "fused_launches"):
            for k, v in res["search"][key].items():
                launches[k] += v
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=MSMARCO_PASSAGES,
                    help="corpus rows of the main path (default: the MS "
                         "MARCO passage count)")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parallel-worker", default=None,
                    help=argparse.SUPPRESS)  # one rank of parallel_path
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import dhr_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    pkg = os.path.dirname(os.path.abspath(dhr_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        print(f"chip_smoke: dhr_tpu_torch comes from {pkg}, not from this "
              "checkout", file=sys.stderr)
        return 1
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)

    walls, t_start = {}, time.perf_counter()

    def timed(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[label] = time.perf_counter() - t
        return out

    name, smi = phase_device(torch)
    timed("build", phase_build)
    encode_launches = timed("encode_path", phase_encode_path, args, torch)
    timed("train_path", phase_train_path, args, torch)
    with tempfile.TemporaryDirectory() as root:
        rehearsal_launches = timed("rehearsal_path", phase_rehearsal_path,
                                   args, root, torch)
        paths, densify_launches = timed("densify_path", phase_densify_path,
                                        args, root, torch)
        eval_launches = timed("eval_path", phase_eval_path, args, root,
                              torch)
        family_launches = timed("family_path", phase_family_path, args,
                                root, smi, torch)
        bert_launches = timed("bert_path", phase_bert_path, args, root,
                              smi, torch)
        t = time.perf_counter()
        index, queries, raw = small_world(args.seed + 1, torch)
        errs = (phase_k1(index, queries, torch),
                phase_k2(index, queries, args.seed, torch),
                phase_k3(index, queries, torch))
        k4 = phase_k4(torch)
        k5 = phase_k5(torch)
        k6 = phase_k6(torch)
        k7 = phase_kimi(torch)
        k8 = phase_nemotron(torch)
        phase_search_vs_plain(index, raw, torch)
        phase_modes(index, raw, torch)
        del index, queries, raw
        torch.cuda.empty_cache()
        walls["kernels_vs_plain_and_modes"] = time.perf_counter() - t
        t = time.perf_counter()
        searcher, batch, launches, main_queries = phase_main(args, torch)
        launches["gip_candidates"] = phase_fused(searcher, main_queries,
                                                 torch)["gip_candidates"]
        phase_modes_full(searcher, main_queries, torch)
        walls["main_fused_modes_full"] = time.perf_counter() - t
        serve_launches = timed("serve_path", phase_serve_path, args, root,
                               paths, searcher, main_queries, smi, torch)
        # the kernels line counts every path: encode, main, fused,
        # rehearsal, densify, eval, family, bert, serve and parallel
        for k in launches:
            launches[k] += (encode_launches[k]
                            + rehearsal_launches[k] + densify_launches[k]
                            + eval_launches[k] + family_launches[k]
                            + bert_launches[k] + serve_launches[k])
        kernels = timed("timing", phase_timing, searcher, batch, launches,
                        errs, torch)
        kernels.append({"name": "lexical_pool", "route": "cuda",
                        "source": K4_SOURCE, "replaces": None,
                        "launches": launches["lexical_pool"], **k4})
        kernels.append({"name": "moe_combine", "route": "cuda",
                        "source": K5_SOURCE, "replaces": None,
                        "launches": launches["moe_combine"], **k5})
        kernels.append({"name": "mla_attention", "route": "cuda",
                        "source": K6_SOURCE, "replaces": None,
                        "launches": launches["mla_attention"], **k6})
        kernels.append({"name": "kda_scan", "route": "cuda",
                        "source": K7_SOURCE, "replaces": None,
                        "launches": launches["kda_scan"], **k7})
        kernels.append({"name": "ssd_scan", "route": "cuda",
                        "source": K8_SOURCE, "replaces": None,
                        "launches": launches["ssd_scan"], **k8})
        ref = parallel_reference(searcher, main_queries, torch)
        # the ranks hold the index (half each): free the parent's first
        del searcher, batch, main_queries
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        parallel_launches = timed(
            "parallel_path", phase_parallel_path, args, root,
            paths["index"], paths["queries"], ref, smi, torch)
        del paths
    for kern in kernels:
        kern["launches"] += parallel_launches[kern["name"]]
    walls["total"] = time.perf_counter() - t_start
    emit({"phase": "walls", "seconds": walls})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
