#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (dhr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--queries Q] [--seed S]

Run from the root of a checkout.  It builds the CUDA kernels from
``dhr_tpu_torch/csrc`` (nvcc, sm_90a, into ``build/kernels/``), holds each
against its plain PyTorch version on the card, then runs two paths over one
synthetic MS MARCO-sized corpus through the entry points a user calls
(``DeviceIndex.from_arrays``, ``Searcher.search``), both at the bench
operating point (int8 planes, theta=0.3, 48 important dims, a 10,000-row
pool, exact rerank, top 1000):

- the main path: theta pass (K1), candidate selection, rerank (K2);
- the fused path: theta pass reduced per 8-row group (K3), selection over
  the reduced plane with arithmetic row decoding, rerank (K2).

Before the search phases, ``encode_path`` runs the encode slice at
DistilBERT-base width with random weights (no checkpoint is in the
repository): the card against the CPU in f32, then the user's path through
the CLI (``encode`` a 65,536-passage corpus and 1,024 queries, ``index
--quantize``, ``search`` at the bench point, K1 and K2 launched), then the
``Encoder``'s passages/s, stage times and achieved TFLOP/s.

``train_path`` follows: the same model trains on the card (its random tree
written as an HF directory and imported by ``train``): one f32 step on the
card against the CPU, the packed and grad-cache steps against the plain one,
the documented run (batch 24 x 8 passages, lr 7e-6, bf16) for 40 steps
through the CLI and again cut at step 20 and resumed (losses must agree,
and the loss must fall), the trained export through ``encode`` -> ``index
--quantize`` -> ``search`` (K1 and K2 launched), ``encode --pack`` against
plain, and the steps' speed (steps/s, passages/s, tokens/s, TFLOP/s, the
split of a step, peak memory).

It checks each path's kernel launch counts and its staged-vs-exact ranking
agreement.  On a 204,803-row slice it also holds the other search modes
(row-chunked ip, pq, two-tier escalation) on the card against the same
search on the CPU's plain path, and on the full index it times ip (dim- and
row-major) and pq (m=64) with rerank.

Each phase prints one JSON line; the card's name and power limit (as
nvidia-smi gives them) and the ``{"kernels": [...]}`` line come before the
last line, ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the last line.  Without CUDA, or outside a checkout, it
exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

MSMARCO_PASSAGES = 8_841_823
LEX_DIM = 768
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TPU_AGREEMENT = {"10": 1.0, "100": 0.9994, "1000": 0.9969}  # BENCH_r05.json
K1_SOURCE = "dhr_tpu_torch/csrc/partial_gip.cu"
K2_SOURCE = "dhr_tpu_torch/csrc/rerank_gip.cu"
K3_SOURCE = "dhr_tpu_torch/csrc/gip_candidates.cu"
SMALL_ROWS = 204_803
H100_BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
ENCODE_PASSAGES = 65_536
ENCODE_QUERIES = 1_024
ENCODE_REMOVE_DIMS = 570
TRAIN_QUERIES = 2_048
TRAIN_NEGATIVES = 32
TRAIN_STEPS = 40
# the documented DHR run, docs/pipeline.md:25-30
TRAIN_FLAGS = ["--train-n-passages", "8", "--batch-size", "24",
               "--learning-rate", "7e-6", "--p-max-len", "128",
               "--q-max-len", "32", "--bf16"]


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
    reports = _build.build(["partial_gip", "rerank_gip", "gip_candidates"])
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


def _run_cli(argv, verb=None):
    """``python -m dhr_tpu_torch <argv>`` in this process; the DHR_TIMING
    line of ``verb`` when given."""
    import contextlib
    import io

    from dhr_tpu_torch.cli.main import main as cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli(argv)
    sys.stderr.write(err.getvalue())
    return _timing_line(err.getvalue(), verb) if verb else None


def _read_run(path):
    out = {}
    with open(path) as f:
        for line in f:
            q, _, doc, _, score, _ = line.split()
            out.setdefault(q, []).append((doc, float(score)))
    return out


def _encode_user_path(root, seed, torch, np):
    """encode (corpus, bf16, batch 32) -> encode --encode-is-qry -> index
    --quantize -> search at the bench point, through the CLI; K1 and K2
    must launch.  Then the exact brute force for the agreement."""
    from dhr_tpu_torch.data.examples import write_jsonl

    rng = np.random.default_rng(seed + 4)
    toks, lens = _passage_tokens(rng, ENCODE_PASSAGES, np)
    corpus, queries = f"{root}/corpus.jsonl", f"{root}/queries.jsonl"
    write_jsonl(corpus, ({"text_id": str(i), "text": t.tolist()}
                         for i, t in enumerate(toks)))
    q_lens = rng.integers(4, 21, ENCODE_QUERIES)
    write_jsonl(queries, ({"text_id": f"q{i}", "text": rng.integers(
        ENCODE_REMOVE_DIMS, 30522, n).tolist()} for i, n in enumerate(q_lens)))
    model = ["--model", "dhr", "--add-pooler", "--projection-dim", "128",
             "--dlr-out-dim", str(LEX_DIM), "--batch-size", "32"]
    search = ["search", "--index-path", f"{root}/index.npz", "--query-path",
              f"{root}/q.npz", "--topk", "1000", "--query-batch", "128"]
    reset_launches()
    t_p = _run_cli(["encode", *model, "--input", corpus, "--output",
                    f"{root}/corpus.npz"], "encode")
    t_q = _run_cli(["encode", *model, "--input", queries, "--output",
                    f"{root}/q.npz", "--encode-is-qry"], "encode")
    _run_cli(["index", "--inputs", f"{root}/corpus.npz", "--output",
              f"{root}/index.npz", "--quantize"])
    t_s = _run_cli([*search, "--theta", "0.3", "--max-important-dims", "48",
                    "--agip-topk", "10000", "--rerank", "--output",
                    f"{root}/run.trec"], "search")
    launches = read_launches()
    if not (launches["partial_gip"] > 0 and launches["rerank_gip"] > 0):
        raise AssertionError(f"encode path launches {launches}: K1 and K2 "
                             "must launch")
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
        "passages_per_s_cli_b32": t_p["items_per_s"],
        "encode_wall_s_cli_b32": t_p["encode_wall_s"],
        "queries_per_s_cli_encode": t_q["items_per_s"],
        "search_qps": t_s["qps"], "launches": launches,
        "exact_launches": exact_launches, "planes": shapes,
        "staged_vs_brute_force_informative_only": agree,
    }, toks


def transformer_flops_per_token(L: int) -> int:
    """Six layers of projections and FFN, plus attention's two L-long
    products, per padded token of DistilBERT-base."""
    H, F = 768, 3072
    return 2 * 6 * (4 * H * H + 2 * H * F) + 6 * 4 * L * H


def head_flops_per_token() -> int:
    """The MLM transform and the vocabulary projection, per position."""
    H, Vv = 768, 30522
    return 2 * (H * H + H * Vv)


def encode_flops_per_token(L: int) -> int:
    """Forward FLOPs per padded token of the DHR DistilBERT-base encoder."""
    return transformer_flops_per_token(L) + head_flops_per_token()


def _encode_timing(tree, toks, torch, np):
    """Passages/s through the Encoder API at batch 32 and 256, padded to
    128 and length-bucketed; per-batch stage ms (CUDA events) of the first
    batch; peak memory; achieved TFLOP/s."""
    from dhr_tpu_torch.data.collate import collate_encode, wrap_specials
    from dhr_tpu_torch.encode import (
        EncodeConfig, Encoder, bucketed_encode_batches)
    from dhr_tpu_torch.models import BiEncoder, load_flax_params

    cfg = _dhr_config(torch.bfloat16)
    model = load_flax_params(BiEncoder(cfg), tree)
    lists = [t.tolist() for t in toks]
    ids = [str(i) for i in range(len(lists))]
    out = {"passages": len(lists), "dtype": "bf16",
           "peak_tflops_dense_bf16": H100_BF16_FLOPS_PER_S / 1e12}
    for bs in (32, 256):
        enc = Encoder(model, cfg, EncodeConfig(batch_size=bs))
        for bucketed in (False, True):
            if bucketed:
                batches, _ = bucketed_encode_batches(ids, lists, bs, 128,
                                                     101, 102)
                batches = list(batches)
            else:
                batches = [collate_encode(
                    ids[s:s + bs], [wrap_specials(t, 128, 101, 102)
                                    for t in lists[s:s + bs]], 128)
                    for s in range(0, len(lists), bs)]
            flops = sum(b["input_ids"].size * encode_flops_per_token(
                b["input_ids"].shape[1]) for b in batches)
            enc.encode_corpus(batches[:2])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            packed = enc.encode_corpus(batches)
            wall = time.perf_counter() - t0
            if packed.values.shape != (len(lists), LEX_DIM + 128):
                raise AssertionError("Encoder planes of the wrong shape")
            name = f"b{bs}_{'bucketed' if bucketed else 'padded128'}"
            out[name] = {
                "passages_per_s": len(lists) / wall, "wall_s": wall,
                "padded_tokens": int(sum(b["input_ids"].size
                                         for b in batches)),
                "tflops_achieved": flops / wall / 1e12,
                "share_of_bf16_peak": flops / wall / H100_BF16_FLOPS_PER_S,
                "flop_bound_s": flops / H100_BF16_FLOPS_PER_S,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
        # stage ms of one padded batch
        b = collate_encode(ids[:bs], [wrap_specials(t, 128, 101, 102)
                                      for t in lists[:bs]], 128)
        x = torch.from_numpy(b["input_ids"]).cuda()
        m = torch.from_numpy(b["attention_mask"]).cuda()
        e = enc.model.encoder("passage")
        with torch.inference_mode():
            hidden = e.hidden_states(x, m)
            reps = e.reps(hidden, x, m)
            stage = {
                "transformer": cuda_ms(lambda: e.hidden_states(x, m), 5,
                                       torch),
                "mlm_head_softmax_max": cuda_ms(lambda: e.reps(hidden, x, m),
                                                5, torch),
                "densify_pack_copy_back": cuda_ms(
                    lambda: [t.cpu() for t in enc.planes(reps)
                             if t is not None], 5, torch),
            }
        # the head runs on positions 1..127; its composite passes over the
        # (B, 127, V) plane: logits written (bf16), the bias add read and
        # written (bf16), softmax read (bf16) and written (f32), the
        # weighting read and written (f32), the max read (f32)
        t_flops = bs * 128 * transformer_flops_per_token(128)
        h_flops = bs * 127 * head_flops_per_token()
        stage.update({
            "transformer_tflops": t_flops / stage["transformer"] / 1e9,
            "transformer_flop_bound_ms": t_flops / H100_BF16_FLOPS_PER_S
            * 1e3,
            "head_tflops": h_flops / stage["mlm_head_softmax_max"] / 1e9,
            "head_flop_bound_ms": h_flops / H100_BF16_FLOPS_PER_S * 1e3,
            "head_plane_passes_gb": bs * 127 * 30522 * (2 + 4 + 6 + 8 + 4)
            / 1e9,
        })
        out[f"b{bs}_stage_ms_per_batch_padded128"] = stage
        out[f"b{bs}_split_ms_padded128"] = _encode_split(e, hidden, x, m,
                                                         torch)
        del enc, hidden, reps
        torch.cuda.empty_cache()
    return out


def _encode_split(e, hidden, x, m, torch):
    """Where a padded batch's device time goes, by CUDA events: one layer
    and its attention; the head's passes one by one (the logits GEMM with
    its bias add, the f32 softmax, the weighting, the max over positions);
    and the host's time to enqueue the whole transformer, which, near its
    device time, says the host holds the card back."""
    import torch.nn.functional as F

    layer = e.backbone.encoder.layers[0]
    bias = torch.where(m[:, None, None, :] > 0, 0.0, -1e9).to(hidden.dtype)
    with torch.inference_mode():
        logits = e.backbone.logits(hidden[:, 1:])
        probs = torch.softmax(logits, dim=-1, dtype=torch.float32)
        w = (e.term_weight(hidden[:, 1:]).float()
             * m[:, 1:, None].float())
        split = {
            "one_layer": cuda_ms(lambda: layer(hidden, bias), 5, torch),
            "one_layer_attention": cuda_ms(
                lambda: layer.attention(hidden, bias), 5, torch),
            "one_layer_ffn_gelu": cuda_ms(
                lambda: layer.ffn_out(F.gelu(layer.ffn_in(hidden))), 5,
                torch),
            "head_logits_and_bias": cuda_ms(
                lambda: e.backbone.logits(hidden[:, 1:]), 5, torch),
            "head_softmax_f32": cuda_ms(
                lambda: torch.softmax(logits, dim=-1, dtype=torch.float32),
                5, torch),
            "head_weighting": cuda_ms(lambda: probs.mul_(w), 5, torch),
            "head_max_over_positions": cuda_ms(
                lambda: probs.amax(dim=-2), 5, torch),
        }
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.hidden_states(x, m)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    split["transformer_host_enqueue_ms"] = sorted(host)[2]
    return split


def phase_encode_path(args, torch):
    """The encode slice at DistilBERT-base width (6 x 768, vocab 30522, the
    DHR head: 768 lexical dims + a 128-dim CLS projection), random weights
    from ``--seed`` in the Flax layout loaded by ``load_flax_params``:
    card against CPU, the user path through the CLI (encode -> index ->
    search, K1 and K2 launched), and the Encoder's speed."""
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
    timing = _encode_timing(tree, toks, torch, np)
    emit({"phase": "encode_path", "model": "distilbert-base DHR "
          "(6x768, vocab 30522, remove_dims 570, 768 + 128 dims)",
          "weights": f"random, seed {args.seed}", "card_vs_cpu": parity,
          "user_path": user, "timing": timing,
          "seconds": {"card_vs_cpu": t1 - t0, "user_path": t2 - t1,
                      "timing": time.perf_counter() - t2}})
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# train_path: the train slice at DistilBERT-base width
# --------------------------------------------------------------------------


def _train_data(root, seed, np):
    """The corpus of ``encode_path``'s kind (65,536 passages) and 2,048
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
    same two passes at the plain shapes, holds 1e-3)."""
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
    for name, fn, _ in runs:
        model.zero_grad(set_to_none=True)
        if isinstance(fn, tuple):
            loss = grad_cache_backward(model, cfg, loss_cfg, plain, 0, 0, *fn)
        else:
            loss = fn()
            loss.backward()
        losses[name] = loss.item()
        grads[name] = _grads(model)
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
    t = {}
    t["straight"] = _run_cli([*common, "--output-dir", f"{root}/a",
                              "--max-steps", str(TRAIN_STEPS),
                              "--metrics-path", f"{root}/a.jsonl"], "train")
    for name, steps in (("cut", TRAIN_STEPS // 2), ("resumed", TRAIN_STEPS)):
        t[name] = _run_cli([*common, "--output-dir", f"{root}/b",
                            "--max-steps", str(steps), "--metrics-path",
                            f"{root}/b.jsonl"], "train")
    a, b = _metrics_losses(f"{root}/a.jsonl"), _metrics_losses(
        f"{root}/b.jsonl")
    rel = np.abs(np.subtract(a, b)) / np.abs(a)
    first, last = float(np.mean(a[:10])), float(np.mean(a[-10:]))
    res = {"steps": len(a), "losses": a, "resumed_losses": b,
           "resume_max_rel_diff": float(rel.max()),
           "resume_bit_equal_steps": int((np.asarray(a) == np.asarray(b))
                                         .sum()),
           "loss_first10_mean": first, "loss_last10_mean": last,
           "cli_wall_s": {k: v["train_wall_s"] for k, v in t.items()},
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
    t_b = _run_cli(["encode", *model, *corpus, "--length-bucketing",
                    "--output", f"{root}/corpus.npz"], "encode")
    t_q = _run_cli(["encode", *model, "--input", f"{root}/queries.jsonl",
                    "--output", f"{root}/q.npz", "--encode-is-qry"],
                   "encode")
    _run_cli(["index", "--inputs", f"{root}/corpus.npz", "--output",
              f"{root}/index.npz", "--quantize"])
    reset_launches()
    t_s = _run_cli(["search", "--index-path", f"{root}/index.npz",
                    "--query-path", f"{root}/q.npz", "--topk", "1000",
                    "--query-batch", "128", "--theta", "0.3",
                    "--max-important-dims", "48", "--agip-topk", "10000",
                    "--rerank", "--output", f"{root}/run.trec"], "search")
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
    t_p = _run_cli(["encode", *model, *corpus, "--pack", "--pack-segments",
                    "8", "--batch-size", "64", "--output",
                    f"{root}/packed.npz"], "encode")
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
    return {"encode_passages_per_s_bucketed_b256": t_b["items_per_s"],
            "encode_passages_per_s_packed_64rows_8seg": t_p["items_per_s"],
            "queries_per_s_encode": t_q["items_per_s"],
            "search_qps": t_s["qps"], "launches": launches,
            "packed_vs_bucketed": pack}


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


def _timed_batches(groups, toks, n, torch, packed=False):
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
        raise AssertionError("packed timing batches differ in shape")
    return batches


def _plain_step_split(step_for, model, state, batch, torch):
    """``make_train_step``'s own step by parts, by CUDA events at its phase
    marks (``on_phase``) and at the transformer stack's calls (forward
    hooks: the queries', then the passages'); the backward splits where
    autograd reaches the passages' hidden states (a tensor hook): before
    it, the loss and the passages' head (with whatever of the small query
    tower autograd interleaves); after it, the transformers.  And the
    host's time to enqueue that step.  Median of 5 after a warm-up."""
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    enc = model.encoder("passage")
    stack = enc.backbone.encoder if enc.cfg.needs_mlm else enc.backbone
    nth = 1 if enc.cfg.untie_encoder else 2  # the passages' call
    calls = []

    def pre(mod, args):
        calls.append(None)
        if len(calls) == nth:
            mark("passage_in")

    def post(mod, args, hidden):
        if len(calls) == nth:
            mark("passage_out")
            hidden.register_hook(lambda g: mark("backward_transformers_in"))

    hooks = [stack.register_forward_pre_hook(pre),
             stack.register_forward_hook(post)]
    step_fn = step_for(mark)
    bounds = (("start", "passage_in", "forward_queries"),
              ("passage_in", "passage_out", "forward_passage_transformer"),
              ("passage_out", "forward", "forward_passage_head"),
              ("forward", "loss", "loss"),
              ("loss", "backward_transformers_in",
               "backward_loss_and_passage_head"),
              ("backward_transformers_in", "backward",
               "backward_transformers"),
              ("backward", "optimizer", "optimizer"))
    parts = {k: [] for _, _, k in bounds}
    host = []
    for i in range(6):
        ev.clear()
        calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mark("start")
        step_fn(state, batch, 0)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            for a, b, k in bounds:
                parts[k].append(ev[a].elapsed_time(ev[b]))
    for h in hooks:
        h.remove()
    split = {k: statistics.median(v) for k, v in parts.items()}
    return {"plain_step_split_ms": split,
            "plain_step_device_ms": sum(split.values()),
            "plain_step_host_enqueue_ms": statistics.median(host[1:])}


def _train_timing(tree, groups, toks, torch):
    """Steps/s, passages/s and tokens/s of the plain (padded to 128),
    packed (one row count for all its batches) and grad-cache steps in
    bf16 at batch 24 (dropout 0.1, the documented lr): wall time over 30
    steps after 3 warm-up steps on batches of the timed shapes, and the
    spread of the steps (CUDA events between steps, no host wait between
    them); the host's time to issue a step of each kind, the card idle
    before it (median of 5); one plain step of ``make_train_step`` split
    into forward / loss / backward / optimizer by CUDA events
    (:func:`_plain_step_split`); training FLOPs = 3x the forward FLOPs of
    the padded shapes (``encode_flops_per_token`` at L = 128 for passages,
    32 for queries); peak memory."""
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
    n_warm, n_timed = 3, 30
    q_flops = 24 * 32 * encode_flops_per_token(32)
    out = {"batch": 24, "passages_per_step": 192, "dtype": "bf16",
           "timed_steps": n_timed, "warm_up_steps": n_warm,
           "peak_tflops_dense_bf16": H100_BF16_FLOPS_PER_S / 1e12}
    modes = (
        ("plain_padded128", make_train_step(model, cfg, loss_cfg), False),
        ("packed", make_packed_train_step(model, cfg, loss_cfg), True),
        ("grad_cache_4q_8p", make_grad_cache_train_step(model, cfg,
                                                        loss_cfg, 4, 8),
         False),
    )
    for name, step_fn, packed in modes:
        batches = _timed_batches(groups, toks, n_warm + n_timed, torch,
                                 packed)
        timed = [b.get("packed_passage", b.get("passage"))
                 for b in batches[n_warm:]]
        p_tokens = sum(pp["input_ids"].size for pp in timed) / n_timed
        real = sum(int((pp["segment_ids"] > 0).sum()) if "segment_ids" in pp
                   else int(pp["attention_mask"].sum())
                   for pp in timed) / n_timed
        q_real = sum(int(b["query"]["attention_mask"].sum())
                     for b in batches[n_warm:]) / n_timed
        for b in batches[:n_warm]:
            step_fn(state, b, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
        t0 = time.perf_counter()
        ev[0].record()
        for b, e in zip(batches[n_warm:], ev[1:]):
            loss = step_fn(state, b, 0)
            e.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_timed
        steps = sorted(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))
        host = []  # the host's time to issue a step, the card idle before
        for b in batches[n_warm:n_warm + 5]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, b, 0)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        flops = 3 * (q_flops + p_tokens * encode_flops_per_token(128))
        out[name] = {
            "steps_per_s": 1 / wall, "ms_per_step": wall * 1e3,
            "step_ms_median": statistics.median(steps),
            "step_ms_min": steps[0], "step_ms_max": steps[-1],
            "step_ms_stdev": statistics.stdev(steps),
            "host_ms_per_step_median": statistics.median(host),
            "passages_per_s": 192 / wall,
            "padded_tokens_per_s": (24 * 32 + p_tokens) / wall,
            "passage_tokens_per_step": p_tokens,
            "real_passage_tokens_per_step": real,
            "real_tokens_per_s": (q_real + real) / wall,
            "train_tflops_3x_forward": flops / wall / 1e12,
            "share_of_bf16_peak": flops / wall / H100_BF16_FLOPS_PER_S,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "last_loss": loss.item()}
        if packed:
            out[name]["packed_rows"] = int(timed[0]["input_ids"].shape[0])
        if not math.isfinite(out[name]["last_loss"]):
            raise AssertionError(f"{name}: the loss is not finite")
    out.update(_plain_step_split(
        lambda mark: make_train_step(model, cfg, loss_cfg, on_phase=mark),
        model, state, _timed_batches(groups, toks, 1, torch)[0], torch))
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
    encode, and the steps' speed."""
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
            ("timing", lambda: _train_timing(tree, groups, toks, torch)),
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


def phase_search_vs_plain(index, queries_raw, torch):
    """The whole search on the card against the same search on the CPU's
    plain PyTorch path, over the 204,803-row corpus: same final scores at
    each rank, same rows apart from ties at the candidate pool's edge."""
    import numpy as np

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
    t0 = time.perf_counter()
    packed = floats.quantize_pq(m=64, device="cuda")
    out["pq_build_s"] = time.perf_counter() - t0
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
    q/s (one warm-up, three timed passes of the main path's queries), peak
    memory, launches (K2 only) and agreement with the exact search."""
    import numpy as np

    from dhr_tpu_torch.ops.pq import train_encode_pq
    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    idx = searcher.index
    row = dataclasses.replace(idx, values_T=None, indices_T=None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes, centroids = train_encode_pq(idx.values, 64,
                                       value_scales=idx.value_scales)
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t0
    pq = dataclasses.replace(row, pq_codes=codes, pq_centroids=centroids)
    base = searcher.config
    n_passes = 4  # one warm-up, three timed
    out = {"phase": "modes_full", "rows": idx.num_rows,
           "queries": int(qv.shape[0]), "query_batch": base.query_batch,
           "pq_build_s": pq_build_s}
    for name, index, mode in (("ip_dim_major", idx, "ip"),
                              ("ip_row_chunked", row, "ip"),
                              ("pq_m64", pq, "pq")):
        s = Searcher(index, dataclasses.replace(base, mode=mode))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        qps, scores, rows = timed_passes(s, qv, qf, n_passes - 1)
        launches = read_launches()
        want = {"partial_gip": 0, "gip_candidates": 0,
                "rerank_gip": n_passes * -(-qv.shape[0] // base.query_batch)}
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, expected "
                                 f"{want}")
        check_result(scores, rows, qv.shape[0], base.topk, idx.num_rows)
        out[name] = {"qps_median": float(np.median(qps)), "qps_passes": qps,
                     "row_chunks": s._row_chunks, "launches": launches,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "staged_vs_exact": agreement(rows[:erows.shape[0]],
                                                  erows)}
        del s, scores, rows
    emit(out)


def agreement(staged, exact, ks=(10, 100, 1000)):
    import numpy as np

    return {str(k): float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
        for a, b in zip(staged, exact)])) for k in ks}


def _counters():
    from dhr_tpu_torch.ops.gip_candidates import gip_candidates
    from dhr_tpu_torch.ops.partial_gip import partial_gip
    from dhr_tpu_torch.ops.rerank_gip import rerank_gip

    return {"partial_gip": partial_gip, "rerank_gip": rerank_gip,
            "gip_candidates": gip_candidates}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def timed_passes(searcher, qv, qf, n_passes):
    """One warm-up pass, then ``n_passes`` timed: ``(q/s list, scores,
    rows)`` of the last pass."""
    searcher.search(qv, qf)
    qps = []
    for _ in range(n_passes):
        t = time.perf_counter()
        scores, rows = searcher.search(qv, qf)
        qps.append(qv.shape[0] / (time.perf_counter() - t))
    return qps, scores, rows


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
    """The main path at full width and the given row count."""
    import numpy as np

    from dhr_tpu_torch.retrieval import DeviceIndex, SearchConfig, Searcher
    from dhr_tpu_torch.retrieval.synth import synth_index_planes, synth_reps

    t0 = time.perf_counter()
    v, f, scales, _ = synth_index_planes(args.seed, args.rows, device="cuda")
    index = DeviceIndex.from_arrays(
        v, f, np.arange(args.rows).astype(str), LEX_DIM, scales,
        device="cuda")
    del v, f
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qv, qf, _ = synth_reps(args.seed, args.queries, role="query", stream=1,
                           device="cuda")
    above = (qv[:, :LEX_DIM] > 0.3).sum(dim=1).float()
    cfg = SearchConfig(topk=1000, theta=0.3, rerank=True, agip_topk=10000,
                       max_important_dims=48, query_batch=128)
    searcher = Searcher(index, cfg)

    n_passes = 6  # one warm-up, five timed
    reset_launches()
    qps, scores, rows = timed_passes(searcher, qv, qf, n_passes - 1)
    launches = read_launches()
    want_launches = n_passes * -(-args.queries // cfg.query_batch)
    emit({"phase": "kernels", "path": "main", "launches": launches,
          "expected": {"partial_gip": want_launches,
                       "rerank_gip": want_launches, "gip_candidates": 0}})
    if launches != {"partial_gip": want_launches,
                    "rerank_gip": want_launches, "gip_candidates": 0}:
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
                          "gip_candidates": 0}:
        raise AssertionError(f"exact search launches {exact_launches}, "
                             "expected K1 once, K2 and K3 never")
    agree = agreement(rows[:n_agree], erows)

    # per-stage device times of the first batch (CUDA events)
    bs = cfg.query_batch
    qvb, qv1b, qib = searcher.prepare_queries(qv[:bs], qf[:bs])
    scores = searcher.stage1(qv1b, qib)
    _, cand = searcher.select(scores)
    stage_ms = {
        "theta_kernel_k1": cuda_ms(lambda: searcher.stage1(qv1b, qib), 3,
                                   torch),
        "candidate_select": cuda_ms(lambda: searcher.select(scores), 3,
                                    torch),
        "rerank_k2_and_topk": cuda_ms(
            lambda: searcher.stage2(qvb, qib, cand), 3, torch),
    }
    emit({
        "phase": "main_path", "rows": args.rows,
        "rows_full_size": args.rows == MSMARCO_PASSAGES,
        "queries": args.queries, "query_batch": bs,
        "index_build_s": build_s,
        "index_bytes": sum(t.untyped_storage().nbytes() for t in (
            index.values, index.values_T, index.indices, index.indices_T)),
        "qps_median": float(np.median(qps)), "qps_passes": qps,
        "stage_ms_first_batch": stage_ms,
        "query_dims_above_theta_mean": float(above.mean()),
        "frac_queries_above_scan_cap": float((above > 48).float().mean()),
        "staged_vs_exact": agree, "agreement_queries": n_agree,
        "tpu_v5e_reference_agreement_not_this_card": TPU_AGREEMENT,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    for k, a in agree.items():
        if a < 0.99:
            raise AssertionError(f"staged-vs-exact agreement@{k} = {a} < 0.99")
    del exact, scores
    return searcher, (qvb, qv1b, qib, cand), launches, (qv, qf, erows)


def phase_fused(searcher, queries, torch):
    """The fused path on the main path's index and queries: K3 (G=8, packed
    ids) in place of K1 + selection over the full plane; K2 as before."""
    import numpy as np

    from dhr_tpu_torch.retrieval import Searcher

    qv, qf, erows = queries
    cfg = dataclasses.replace(searcher.config, fused_candidates=True,
                              candidate_block=8)
    fused = Searcher(searcher.index, cfg)
    if not (fused._fused and fused._packed_ids):
        raise AssertionError("the fused path did not engage")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_passes = 6  # one warm-up, five timed
    reset_launches()
    qps, scores, rows = timed_passes(fused, qv, qf, n_passes - 1)
    launches = read_launches()
    n_batches = n_passes * -(-qv.shape[0] // cfg.query_batch)
    want = {"partial_gip": 0, "rerank_gip": n_batches,
            "gip_candidates": n_batches}
    emit({"phase": "kernels", "path": "fused", "launches": launches,
          "expected": want})
    if launches != want:
        raise AssertionError(f"fused path launches {launches}, expected "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_result(scores, rows, qv.shape[0], cfg.topk, fused.index.num_rows)
    agree = agreement(rows[:erows.shape[0]], erows)

    bs = cfg.query_batch
    qvb, qv1b, qib = fused.prepare_queries(qv[:bs], qf[:bs])
    red = fused.fused_stage1(qv1b, qib)
    _, cand = fused.select_fused(red)
    stage_ms = {
        "fused_kernel_k3": cuda_ms(lambda: fused.fused_stage1(qv1b, qib), 3,
                                   torch),
        "candidate_select_and_decode": cuda_ms(
            lambda: fused.select_fused(red), 3, torch),
        "rerank_k2_and_topk": cuda_ms(lambda: fused.stage2(qvb, qib, cand),
                                      3, torch),
    }
    emit({
        "phase": "fused_path", "rows": fused.index.num_rows,
        "candidate_block": cfg.candidate_block,
        "reduced_lanes": red.shape[1], "queries": int(qv.shape[0]),
        "query_batch": bs, "qps_median": float(np.median(qps)),
        "qps_passes": qps, "stage_ms_first_batch": stage_ms,
        "staged_vs_exact": agree, "agreement_queries": int(erows.shape[0]),
        "peak_mem_gb": peak,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=MSMARCO_PASSAGES,
                    help="corpus rows of the main path (default: the MS "
                         "MARCO passage count)")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
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

    name, smi = phase_device(torch)
    phase_build()
    phase_encode_path(args, torch)
    phase_train_path(args, torch)
    index, queries, raw = small_world(args.seed + 1, torch)
    errs = (phase_k1(index, queries, torch),
            phase_k2(index, queries, args.seed, torch),
            phase_k3(index, queries, torch))
    phase_search_vs_plain(index, raw, torch)
    phase_modes(index, raw, torch)
    del index, queries, raw
    torch.cuda.empty_cache()
    searcher, batch, launches, main_queries = phase_main(args, torch)
    launches["gip_candidates"] = phase_fused(searcher, main_queries,
                                             torch)["gip_candidates"]
    phase_modes_full(searcher, main_queries, torch)
    del main_queries
    kernels = phase_timing(searcher, batch, launches, errs, torch)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
