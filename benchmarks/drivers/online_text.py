"""Online search by text: one-query ``/search_text`` requests to the port's
``SearchService`` behind ``serve.py``'s HTTP handler, sent open loop at
Poisson arrivals by a load-generator process (``tools/loadgen.py``).

Set-up builds what ``serve --query-encoder --micro-batch-ms ...
--low-latency-batch 8`` builds: the index planes from the seed (the frozen
synth generator) in a ``DeviceIndex``, the main searcher at the operating
point and a small one on the same planes, the DHR query encoder (the
configuration's model, weights from the seed, through ``Encoder`` and
``make_query_encoder`` with the frozen hashing tokenizer), the service and
its threaded HTTP server on a local port.  It warms up the searchers at
each pool size and the encoder, then the generator sends a warm-up at the
cell's rate.  The window is the generator's measured schedule, every
request answered or given up a minute after the last was due.

``query_p95_ms``: the 95th percentile of the window's requests, each timed
from when it was due; a failed or refused request counts as slower than
every answered one.

Correctness: a sample of the window's requests, drawn from the seed, is
searched again by the reference (the f32 query tower on the same tokens,
exact GIP over every row):

- ``score_gap``: the largest distance between a returned score and the
  reference's score of the returned row, over the query's exact top-1
  score.

A share of rows missed is no number here: with random weights the CLS
scores of a query's best rows lie so close that bf16's encoding reorders
them (sound runs missed 0 to 9 of the reference's top 10).
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np


class Online:
    """The service under test, its server thread and the traffic."""

    def __init__(self, ctx):
        torch = ctx.torch
        dev = ctx.device
        from benchmarks.gen.synth import SynthConfig, synth_index_planes
        from benchmarks.gen.tokens import HashingTokenizer, rng, text_queries
        from benchmarks.gen.weights import make_weights
        from benchmarks.harness import import_program
        from benchmarks.port_model import port_bi_encoder, retriever_config

        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        idx, op, sv, m = cfg["index"], cfg["search"], cfg["serve"], \
            cfg["model"]
        torch.ones(1, device=dev)
        ctx.setup_part("cuda_start")

        scfg = SynthConfig(lex_dim=int(idx["lex_dim"]),
                           cls_dim=int(idx["cls_dim"]))
        self.planes = synth_index_planes(
            ctx.seed, int(idx["rows"]), scfg,
            chunk_rows=int(tr["chunk_rows"]), device=dev)[:3]
        ctx.setup_part("index_generation")

        retrieval = import_program("dhr_tpu_torch.retrieval")
        v_i8, folds, scales = self.planes
        index = retrieval.DeviceIndex.from_arrays(
            v_i8, folds, np.arange(int(idx["rows"])), int(idx["lex_dim"]),
            scales, device=dev)
        scfg_p = retrieval.SearchConfig(
            topk=int(op["topk"]), theta=float(op["theta"]),
            rerank=bool(op["rerank"]), agip_topk=int(op["pool"]),
            max_important_dims=int(op["max_important_dims"]),
            query_batch=int(op["query_batch"]))
        main = retrieval.Searcher(index, scfg_p, device=dev)
        import dataclasses

        small = retrieval.Searcher(index, dataclasses.replace(
            scfg_p, query_batch=int(sv["low_latency_batch"])), device=dev)
        ctx.setup_part("index_load")

        self.weights = make_weights(cfg, ctx.seed, dev)
        rcfg = retriever_config(cfg, sv["compute_dtype"])
        enc_mod = import_program("dhr_tpu_torch.encode")
        encoder = enc_mod.Encoder(
            port_bi_encoder(cfg, self.weights, rcfg, dev), rcfg,
            enc_mod.EncodeConfig(batch_size=int(op["query_batch"]),
                                 remove_dims=int(cfg["head"]["remove_dims"])),
            device=dev)
        self.tokenizer = HashingTokenizer(vocab=m["vocab_size"])
        qenc = enc_mod.make_query_encoder(
            encoder, self.tokenizer, int(sv["q_max_len"]),
            m["cls_token_id"], m["sep_token_id"])
        ctx.setup_part("model_load")

        serve = import_program("dhr_tpu_torch.serve")
        self.service = serve.SearchService(
            main, micro_batch_ms=float(sv["micro_batch_ms"]),
            small_searcher=small, query_encoder=qenc,
            max_pending=int(sv["max_pending"]))
        self.server = serve._ThreadingServer(("127.0.0.1", 0),
                                             serve.make_handler(self.service))
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        ctx.setup_part("server_start")

        self.texts = text_queries(tr["query_words"], int(tr["texts"]),
                                  rng(ctx.seed, 0x7E47))
        qv = torch.rand(128, v_i8.shape[1], device=dev)
        qf = torch.zeros(128, int(idx["lex_dim"]), dtype=torch.int32,
                         device=dev)
        for n in range(1, small.config.query_batch + 1):
            small.search(qv[:n], qf[:n])
        for n in (small.config.query_batch + 1, 16, 32, 64, 128):
            main.search(qv[:n], qf[:n])
        qenc(self.texts[:1])
        del main, small, index, encoder
        ctx.setup_part("warmup")

    def start(self, rate: float, seconds: float, seed: int, checked=(),
              warmup_s: float = 0.0) -> subprocess.Popen:
        """Start the load generator and let it run its warm-up at
        ``rate``; it then waits for :meth:`finish`."""
        plan = {"port": self.port, "rate": rate, "seconds": seconds,
                "seed": seed, "texts": self.texts, "checked": list(checked),
                "warmup_s": warmup_s, "drain_s": 60}
        gen = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve().parents[1]
                                 / "tools" / "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        gen.stdin.write(json.dumps(plan) + "\n")
        gen.stdin.flush()
        if gen.stdout.readline().strip() != "READY":
            gen.kill()
            gen.wait()
            raise RuntimeError("the load generator did not start")
        return gen

    @staticmethod
    def finish(gen: subprocess.Popen) -> dict:
        """Run the generator's measured schedule; its report."""
        try:
            gen.stdin.write("go\n")
            gen.stdin.flush()
            return json.loads(gen.stdout.readline())
        finally:
            gen.stdin.close()
            gen.wait(timeout=120)

    def drive(self, rate: float, seconds: float, seed: int,
              warmup_s: float = 0.0) -> dict:
        return self.finish(self.start(rate, seconds, seed, (), warmup_s))

    def batcher_counts(self) -> tuple[int, int]:
        b = self.service.batcher
        return b.batches_run, b.queries_run

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)
        self.service.close()
        self.service = self.server = None


def latencies_ms(report: dict) -> list[float]:
    """Each request's latency from when it was due; a request that failed
    or never came reads infinite."""
    return [(done - due) * 1e3 if status == 200 and done is not None
            else math.inf for due, _sent, done, status in report["requests"]]


def p95(values: list[float]) -> float:
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def checked_requests(ctx, n_due: int) -> list[int]:
    from benchmarks.gen.tokens import rng

    k = min(int(ctx.traffic["checked_requests"]), n_due)
    return sorted(int(i) for i in rng(ctx.seed, 0xC8EC).choice(
        n_due, size=k, replace=False))


def window_schedule(ctx) -> list[float]:
    from benchmarks.tools.loadgen import schedule

    return schedule(float(ctx.traffic["rate_per_s"]), ctx.seconds, ctx.seed)


def run(ctx):
    on = Online(ctx)
    tr = ctx.traffic
    checked = checked_requests(ctx, len(window_schedule(ctx)))
    gen = on.start(float(tr["rate_per_s"]), ctx.seconds, ctx.seed, checked,
                   float(tr["warmup_s"]))
    b0 = on.batcher_counts()
    with ctx.window():
        report = on.finish(gen)
    b1 = on.batcher_counts()
    seeds = itertools.count(ctx.seed + 1)
    ctx.traced(lambda s: len(on.drive(float(tr["rate_per_s"]), s,
                                      next(seeds))["requests"]))
    ctx.read_peak()
    on.close()
    lat = latencies_ms(report)
    failed = sum(1 for x in lat if math.isinf(x))
    late = [sent - due for due, sent, _d, _s in report["requests"]
            if sent is not None]
    ctx.work["batch_queries"] = (b1[1] - b0[1]) / max(b1[0] - b0[0], 1)
    print(f"# generator late_ms_max {max(late, default=0.0) * 1e3!r}",
          file=ctx.out)
    ctx.free()

    hits = {int(k): v for k, v in report["hits"].items()}
    check_hits(ctx, on.weights, on.planes, on.texts, hits)
    return {"e2e": {"query_p95_ms": p95(lat)}, "attempted": len(lat),
            "failed": failed}


def reference_queries(ctx, weights, tokenizer_texts, precision="f32"):
    """The reference's query reps ``(qv (n, lex + proj), qf (n, lex))`` of
    texts, tokenized by the frozen hashing tokenizer."""
    torch = ctx.torch
    from benchmarks.drivers.encode_corpus import reference_planes
    from benchmarks.gen.tokens import HashingTokenizer
    from benchmarks.gen.weights import model_dims
    from benchmarks.reference.dhr_model import densify

    cfg = ctx.config
    tok = HashingTokenizer(vocab=cfg["model"]["vocab_size"])
    q_max = int(cfg["serve"]["q_max_len"])
    toks = [tok.encode(t, max_length=q_max - 2, truncation=True)
            for t in tokenizer_texts]
    lexical, semantic = reference_planes(ctx, weights, model_dims(cfg),
                                         toks, precision)
    vals, folds = densify(lexical, cfg["head"]["dlr_out_dim"],
                          cfg["head"]["remove_dims"])
    return torch.cat([vals, semantic], dim=1), folds.int()


def check_hits(ctx, weights, planes, texts, hits: dict,
               precision: str = "f32") -> None:
    """Compare each kept response with the exact search of the
    reference's query reps."""
    torch = ctx.torch
    from benchmarks.reference import no_tf32
    from benchmarks.reference.gip import gip_all_rows, topk_rows

    no_tf32()
    if not hits:
        ctx.compare("score_gap", math.inf)
        return
    order = sorted(hits)
    qv, qf = reference_queries(ctx, weights,
                               [texts[i % len(texts)] for i in order],
                               precision)
    v_i8, folds, scales = planes
    lex = int(ctx.config["index"]["lex_dim"])
    exact = gip_all_rows(qv, qf, v_i8, folds, scales, lex)
    top, _ = topk_rows(exact, 1)
    scale = top[:, 0].abs().clamp(min=1e-30)
    gap = 0.0
    for j, i in enumerate(order):
        rows = torch.as_tensor([int(r) for r in hits[i]["rows"]],
                               device=exact.device)
        scores = torch.as_tensor(hits[i]["scores"], device=exact.device)
        if rows.numel() != int(ctx.config["search"]["topk"]) \
                or (rows < 0).any() or (rows >= exact.shape[1]).any():
            gap = math.inf
            break
        gap = max(gap, float((scores - exact[j, rows]).abs().max()
                             / scale[j]))
    ctx.compare("score_gap", gap)


def control(ctx) -> None:
    """The control: the reference's query tower computed with fp8
    products, one step below the configuration's bf16, and an exact
    search, put in the program's place."""
    from benchmarks.gen.synth import SynthConfig, synth_index_planes
    from benchmarks.gen.tokens import rng, text_queries
    from benchmarks.gen.weights import make_weights
    from benchmarks.reference.gip import gip_all_rows, topk_rows

    cfg, tr = ctx.config, ctx.traffic
    idx = cfg["index"]
    planes = synth_index_planes(
        ctx.seed, int(idx["rows"]),
        SynthConfig(lex_dim=int(idx["lex_dim"]), cls_dim=int(idx["cls_dim"])),
        chunk_rows=int(tr["chunk_rows"]), device=ctx.device)[:3]
    weights = make_weights(cfg, ctx.seed, ctx.device)
    texts = text_queries(tr["query_words"], int(tr["texts"]),
                         rng(ctx.seed, 0x7E47))
    order = checked_requests(ctx, len(window_schedule(ctx)))
    qv, qf = reference_queries(ctx, weights,
                               [texts[i % len(texts)] for i in order], "fp8")
    exact = gip_all_rows(qv, qf, *planes, int(idx["lex_dim"]))
    vals, rows = topk_rows(exact, int(cfg["search"]["topk"]))
    hits = {i: {"rows": rows[j].tolist(), "scores": vals[j].tolist()}
            for j, i in enumerate(order)}
    del exact
    ctx.free()
    check_hits(ctx, weights, planes, texts, hits)
